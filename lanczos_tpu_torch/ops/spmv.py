"""BSR sparse matvec: kernels K1 and K2 and their plain version (port of
``lanczos_tpu/ops/pallas_spmv.py``).

Layouts (see :class:`lanczos_tpu_torch.ops.operators.BSROperator`):
  blocks      "rsmk" (R, S, bm, bk) canonical; "rmsk" (R, bm, S, bk), the
              pre-transposed storage K1 reads (one contiguous (bm, S*bk)
              slab per row block).  Padding tiles are all-zero.
  col_blocks  (R, S) int32, block-column of each tile (padding -> 0).
  x           (n_pad,), n_pad = R * bm = C * bk.

:func:`bsr_matvec` (K1, ``rmsk``) and :func:`bsr_matvec_rsmk` (K2, ``rsmk``,
the local SpMV of :class:`~lanczos_tpu_torch.parallel.sharded.ShardedBSROperator`)
run the hand-written CUDA kernels of ``csrc/bsr_spmv.cu`` on CUDA tensors
and :func:`bsr_matvec_reference` on CPU tensors.  The Pallas kernel's VMEM
budget (``VMEM_BUDGET``, ``pallas_t_fits``) has no counterpart: K1 and K2
gather x into shared memory in pieces (:func:`plan`), so every operator that
packs runs on the card.

Given float32 tiles and a float64 ``x``, both wrappers compute the product in
float64 (the precise paths' ``matvec_f64``): kernel K1x,
:func:`bsr_matvec_f32x64` and :func:`bsr_matvec_rsmk_f32x64`, on CUDA
tensors, each with its own launch count; the plain version accumulates in
float64 on the CPU.  The tiles are read as they are stored: no float64 copy
of them is made.

Complex tiles (complex Hermitian operators, natively: no real embedding)
take K1's complex64 and complex128 instances, :func:`bsr_matvec` with its
launches counted by dtype in ``bsr_matvec.launches_by_dtype``; complex64
tiles against a complex128 ``x`` take K1x's complex instance,
:func:`bsr_matvec_c64x128`.  The rsmk form (K2) has the same instances for
complex row-partitioned operators: :func:`bsr_matvec_rsmk` counts its
launches by dtype in ``bsr_matvec_rsmk.launches_by_dtype``, and complex64
tiles against a complex128 table go to :func:`bsr_matvec_rsmk_c64x128`.

bfloat16 tiles (the JAX package's ``BSROperator(dtype=bfloat16)``: half the
tile stream, float32 accumulation) are a storage type only: no engine builds
a bfloat16 vector.  K1 and K2 take them against a float32 ``x`` (their
bfloat16 instances, counted under ``torch.bfloat16`` in
``launches_by_dtype``), and K1x against a float64 ``x``
(:func:`bsr_matvec_bf16x64`, :func:`bsr_matvec_rsmk_bf16x64`); a bfloat16
``x`` raises on CUDA.  Those two run a body of their own, which holds a
chunk of x in registers across the block row (:func:`bf16x64_plan`).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from .. import _build

__all__ = [
    "bsr_matvec",
    "bsr_matvec_rsmk",
    "bsr_matvec_f32x64",
    "bsr_matvec_c64x128",
    "bsr_matvec_rsmk_f32x64",
    "bsr_matvec_rsmk_c64x128",
    "bsr_matvec_bf16x64",
    "bsr_matvec_rsmk_bf16x64",
    "bsr_matvec_reference",
    "plan",
    "bf16x64_plan",
]

# ROADMAP.md names the work that would lift each refusal below.
_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K1 for complex and bfloat16 tiles"
_RSMK_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K2 for complex and bfloat16 tiles"


def bsr_matvec_reference(blocks, col_blocks, x, layout: str = "rsmk"):
    """Plain PyTorch BSR matvec for either layout, any dtype.

    Accumulates in the wider of the tiles' and ``x``'s dtypes, at least
    float32 (bfloat16 tiles widen, as ``preferred_element_type`` does in the
    JAX package; float32 tiles against a float64 ``x`` accumulate in
    float64), and returns ``x.dtype``.  ``x`` has the padded length R*bm.
    """
    if layout not in ("rmsk", "rsmk"):
        raise ValueError(f"layout must be 'rmsk' or 'rsmk', got {layout!r}")
    bk = blocks.shape[3]
    xg = x.reshape(-1, bk)[col_blocks.long()]  # (R, S, bk) gather of needed segments
    acc = torch.promote_types(torch.promote_types(blocks.dtype, x.dtype), torch.float32)
    if layout == "rmsk":
        y = torch.einsum("rmsk,rsk->rm", blocks.to(acc), xg.to(acc))
    else:
        # one (bm, bk) tile product per (r, s), summed over s: einsum would
        # copy the tiles into (r, m, s k) order on every call
        y = torch.matmul(blocks.to(acc), xg.to(acc).unsqueeze(-1)).squeeze(-1).sum(dim=1)
    return y.reshape(-1).to(x.dtype)


def bsr_matvec(blocks, col_blocks, x, n_out: int | None = None):
    """K1: y = A x for ``rmsk`` tiles; returns the first ``n_out`` rows
    (default R*bm).

    ``x`` may be shorter than R*bm (the unpadded vector): entries past its
    end read as zero, as the JAX package's zero padding does.  On CUDA
    tensors this launches ``csrc/bsr_spmv.cu`` (float32, float64, complex64
    or complex128 tiles against an ``x`` of their dtype, bfloat16 tiles
    against a float32 ``x``; a bfloat16 ``x`` raises) and counts the launch
    in ``bsr_matvec.launches`` and, by tile dtype, in
    ``bsr_matvec.launches_by_dtype``; float32 (complex64, bfloat16) tiles
    against a float64 (complex128, float64) ``x`` go to K1x.  On CPU tensors
    it runs :func:`bsr_matvec_reference`.
    """
    r, bm, s, bk = blocks.shape
    n_pad = r * bm
    n_out = n_pad if n_out is None else int(n_out)
    if x.ndim != 1 or x.shape[0] > n_pad or not 0 <= n_out <= n_pad:
        raise ValueError(f"x of shape {tuple(x.shape)} / n_out={n_out} do not fit {n_pad} padded rows")
    if x.device.type == "cpu":
        xp = F.pad(x, (0, n_pad - x.shape[0])) if x.shape[0] != n_pad else x
        return bsr_matvec_reference(blocks, col_blocks, xp, layout="rmsk")[:n_out]
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matvec runs on CPU or CUDA tensors, got {x.device}")
    if blocks.dtype not in _K1_ENTRY or x.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"K1 takes float32/float64/complex64/complex128 tiles and bfloat16 tiles against a float32 or float64 "
            f"x on CUDA, got {blocks.dtype} tiles and a {x.dtype} x; see {_DTYPE_ITEM}")
    if (blocks.dtype, x.dtype) in _WIDENING:
        return _WIDENING[blocks.dtype, x.dtype](blocks, col_blocks, x, n_out)
    _check_cuda_args(blocks, col_blocks, x, (r, s), "bsr_matvec")
    fn = getattr(_build.library(), _K1_ENTRY[blocks.dtype])
    y = _launch(fn, blocks, col_blocks, x, n_out, (r, bm, s, bk), "bsr_matvec (K1)")
    bsr_matvec.launches += 1
    _K1_BY_DTYPE[blocks.dtype] += 1
    return y


_K1_BY_DTYPE = collections.Counter()  # shared with the attribute below, as ops/cgs.py's
bsr_matvec.launches = 0
bsr_matvec.launches_by_dtype = _K1_BY_DTYPE

# K1's entry point in csrc/bsr_spmv.cu by tile dtype (x of _X_DTYPE's dtype).
_K1_ENTRY = {
    torch.float32: "lt_bsr_spmv_f32",
    torch.float64: "lt_bsr_spmv_f64",
    torch.complex64: "lt_bsr_spmv_c64",
    torch.complex128: "lt_bsr_spmv_c128",
    torch.bfloat16: "lt_bsr_spmv_bf16",
}
# The x dtype of K1's and K2's entries: the tiles' own, float32 for the
# storage-only bfloat16.
_X_DTYPE = {torch.bfloat16: torch.float32}
# (tile dtype, x dtype) pairs of K1x: the precise paths' wider product.
_WIDE_X = {(torch.float32, torch.float64), (torch.complex64, torch.complex128), (torch.bfloat16, torch.float64)}


def _check_cuda_args(blocks, col_blocks, x, cb_shape, what: str) -> None:
    """The CUDA launch's conditions on its arguments, for K1, K2 and K1x."""
    if x.dtype != _X_DTYPE.get(blocks.dtype, blocks.dtype) and (blocks.dtype, x.dtype) not in _WIDE_X:
        raise TypeError(f"x dtype {x.dtype} differs from the tile dtype {blocks.dtype}")
    if col_blocks.dtype != torch.int32 or col_blocks.shape != cb_shape:
        raise TypeError(f"col_blocks must be int32 of shape {cb_shape}, got {col_blocks.dtype} {tuple(col_blocks.shape)}")
    if not (blocks.device == col_blocks.device == x.device):
        raise ValueError("blocks, col_blocks and x must be on one device")
    if not (blocks.is_contiguous() and col_blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")


def _launch(fn, blocks, col_blocks, x, n_out: int, dims, what: str):
    """One launch of a ``csrc/bsr_spmv.cu`` entry point on x's stream."""
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(blocks.data_ptr(), col_blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
             *dims, x.shape[0], n_out, x.device.index, stream)
    _build.check(err, what)
    return y


def _k1x(counter, entry: str, tiles, xtype, blocks, col_blocks, x, n_out):
    """One K1x call (``tiles`` rmsk tiles against an ``xtype`` x, the
    accumulation in ``xtype``): the plain version on CPU tensors, else the
    ``entry`` launch, counted on ``counter``."""
    what = counter.__name__
    r, bm, s, bk = blocks.shape
    n_pad = r * bm
    n_out = n_pad if n_out is None else int(n_out)
    if x.ndim != 1 or x.shape[0] > n_pad or not 0 <= n_out <= n_pad:
        raise ValueError(f"x of shape {tuple(x.shape)} / n_out={n_out} do not fit {n_pad} padded rows")
    if blocks.dtype != tiles or x.dtype != xtype:
        raise TypeError(f"{what} takes {tiles} tiles and a {xtype} x, got {blocks.dtype} and {x.dtype}")
    if x.device.type == "cpu":
        xp = F.pad(x, (0, n_pad - x.shape[0])) if x.shape[0] != n_pad else x
        return bsr_matvec_reference(blocks, col_blocks, xp, layout="rmsk")[:n_out]
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {x.device}")
    _check_cuda_args(blocks, col_blocks, x, (r, s), what)
    y = _launch(getattr(_build.library(), entry), blocks, col_blocks, x, n_out, (r, bm, s, bk), f"{what} (K1x)")
    counter.launches += 1
    return y


def bsr_matvec_f32x64(blocks, col_blocks, x, n_out: int | None = None):
    """K1x: y = A x in float64 for float32 ``rmsk`` tiles and a float64
    ``x`` (the precise paths' product); the arguments of :func:`bsr_matvec`,
    which routes such calls here.  Counts its launches in
    ``bsr_matvec_f32x64.launches``; CPU tensors take the plain version."""
    return _k1x(bsr_matvec_f32x64, "lt_bsr_spmv_f32x64", torch.float32, torch.float64, blocks, col_blocks, x, n_out)


bsr_matvec_f32x64.launches = 0


def bsr_matvec_c64x128(blocks, col_blocks, x, n_out: int | None = None):
    """K1x's complex instance: y = A x in complex128 for complex64 ``rmsk``
    tiles and a complex128 ``x`` (the precise product of a complex64
    operator, ``float64_view(op).matvec``); the arguments of
    :func:`bsr_matvec`, which routes such calls here.  Counts its launches
    in ``bsr_matvec_c64x128.launches``; CPU tensors take the plain
    version."""
    return _k1x(bsr_matvec_c64x128, "lt_bsr_spmv_c64x128", torch.complex64, torch.complex128, blocks, col_blocks, x,
                n_out)


bsr_matvec_c64x128.launches = 0


def bsr_matvec_bf16x64(blocks, col_blocks, x, n_out: int | None = None):
    """K1x's bfloat16 instance: y = A x in float64 for bfloat16 ``rmsk``
    tiles and a float64 ``x`` (the precise product of a bfloat16 operator,
    ``float64_view(op).matvec``; each tile value widens exactly); the
    arguments of :func:`bsr_matvec`, which routes such calls here.  Counts
    its launches in ``bsr_matvec_bf16x64.launches``; CPU tensors take the
    plain version."""
    return _k1x(bsr_matvec_bf16x64, "lt_bsr_spmv_bf16x64", torch.bfloat16, torch.float64, blocks, col_blocks, x,
                n_out)


bsr_matvec_bf16x64.launches = 0

_WIDENING = {(torch.float32, torch.float64): bsr_matvec_f32x64, (torch.complex64, torch.complex128): bsr_matvec_c64x128,
             (torch.bfloat16, torch.float64): bsr_matvec_bf16x64}


def bsr_matvec_rsmk(blocks, col_blocks, x, n_out: int | None = None, *, col_bound: int | None = None):
    """K2: y = A x for canonical ``rsmk`` tiles (R, S, bm, bk); returns the
    first ``n_out`` rows (default R*bm).

    ``x`` is a table of C rows of width bk, flat (C*bk,) or (C, bk), that
    ``col_blocks`` indexes: the whole vector, a neighbour's slab or a
    footprint payload, so C is not tied to R*bm/bk.  Every entry of
    ``col_blocks`` must be below C; ``col_bound`` is one more than its
    largest entry when the caller knows it (the sharded operators compute it
    when they pack), else it is read from ``col_blocks``, which waits for the
    device.  On CUDA tensors this launches ``csrc/bsr_spmv.cu`` in its
    ``rsmk`` form (float32, float64, complex64 or complex128 tiles against
    a table of their dtype, bfloat16 tiles against a float32 table; a
    bfloat16 table raises) and counts the launch in
    ``bsr_matvec_rsmk.launches`` and, by tile dtype, in
    ``bsr_matvec_rsmk.launches_by_dtype``; float32 (complex64, bfloat16)
    tiles against a float64 (complex128, float64) table go to K1x-rsmk,
    counted by :func:`bsr_matvec_rsmk_f32x64` (:func:`bsr_matvec_rsmk_c64x128`,
    :func:`bsr_matvec_rsmk_bf16x64`).
    On CPU tensors it runs :func:`bsr_matvec_reference`.
    """
    if blocks.ndim != 4:
        raise ValueError(f"blocks of shape {tuple(blocks.shape)} are not (R, S, bm, bk) tiles")
    r, s, bm, bk = blocks.shape
    n_out = r * bm if n_out is None else int(n_out)
    x = x.reshape(-1)
    if x.shape[0] % bk or not 0 <= n_out <= r * bm:
        raise ValueError(f"x of {x.shape[0]} values / n_out={n_out} do not fit rows of {bk} and {r * bm} outputs")
    if col_blocks.shape != (r, s):
        raise ValueError(f"col_blocks of shape {tuple(col_blocks.shape)} is not {(r, s)}")
    c_rows = x.shape[0] // bk
    if col_bound is None:
        col_bound = int(col_blocks.max()) + 1 if col_blocks.numel() else 0
    if col_bound > c_rows:
        raise ValueError(f"col_blocks index up to row {col_bound - 1} of an x table of {c_rows} rows")
    if x.device.type == "cpu":
        return bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")[:n_out]
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matvec_rsmk runs on CPU or CUDA tensors, got {x.device}")
    if blocks.dtype not in _K2_ENTRY or x.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"K2 takes float32/float64/complex64/complex128 tiles and bfloat16 tiles against a float32 or float64 "
            f"table on CUDA, got {blocks.dtype} tiles and a {x.dtype} table; see {_RSMK_DTYPE_ITEM}")
    _check_cuda_args(blocks, col_blocks, x, (r, s), "bsr_matvec_rsmk")
    lib = _build.library()
    if (blocks.dtype, x.dtype) in _WIDE_X:
        counter = _K2X_COUNTER[blocks.dtype]
        y = _launch(getattr(lib, _K2X_ENTRY[blocks.dtype]), blocks, col_blocks, x, n_out, (r, bm, s, bk),
                    f"{counter.__name__} (K1x, rsmk)")
        counter.launches += 1
        return y
    y = _launch(getattr(lib, _K2_ENTRY[blocks.dtype]), blocks, col_blocks, x, n_out, (r, bm, s, bk),
                "bsr_matvec_rsmk (K2)")
    bsr_matvec_rsmk.launches += 1
    _K2_BY_DTYPE[blocks.dtype] += 1
    return y


_K2_BY_DTYPE = collections.Counter()
bsr_matvec_rsmk.launches = 0
bsr_matvec_rsmk.launches_by_dtype = _K2_BY_DTYPE
# K2's entry point by tile dtype (x of the same dtype), and K1x-rsmk's by
# tile dtype (the wider x).
_K2_ENTRY = {
    torch.float32: "lt_bsr_spmv_rsmk_f32",
    torch.float64: "lt_bsr_spmv_rsmk_f64",
    torch.complex64: "lt_bsr_spmv_rsmk_c64",
    torch.complex128: "lt_bsr_spmv_rsmk_c128",
    torch.bfloat16: "lt_bsr_spmv_rsmk_bf16",
}
_K2X_ENTRY = {torch.float32: "lt_bsr_spmv_rsmk_f32x64", torch.complex64: "lt_bsr_spmv_rsmk_c64x128",
              torch.bfloat16: "lt_bsr_spmv_rsmk_bf16x64"}


def bsr_matvec_rsmk_f32x64(blocks, col_blocks, x, n_out: int | None = None, *, col_bound: int | None = None):
    """K1x's ``rsmk`` form (K2's body with float32 tiles and a float64
    ``x``), for the sharded operators' precise product: the arguments of
    :func:`bsr_matvec_rsmk`, which routes such calls here and counts them in
    ``bsr_matvec_rsmk_f32x64.launches``."""
    if blocks.dtype != torch.float32 or x.dtype != torch.float64:
        raise TypeError(f"K1x takes float32 tiles and a float64 x, got {blocks.dtype} and {x.dtype}")
    return bsr_matvec_rsmk(blocks, col_blocks, x, n_out, col_bound=col_bound)


bsr_matvec_rsmk_f32x64.launches = 0


def bsr_matvec_rsmk_c64x128(blocks, col_blocks, x, n_out: int | None = None, *, col_bound: int | None = None):
    """K1x-rsmk's complex instance (K2's body with complex64 tiles and a
    complex128 ``x``), the precise product of a complex sharded operator:
    the arguments of :func:`bsr_matvec_rsmk`, which routes such calls here
    and counts them in ``bsr_matvec_rsmk_c64x128.launches``."""
    if blocks.dtype != torch.complex64 or x.dtype != torch.complex128:
        raise TypeError(f"K1x takes complex64 tiles and a complex128 x, got {blocks.dtype} and {x.dtype}")
    return bsr_matvec_rsmk(blocks, col_blocks, x, n_out, col_bound=col_bound)


bsr_matvec_rsmk_c64x128.launches = 0


def bsr_matvec_rsmk_bf16x64(blocks, col_blocks, x, n_out: int | None = None, *, col_bound: int | None = None):
    """K1x-rsmk's bfloat16 instance (K2's body with bfloat16 tiles and a
    float64 ``x``), the precise product of a bfloat16 sharded operator: the
    arguments of :func:`bsr_matvec_rsmk`, which routes such calls here and
    counts them in ``bsr_matvec_rsmk_bf16x64.launches``."""
    if blocks.dtype != torch.bfloat16 or x.dtype != torch.float64:
        raise TypeError(f"K1x takes bfloat16 tiles and a float64 x, got {blocks.dtype} and {x.dtype}")
    return bsr_matvec_rsmk(blocks, col_blocks, x, n_out, col_bound=col_bound)


bsr_matvec_rsmk_bf16x64.launches = 0
# K1x-rsmk's counter by tile dtype.
_K2X_COUNTER = {torch.float32: bsr_matvec_rsmk_f32x64, torch.complex64: bsr_matvec_rsmk_c64x128,
                torch.bfloat16: bsr_matvec_rsmk_bf16x64}

# csrc/bsr_spmv.cu's launch constants.
X_PIECE_BYTES = 32 * 1024
DEFAULT_SMEM_BYTES = 48 * 1024
MAX_SMEM_BYTES = 227 * 1024


def plan(bm: int, s: int, bk: int, x_itemsize: int) -> dict:
    """The launch plan ``csrc/bsr_spmv.cu`` makes for K1, K2 and K1x: the
    tiles per gathered x piece (``s_piece``, those that fit 32 KB of x
    values, at least one), the dynamic shared bytes (row accumulators in
    x's type, then one piece) and whether they pass the default 48 KB, so
    that the kernel opts in to more (``opt_in``).  float64 (complex64) x
    halves the piece of float32's, complex128 x quarters it."""
    acc = -(-bm * x_itemsize // 16) * 16
    s_piece = min(max(X_PIECE_BYTES // (bk * x_itemsize), 1), s)
    smem = acc + s_piece * bk * x_itemsize
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"bm={bm}, bk={bk} need {smem} bytes of shared memory, past the {MAX_SMEM_BYTES} an SM offers")
    return {"s_piece": s_piece, "smem": smem, "opt_in": smem > DEFAULT_SMEM_BYTES}


# csrc/bsr_spmv.cu's bfloat16 x float64 body: threads a CTA, x vectors a lane.
THREADS = 256
MAX_VECTORS_PER_LANE = 4


def bf16x64_plan(bm: int, s: int, bk: int) -> dict:
    """The launch plan of K1x and K1x-rsmk over bfloat16 tiles: :func:`plan`
    with a float64 x, and the lanes a row (``lanes_per_row``, a power of two)
    and 16-byte tile vectors a lane (``vectors_per_lane``) whose x the lane
    holds in registers across the block row.  Among 1..32 lanes and
    1..``MAX_VECTORS_PER_LANE`` vectors it takes the fewest vector slots a
    lane walks (row steps x chunks x vectors, a chunk being lanes x vectors
    of a piece's ``s_piece * bk / 8`` vectors), then the fewest chunks, then
    the fewest vectors, then the most lanes.  ``bk % 8 != 0`` runs the
    shared template's scalar loop: lanes and vectors 0."""
    p = plan(bm, s, bk, 8)
    if bk % 8:
        return {**p, "lanes_per_row": 0, "vectors_per_lane": 0}
    nv = p["s_piece"] * bk // 8
    best = None
    for lg in range(5, -1, -1):
        lanes = 1 << lg
        steps = -(-bm // (THREADS // lanes))
        for vpl in range(1, MAX_VECTORS_PER_LANE + 1):
            chunks = -(-nv // (lanes * vpl))
            key = (steps * chunks * vpl, chunks, vpl)
            if best is None or key < best[0]:
                best = (key, lanes, vpl)
    return {**p, "lanes_per_row": best[1], "vectors_per_lane": best[2]}
