"""Classical Gram-Schmidt passes over the live Krylov rows: kernels K3
(one vector) and K4 (a block of vectors) and their plain versions (port of
``lanczos_tpu/ops/pallas_cgs.py`` ``cgs_pass`` and ``cgs_pass_block``).

One pass is classical GS over rows [0, k): every coefficient is measured
against the incoming vector, v <- v - B[:k]^T (B[:k] v) — the semantics of
the Pallas kernels (pallas_cgs.py:32-38) and of the JAX package's CPU path.
The block pass does the same for each row of a (b, n) block, reading the
basis once for all b rows.  A complex basis conjugates the coefficients,
v <- v - B[:k]^T (conj(B[:k]) v): K3 and K4 have complex64 and complex128
instances for the complex Hermitian solves.

Over rows split across ranks (a row-partitioned operator's slabs) each
rank's coefficients are partial sums.  Every pass then takes ``reduce``, a
function that sums the coefficients over the ranks in place (an
all-reduce): the kernel runs its projection and reduction into the
coefficients, returns, and runs its update from the summed coefficients,
so the kernels run at every world size.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

__all__ = [
    "BlockPlan",
    "block_plan",
    "l2_keep_rows",
    "kept_rows",
    "cgs_pass",
    "cgs_pass_reference",
    "cgs_pass_block",
    "cgs_pass_block_reference",
]

_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K3 for complex and bfloat16 bases"
_BLOCK_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K4 for complex and bfloat16 bases"
# K3's n-tile (csrc/cgs.cu): 256 threads of two 16-byte vectors each
# (2048 float32, 1024 float64 or complex64, 512 complex128 values).
TILE_BYTES = 256 * 2 * 16
# K3's entry point in csrc/cgs.cu and the basis-type code of
# lt_cgs_project_occupancy, by basis dtype.
_K3_ENTRY = {
    torch.float32: ("lt_cgs_pass_f32", 0),
    torch.float64: ("lt_cgs_pass_f64", 1),
    torch.complex64: ("lt_cgs_pass_c64", 2),
    torch.complex128: ("lt_cgs_pass_c128", 3),
}
# The share of the card's L2 that the rows the projection reads last may
# hold for the update (l2_keep_rows).
L2_KEEP_FRACTION = 0.6
MAX_BLOCK = 16  # widest block K4 takes
# K4's launch shape (csrc/cgs_block.cu): 256 consumer threads and one
# producer warp per CTA, two CTAs resident per SM.
BLOCK_CONSUMERS = 256
BLOCK_CTAS_PER_SM = 2
BLOCK_MIN_STAGES, BLOCK_MAX_STAGES = 2, 8
BLOCK_RING_BYTES = 32 * 1024  # basis bytes a CTA's ring holds (stages * cols * itemsize), at most
# K4's entry point in csrc/cgs_block.cu and the basis-type code of
# lt_cgs_block_info, by basis dtype.
_K4_ENTRY = {
    torch.float32: ("lt_cgs_block_pass_f32", 0),
    torch.float64: ("lt_cgs_block_pass_f64", 1),
    torch.complex64: ("lt_cgs_block_pass_c64", 2),
    torch.complex128: ("lt_cgs_block_pass_c128", 3),
}


# Which of a pass's launches to run (csrc/cgs.cu, csrc/cgs_block.cu):
# the projection and its reduction into the coefficients, the update from
# them, or both.
_PROJECT, _UPDATE, _WHOLE = 1, 2, 3


def cgs_pass_reference(v, basis, k: int, reduce=None):
    """Plain PyTorch pass: ``v - B[:k]^T (B[:k] v)`` (conjugated
    coefficients for complex bases), with ``reduce`` applied to the
    coefficients first when given; returns a new tensor."""
    if k <= 0:
        return v
    rows = basis[:k]
    c = rows.conj() @ v if rows.is_complex() else rows @ v
    if reduce is not None:
        c = reduce(c)
    return v - c @ rows


def l2_keep_rows(n: int, itemsize: int, l2_bytes: int, resident_ctas: int) -> int:
    """How many live rows K3's projection leaves in L2 for the update (rows
    0, 1, ..., which it reads last and the update first), for an
    (n,)-wide basis of ``itemsize``-byte values, an L2 of ``l2_bytes`` and
    ``resident_ctas`` projection CTAs on the card at once.

    The projection's CTAs, one n-tile of :data:`TILE_BYTES` each, walk the
    rows a wave of resident CTAs at a time, so what L2 can hold at its end
    is those rows of one wave's tiles: as many rows of ``min(tiles,
    resident_ctas)`` tiles as fit :data:`L2_KEEP_FRACTION` of L2."""
    tiles = -(-n // (TILE_BYTES // itemsize))
    return int(L2_KEEP_FRACTION * l2_bytes) // (min(tiles, resident_ctas) * TILE_BYTES)


# Per CUDA device index: K3's foreign function and the rows it keeps in L2
# (a function of n) by dtype, resolved at the first call on the device (the
# library is built then, never at import).
_K3_LAUNCH: dict = {}


def _k3_entry(index: int) -> dict:
    entry = _K3_LAUNCH.get(index)
    if entry is None:
        lib = _build.library()
        props = torch.cuda.get_device_properties(index)
        per_sm = ctypes.c_int(0)
        entry = {}
        for dtype, (name, code) in _K3_ENTRY.items():
            _build.check(lib.lt_cgs_project_occupancy(code, index, ctypes.byref(per_sm)), "cgs_pass (K3) occupancy")
            itemsize = torch.empty((), dtype=dtype).element_size()
            entry[dtype] = (getattr(lib, name), functools.partial(
                l2_keep_rows, itemsize=itemsize, l2_bytes=props.L2_cache_size,
                resident_ctas=per_sm.value * props.multi_processor_count))
        _K3_LAUNCH[index] = entry
    return entry


def kept_rows(n: int, dtype, device) -> int:
    """The :func:`l2_keep_rows` K3 uses for an (n,)-wide basis of ``dtype``
    on the CUDA ``device``."""
    device = torch.device(device)
    return _k3_entry(torch.cuda.current_device() if device.index is None else device.index)[dtype][1](n)


def cgs_pass(v, basis, k: int, reduce=None):
    """K3: one classical GS pass of ``v`` against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/cgs.cu`` (float32, float64,
    complex64 or complex128, the complex ones with conjugated coefficients;
    bfloat16 raises), overwrites ``v`` with the result and returns it — the
    JAX kernel aliases ``v`` to its output the same way (pallas_cgs.py:226)
    — and counts the launch in ``cgs_pass.launches`` and, by dtype, in
    ``cgs_pass.launches_by_dtype``.  ``k == 0`` launches nothing.  On CPU
    tensors it returns :func:`cgs_pass_reference`.  Callers use the return
    value.  With ``reduce`` (the module's note) the pass is the projection,
    ``reduce`` of the k coefficients in the scratch, then the update: one
    launch counted.

    The launch path is short, since at small k the host's part is most of
    a call: the foreign functions are resolved once per device, the stream
    is the raw handle, and one scratch tensor holds the partial sums and
    the coefficients.
    """
    k = int(k)
    cap, n = basis.shape
    if v.shape != (n,) or not 0 <= k <= cap:
        raise ValueError(f"v of shape {tuple(v.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if v.device.type == "cpu":
        return cgs_pass_reference(v, basis, k, reduce)
    if v.device.type != "cuda":
        raise ValueError(f"cgs_pass runs on CPU or CUDA tensors, got {v.device}")
    if basis.dtype not in _K3_ENTRY:
        raise NotImplementedError(
            f"K3 takes float32/float64/complex64/complex128 bases on CUDA, got {basis.dtype}; see {_DTYPE_ITEM}")
    if v.dtype != basis.dtype:
        raise TypeError(f"v dtype {v.dtype} differs from the basis dtype {basis.dtype}")
    if basis.device != v.device:
        raise ValueError("v and basis must be on one device")
    if not (basis.is_contiguous() and v.is_contiguous()):
        raise ValueError("cgs_pass needs contiguous tensors")
    if k == 0:
        return v
    idx = v.device.index
    fn, keep = _k3_entry(idx)[basis.dtype]
    n_tiles = -(-n // (TILE_BYTES // basis.element_size()))
    scratch = torch.empty(k * (n_tiles + 1), dtype=basis.dtype, device=v.device)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    for phases in (_WHOLE,) if reduce is None else (_PROJECT, _UPDATE):
        if phases == _UPDATE:
            reduce(scratch[k * n_tiles :])
        err = fn(basis.data_ptr(), v.data_ptr(), scratch.data_ptr(), scratch.numel(), n, k, keep(n), phases, idx,
                 stream)
        if err:
            _build.check(err, "cgs_pass (K3)")
    cgs_pass.launches += 1
    _K3_BY_DTYPE[basis.dtype] += 1
    return v


# The counter object itself is shared, so a stand-in that records calls on
# the module attribute (as chip_smoke.py's recorders do) leaves it counting.
_K3_BY_DTYPE = collections.Counter()
cgs_pass.launches = 0
cgs_pass.launches_by_dtype = _K3_BY_DTYPE


class BlockPlan(NamedTuple):
    """How K4 cuts one pass: ``cols`` columns per CTA, ``grid`` CTAs and a
    ring of ``stages`` row segments."""

    cols: int
    grid: int
    stages: int


def block_vectors_per_thread(b: int) -> int:
    """16-byte vectors of each row a consumer thread handles for block width
    ``b``: the thread keeps ``b`` of them per vector in registers (64
    registers or fewer)."""
    return 4 if b <= 4 else (2 if b <= 8 else 1)


def block_plan(n: int, b: int, itemsize: int, num_sms: int) -> BlockPlan:
    """K4's column range per CTA for an (n,)-wide basis of ``itemsize``-byte
    values, a width-``b`` block and a card of ``num_sms`` SMs.

    The range is at most 256 consumer threads times
    :func:`block_vectors_per_thread` vectors.  The grid is a whole number of
    waves of :data:`BLOCK_CTAS_PER_SM` resident CTAs per SM, with the fewest
    waves that keep the range under that limit, so every SM streams the
    same share of the basis.  The range is rounded up to the coarsest of
    128, 64, 32 or 16 bytes that still leaves two CTAs per SM: the ring's
    bulk copies reached the read stream on the H100 only from 128-byte
    aligned segments (PERF.md).  The ring holds
    :data:`BLOCK_RING_BYTES` of segments, 2 to 8 of them."""
    vn = 16 // itemsize
    cols_max = BLOCK_CONSUMERS * block_vectors_per_thread(b) * vn
    slots = BLOCK_CTAS_PER_SM * num_sms
    waves = -(-n // (slots * cols_max))
    base = -(-n // (slots * waves))
    for granule in (128, 64, 32, 16):
        g = granule // itemsize
        cols = -(-base // g) * g
        if -(-n // cols) >= min(slots, -(-n // vn)):
            break
    stages = max(BLOCK_MIN_STAGES, min(BLOCK_MAX_STAGES, BLOCK_RING_BYTES // (cols * itemsize)))
    return BlockPlan(cols, -(-n // cols), stages)


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cgs_pass_block_reference(vblk, basis, k: int, reduce=None):
    """Plain PyTorch block pass: ``V - (B[:k] V^H)^T B[:k]`` for a (b, n)
    block ``V`` (conjugated coefficients for complex bases), with
    ``reduce`` applied to the (k, b) coefficients first when given; returns
    a new tensor."""
    if k <= 0:
        return vblk
    rows = basis[:k]
    c = (rows.conj() if rows.is_complex() else rows) @ vblk.T  # (k, b)
    if reduce is not None:
        c = reduce(c)
    return vblk - c.T @ rows


def cgs_pass_block(vblk, basis, k: int, reduce=None):
    """K4: one classical GS pass of every row of the (b, n) block ``vblk``
    against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/cgs_block.cu`` (float32, float64,
    complex64 or complex128, the complex ones with conjugated coefficients;
    1 <= b <= 16; bfloat16 raises) cut by :func:`block_plan`, overwrites
    ``vblk`` with the result and returns it — the JAX kernel aliases the
    block to its output the same way (pallas_cgs.py:190) — and counts the
    launch in ``cgs_pass_block.launches`` and, by dtype, in
    ``cgs_pass_block.launches_by_dtype``.  ``k == 0`` launches nothing.  On
    CPU tensors it returns :func:`cgs_pass_block_reference`.  Callers use
    the return value.  With ``reduce`` (the module's note) the pass is the
    projection, ``reduce`` of the (k, b) coefficients, then the update: one
    launch counted.
    """
    k = int(k)
    cap, n = basis.shape
    if vblk.ndim != 2 or vblk.shape[1] != n or not 0 <= k <= cap:
        raise ValueError(f"block of shape {tuple(vblk.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if vblk.device.type == "cpu":
        return cgs_pass_block_reference(vblk, basis, k, reduce)
    if vblk.device.type != "cuda":
        raise ValueError(f"cgs_pass_block runs on CPU or CUDA tensors, got {vblk.device}")
    if basis.dtype not in _K4_ENTRY:
        raise NotImplementedError(
            f"K4 takes float32/float64/complex64/complex128 bases on CUDA, got {basis.dtype}; see {_BLOCK_DTYPE_ITEM}")
    b = vblk.shape[0]
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"K4 takes blocks of 1 to {MAX_BLOCK} rows, got {b}")
    if vblk.dtype != basis.dtype:
        raise TypeError(f"block dtype {vblk.dtype} differs from the basis dtype {basis.dtype}")
    if basis.device != vblk.device:
        raise ValueError("block and basis must be on one device")
    if not (basis.is_contiguous() and vblk.is_contiguous()):
        raise ValueError("cgs_pass_block needs contiguous tensors")
    if k == 0:
        return vblk
    lib = _build.library()
    plan = block_plan(n, b, basis.element_size(), _num_sms(vblk.device))
    part = torch.empty((k * b, plan.grid), dtype=basis.dtype, device=vblk.device)
    c = torch.empty((k, b), dtype=basis.dtype, device=vblk.device)
    fn = getattr(lib, _K4_ENTRY[basis.dtype][0])
    stream = torch.cuda.current_stream(vblk.device).cuda_stream
    for phases in (_WHOLE,) if reduce is None else (_PROJECT, _UPDATE):
        if phases == _UPDATE:
            reduce(c)
        err = fn(basis.data_ptr(), vblk.data_ptr(), part.data_ptr(), c.data_ptr(), n, k, b, plan.cols, plan.stages,
                 phases, vblk.device.index, stream)
        _build.check(err, "cgs_pass_block (K4)")
    cgs_pass_block.launches += 1
    _K4_BY_DTYPE[basis.dtype] += 1
    return vblk


_K4_BY_DTYPE = collections.Counter()
cgs_pass_block.launches = 0
cgs_pass_block.launches_by_dtype = _K4_BY_DTYPE
