"""E1: the BSR SpMV study's three kernel variants (port of
``experiments/pallas_spmv_bench.py``).

The JAX study timed candidate Pallas SpMV kernels against the XLA
gather+einsum path on its 64 Mi-nnz operator (R = 512 row blocks, S = 8
tiles each, 128 x 128 float32 tiles).  Its variants keep their names:

  einsum  the plain version, ``ops.spmv.bsr_matvec_reference`` (the
          gather, then one product per tile, summed over the row block);
  v1      K2, ``ops.spmv.bsr_matvec_rsmk`` (the study's round-1 kernel);
  v2      :func:`spmv_v2`, one dot per tile row;
  v2vpu   :func:`spmv_v2` with ``vpu=True``: elementwise products of each
          tile row, then row sums;
  v3      :func:`spmv_v3`, pre-transposed (R, bm, S, bk) tiles, the x
          segments of a row block gathered once, one long dot per row.

v2, v2vpu and v3 are the CUDA kernels of ``csrc/spmv_variants.cu``; v2's
two forms are one kernel on a grid that fills the card (:func:`vpu_plan`),
and G sizes only v3's grid.  Unlike the Pallas kernels, whose grid of
R // G steps leaves the last R mod G row blocks unwritten, they write every
row block.

Run on the card: ``python -m lanczos_tpu_torch.experiments.spmv_bench``.
"""

from __future__ import annotations

import functools
import json
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..ops import spmv
from . import _timing

__all__ = [
    "VpuPlan",
    "vpu_plan",
    "vpu_smem_bytes",
    "spmv_v2",
    "spmv_v2_reference",
    "spmv_v3",
    "spmv_v3_reference",
    "make_data",
    "make_cancelling_data",
    "check",
    "run_study",
    "main",
]


# v2's launch shape, both forms (csrc/spmv_variants.cu): 256 threads per
# CTA, at most 8 tile rows per warp, x segments gathered 32 KB at a time.
VPU_THREADS = 256
VPU_WARPS = VPU_THREADS // 32
VPU_MAX_ROWS_PER_WARP = 8
VPU_X_PIECE_BYTES = 32 * 1024
MAX_SMEM_BYTES = 227 * 1024  # what one CTA can ask for on the H100


class VpuPlan(NamedTuple):
    """How v2 (either form) cuts one SpMV: ``ctas`` CTAs of ``threads``
    threads, each warp on ``rows_per_warp`` tile rows of one row block, the
    x segments of ``s_piece`` tiles gathered into shared memory at a time,
    ``smem_bytes`` of dynamic shared memory per CTA."""

    ctas: int
    threads: int
    rows_per_warp: int
    s_piece: int
    smem_bytes: int


def _up16(b: int) -> int:
    return -(-b // 16) * 16


def vpu_smem_bytes(rows_per_warp: int, s_piece: int, bk: int, itemsize: int) -> int:
    """Dynamic shared memory of one v2 CTA, as
    ``csrc/spmv_variants.cu`` ``vpu_smem_bytes`` lays it out: the x
    segments, a flag per tile, and the warps' row totals between x
    pieces."""
    return _up16(s_piece * bk * itemsize) + _up16(s_piece * 4) + VPU_WARPS * rows_per_warp * itemsize


@functools.lru_cache(maxsize=64)
def vpu_plan(r: int, s: int, bm: int, bk: int, itemsize: int) -> VpuPlan:
    """v2's launch plan, the dot form's and the VPU form's, for (R, S, bm,
    bk) tiles of ``itemsize``-byte values.

    A CTA covers ``VPU_WARPS * rows_per_warp`` tile rows of one row block,
    ``rows_per_warp = min(8, ceil(bm / 8))``, so a row block takes
    ``ceil(bm / (8 * rows_per_warp))`` CTAs and the grid is R times that:
    1024 CTAs at the study's size, the card filled without G.  CTA c takes
    row block ``c // per_block``; its warp w the rows from ``(c % per_block)
    * 8 * rows_per_warp + w * rows_per_warp`` on, up to bm.  The x
    segments of :data:`VPU_X_PIECE_BYTES` worth of tiles (at least one, at
    most S) are gathered at a time.  Raises where one tile's segment does
    not fit a CTA's shared memory."""
    if min(r, s, bm, bk) < 1 or itemsize not in (4, 8):
        raise ValueError(f"vpu_plan: R={r}, S={s}, bm={bm}, bk={bk}, itemsize={itemsize}")
    rows_per_warp = min(VPU_MAX_ROWS_PER_WARP, -(-bm // VPU_WARPS))
    per_block = -(-bm // (VPU_WARPS * rows_per_warp))
    s_piece = max(1, min(s, VPU_X_PIECE_BYTES // (bk * itemsize)))
    smem = vpu_smem_bytes(rows_per_warp, s_piece, bk, itemsize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"vpu_plan: a tile row of {bk} values needs {smem} bytes of shared memory")
    return VpuPlan(r * per_block, VPU_THREADS, rows_per_warp, s_piece, smem)


def _validate(name: str, blocks, col_blocks, x, G, s_axis: int):
    """Check the operands of a variant and return (R, S, bm, bk, x flat)."""
    if blocks.ndim != 4:
        raise ValueError(f"{name}: blocks of shape {tuple(blocks.shape)} are not 4-d tiles")
    r, s = blocks.shape[0], blocks.shape[s_axis]
    bm, bk = blocks.shape[3 - s_axis], blocks.shape[3]
    x = x.reshape(-1)
    if col_blocks.shape != (r, s) or s < 1:
        raise ValueError(f"{name}: col_blocks of shape {tuple(col_blocks.shape)} is not ({r}, {s}), S >= 1")
    if x.shape[0] % bk:
        raise ValueError(f"{name}: x of {x.shape[0]} values is not a table of rows of width {bk}")
    if int(G) != G or G < 1:
        raise ValueError(f"{name}: G must be a positive int, got {G!r}")
    return r, s, bm, bk, x


def _gather(col_blocks, x, bk: int, dtype):
    """The (R, S, bk) x segments the tiles multiply, in ``dtype``."""
    return x.reshape(-1, bk)[col_blocks.long()].to(dtype)


def spmv_v2_reference(blocks, col_blocks, x, G: int = 8, vpu: bool = False):
    """Plain PyTorch v2: y = A x for (R, S, bm, bk) tiles; ``x`` is a table
    of rows of width bk that ``col_blocks`` indexes.  Each tile's product
    (a dot per row, or with ``vpu`` an elementwise product summed over each
    row) is added into its row block's sum in the order of the tiles, in at
    least float32; returns (R * bm,) of ``x.dtype``.  ``G`` changes nothing
    here."""
    r, s, bm, bk, x = _validate("spmv_v2_reference", blocks, col_blocks, x, G, 1)
    acc = torch.promote_types(blocks.dtype, torch.float32)
    xg = _gather(col_blocks, x, bk, acc)
    b = blocks.to(acc)
    per_tile = (b * xg[:, :, None, :]).sum(dim=3) if vpu else torch.einsum("rsmk,rsk->rsm", b, xg)
    y = per_tile[:, 0]
    for j in range(1, s):
        y = y + per_tile[:, j]
    return y.reshape(-1).to(x.dtype)


def spmv_v3_reference(blocks_t, col_blocks, x, G: int = 8):
    """Plain PyTorch v3: y = A x for pre-transposed (R, bm, S, bk) tiles,
    one (bm, S*bk) . (S*bk) product per row block over the gathered
    segments, in at least float32; returns (R * bm,) of ``x.dtype``."""
    r, s, bm, bk, x = _validate("spmv_v3_reference", blocks_t, col_blocks, x, G, 2)
    acc = torch.promote_types(blocks_t.dtype, torch.float32)
    xg = _gather(col_blocks, x, bk, acc).reshape(r, s * bk)
    y = torch.einsum("rmj,rj->rm", blocks_t.reshape(r, bm, s * bk).to(acc), xg)
    return y.reshape(-1).to(x.dtype)


# The kernels' foreign functions by (variant, dtype), resolved at the first
# CUDA call (the library is built then, never at import).
_FNS: dict = {}


def _launch(name: str, variant: str, blocks, col_blocks, x, dims, *extra):
    """One launch of the ``csrc/spmv_variants.cu`` entry point
    ``lt_spmv_<variant>_f32/_f64`` on checked CUDA operands, ``fn(blocks,
    col_blocks, x, y, R, S, bm, bk, *extra, device, stream)`` with ``dims
    = (R, S, bm, bk)``; returns y.  The host's part is kept short, since a
    ~0.1 ms SpMV's single call also holds it: the foreign function is
    resolved once, and the stream is the raw handle of
    ``torch._C._cuda_getCurrentRawStream``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if blocks.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"{name} takes float32/float64 tiles on CUDA, got {blocks.dtype}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"{name}: x dtype {x.dtype} differs from the tile dtype {blocks.dtype}")
    if col_blocks.dtype != torch.int32:
        raise TypeError(f"{name}: col_blocks must be int32, got {col_blocks.dtype}")
    if not (blocks.device == col_blocks.device == x.device):
        raise ValueError(f"{name}: blocks, col_blocks and x must be on one device")
    if not (blocks.is_contiguous() and col_blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if not _FNS:
        lib = _build.library()
        _FNS.update({(v, dt): getattr(lib, f"lt_spmv_{v}_{suffix}") for v in ("v2", "v3")
                     for dt, suffix in ((torch.float32, "f32"), (torch.float64, "f64"))})
    y = torch.empty(dims[0] * dims[2], dtype=x.dtype, device=x.device)
    idx = x.device.index
    err = _FNS[variant, blocks.dtype](blocks.data_ptr(), col_blocks.data_ptr(), x.data_ptr(), y.data_ptr(), *dims,
                                      *extra, idx, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        _build.check(err, name)
    return y


def spmv_v2(blocks, col_blocks, x, G: int = 8, vpu: bool = False):
    """E1, v2: y = A x for (R, S, bm, bk) tiles, each tile multiplied as
    one dot per row (``vpu=False``), or as elementwise products summed over
    each tile row (``vpu=True``), both on the grid of :func:`vpu_plan`,
    which G does not change.

    On CUDA tensors this launches ``csrc/spmv_variants.cu`` (float32 or
    float64; other dtypes raise) and counts the launch in
    ``spmv_v2.launches`` or, with ``vpu``, ``spmv_v2.vpu_launches``.  On CPU
    tensors it runs :func:`spmv_v2_reference`.
    """
    r, s, bm, bk, x = _validate("spmv_v2", blocks, col_blocks, x, G, 1)
    if x.device.type == "cpu":
        return spmv_v2_reference(blocks, col_blocks, x, G, vpu)
    dims = (r, s, bm, bk)
    y = _launch("spmv_v2_vpu (E1)" if vpu else "spmv_v2 (E1)", "v2", blocks, col_blocks, x, dims, x.shape[0],
                int(vpu), *vpu_plan(*dims, blocks.element_size()))
    if vpu:
        spmv_v2.vpu_launches += 1
    else:
        spmv_v2.launches += 1
    return y


spmv_v2.launches = 0
spmv_v2.vpu_launches = 0


def spmv_v3(blocks_t, col_blocks, x, G: int = 8):
    """E1, v3: y = A x for (R, bm, S, bk) tiles with G row blocks per CTA;
    each row block's S x segments are gathered into shared memory once,
    then each row is one (S*bk)-long dot.  S*bk values must fit in the
    CTA's shared memory (227 KB); more raise.

    On CUDA tensors this launches ``csrc/spmv_variants.cu`` (float32 or
    float64; other dtypes raise) and counts the launch in
    ``spmv_v3.launches``.  On CPU tensors it runs :func:`spmv_v3_reference`.
    """
    r, s, bm, bk, x = _validate("spmv_v3", blocks_t, col_blocks, x, G, 2)
    if x.device.type == "cpu":
        return spmv_v3_reference(blocks_t, col_blocks, x, G)
    y = _launch("spmv_v3 (E1)", "v3", blocks_t, col_blocks, x, (r, s, bm, bk), int(G), x.shape[0])
    spmv_v3.launches += 1
    return y


spmv_v3.launches = 0


def make_data(r: int = 512, s: int = 8, bm: int = 128, bk: int = 128, seed: int = 0, dtype=np.float32):
    """The study's operator from ``numpy.random.default_rng(seed)``
    (``pallas_spmv_bench.py:141-150``): (R, S, bm, bk) tiles of 0.01 times
    standard normals, the same tiles as (R, bm, S, bk), random column
    blocks over the R*bm/bk rows of x, and x.  Returns numpy arrays
    ``(blocks, blocks_t, col_blocks, x)``."""
    rng = np.random.default_rng(seed)
    n_pad = r * bm
    blocks = (rng.standard_normal((r, s, bm, bk)) * 0.01).astype(dtype)
    blocks_t = np.ascontiguousarray(np.moveaxis(blocks, 2, 1))
    col_blocks = rng.integers(0, n_pad // bk, size=(r, s)).astype(np.int32)
    x = rng.standard_normal(n_pad).astype(dtype)
    return blocks, blocks_t, col_blocks, x


def make_cancelling_data(r: int = 16, s: int = 8, bm: int = 128, bk: int = 128, seed: int = 0, dtype=np.float32):
    """:func:`make_data`'s operator with tile 0 of every row block moved to
    a column block of its own, the last row of x, whose rows cancel: tile
    row i holds -1 and a_j at columns 2j and 2j + 1 (j = i mod bk/2) and
    zeros elsewhere, and that row of x holds p_j = fl(a_j b_j) and b_j
    there (a_j, b_j random integers, so that |a_j b_j| is about 2**25 in
    float32 and 2**61 in float64).  Products rounded on their own, the VPU
    form's, sum each such tile row to exactly 0.  An FMA chain over the
    pair in column order leaves a_j b_j - p_j, the product's rounding
    error, which is as large as the row sums of the other tiles.  No other
    tile reads that row of x.  Returns numpy arrays ``(blocks, blocks_t,
    col_blocks, x)``."""
    if bk % 2 or r * bm // bk < 2:
        raise ValueError(f"make_cancelling_data: bk={bk} must be even and the x table at least 2 rows")
    blocks, _, _, x = make_data(r, s, bm, bk, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    c_last = r * bm // bk - 1
    col_blocks = rng.integers(0, c_last, size=(r, s)).astype(np.int32)
    col_blocks[:, 0] = c_last
    lo = 2**12 if np.dtype(dtype) == np.float32 else 2**30
    a = rng.integers(lo, 2 * lo, size=bk // 2).astype(dtype)
    b = rng.integers(lo, 2 * lo, size=bk // 2).astype(dtype)
    j = np.arange(bm) % (bk // 2)
    tile = np.zeros((bm, bk), dtype)
    tile[np.arange(bm), 2 * j] = -1
    tile[np.arange(bm), 2 * j + 1] = a[j]
    blocks[:, 0] = tile
    x[c_last * bk : (c_last + 1) * bk] = np.stack([a * b, b], axis=1).reshape(-1)  # a * b: one rounding
    return blocks, np.ascontiguousarray(np.moveaxis(blocks, 2, 1)), col_blocks, x


def _variants(blocks, blocks_t, col_blocks, G: int):
    """name -> (tiles, fn(tiles, col_blocks, x)) for the study's variant set."""
    c_rows = blocks.shape[0] * blocks.shape[2] // blocks.shape[3]
    return {
        "einsum": (blocks, lambda b, c, v: spmv.bsr_matvec_reference(b, c, v, layout="rsmk")),
        "v1": (blocks, lambda b, c, v: spmv.bsr_matvec_rsmk(b, c, v, col_bound=c_rows)),
        "v2": (blocks, lambda b, c, v: spmv_v2(b, c, v, G=G)),
        "v2vpu": (blocks, lambda b, c, v: spmv_v2(b, c, v, G=G, vpu=True)),
        "v3": (blocks_t, lambda b, c, v: spmv_v3(b, c, v, G=G)),
    }


def check(r: int = 64, s: int = 8, bm: int = 128, bk: int = 128, G: int = 8, device="cuda", seed: int = 0) -> list[str]:
    """One line per kernel variant and row count: the relative error
    (max |y - y64| over max |y64|) against the float64 gather+einsum, at
    R = r and at R = r + G // 2, whose last CTA owns a partial group of row
    blocks.  On ``device="cpu"`` the variants run their plain versions."""
    device = _timing.resolve_device(device)
    lines = []
    for rows in (r, r + max(G // 2, 1)):
        blocks, blocks_t, cb, x = (torch.from_numpy(a).to(device) for a in make_data(rows, s, bm, bk, seed))
        want = spmv.bsr_matvec_reference(blocks.double(), cb, x.double(), layout="rsmk")
        scale = float(want.abs().max())
        for name, (tiles, fn) in _variants(blocks, blocks_t, cb, G).items():
            if name in ("v2", "v2vpu", "v3"):
                err = float((fn(tiles, cb, x).double() - want).abs().max()) / scale
                lines.append(f"{name} R={rows} G={G}: rel err vs float64 einsum = {err:.2e}")
    return lines


def run_study(blocks, blocks_t, col_blocks, x, G: int = 8, short: int = 64, long: int = 192, repeats: int = 5) -> dict:
    """The study's variant set on CUDA operands: for each variant its error
    against the plain gather+einsum (relative to max |y|) and its time per
    SpMV by the marginal method over chains of ``short`` and ``long`` SpMVs
    (``x <- 0.01 A x``, CUDA events), as ms, Gnnz/s and GB/s of tile
    bytes."""
    device = _timing.cuda_device(x.device)
    nnz = blocks.numel()
    ref = spmv.bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")
    out = {}
    for name, (tiles, fn) in _variants(blocks, blocks_t, col_blocks, G).items():
        err = float((fn(tiles, col_blocks, x) - ref).abs().max() / ref.abs().max())

        def chain(k, fn=fn, tiles=tiles):
            v = x
            for _ in range(k):
                v = fn(tiles, col_blocks, v) * 0.01

        t = _timing.marginal(chain, short, long, repeats=repeats, device=device)
        out[name] = {"ms": t * 1e3, "gnnz_per_s": nnz / t / 1e9, "gb_per_s": nnz * blocks.element_size() / t / 1e9,
                     "rel_err": err}
    return out


def main(device="cuda") -> None:
    """The study at its size (R = 512, S = 8, 128 x 128 float32 tiles, 64 Mi
    stored nonzeros): :func:`run_study`, one line per variant, then one
    JSON object."""
    device = _timing.cuda_device(device)
    blocks, blocks_t, cb, x = (torch.from_numpy(a).to(device) for a in make_data())
    out = {"device": torch.cuda.get_device_name(device)}
    for name, row in run_study(blocks, blocks_t, cb, x).items():
        out[name] = row
        print(name, row, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
