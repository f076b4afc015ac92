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
gather x into shared memory in pieces, so every operator that packs runs on
the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["bsr_matvec", "bsr_matvec_rsmk", "bsr_matvec_reference"]

# ROADMAP.md names the work that would lift each refusal below.
_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K1 for complex and bfloat16 tiles"
_RSMK_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K2 for complex and bfloat16 tiles"


def bsr_matvec_reference(blocks, col_blocks, x, layout: str = "rsmk"):
    """Plain PyTorch BSR matvec for either layout, any dtype.

    Accumulates in at least float32 (bfloat16 tiles widen, as
    ``preferred_element_type`` does in the JAX package) and returns
    ``x.dtype``.  ``x`` has the padded length R*bm.
    """
    if layout == "rmsk":
        spec = "rmsk,rsk->rm"
    elif layout == "rsmk":
        spec = "rsmk,rsk->rm"
    else:
        raise ValueError(f"layout must be 'rmsk' or 'rsmk', got {layout!r}")
    bk = blocks.shape[3]
    xg = x.reshape(-1, bk)[col_blocks.long()]  # (R, S, bk) gather of needed segments
    acc = torch.promote_types(blocks.dtype, torch.float32)
    y = torch.einsum(spec, blocks.to(acc), xg.to(acc))
    return y.reshape(-1).to(x.dtype)


def bsr_matvec(blocks, col_blocks, x, n_out: int | None = None):
    """K1: y = A x for ``rmsk`` tiles; returns the first ``n_out`` rows
    (default R*bm).

    ``x`` may be shorter than R*bm (the unpadded vector): entries past its
    end read as zero, as the JAX package's zero padding does.  On CUDA
    tensors this launches ``csrc/bsr_spmv.cu`` (float32 or float64; other
    dtypes raise) and counts the launch in ``bsr_matvec.launches``; on CPU
    tensors it runs :func:`bsr_matvec_reference`.
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
    if blocks.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"K1 takes float32/float64 tiles on CUDA, got {blocks.dtype}; see {_DTYPE_ITEM}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"x dtype {x.dtype} differs from the tile dtype {blocks.dtype}")
    if col_blocks.dtype != torch.int32 or col_blocks.shape != (r, s):
        raise TypeError(f"col_blocks must be int32 of shape {(r, s)}, got {col_blocks.dtype} {tuple(col_blocks.shape)}")
    if not (blocks.device == col_blocks.device == x.device):
        raise ValueError("blocks, col_blocks and x must be on one device")
    if not (blocks.is_contiguous() and col_blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError("bsr_matvec needs contiguous tensors")
    lib = _build.library()
    fn = lib.lt_bsr_spmv_f32 if blocks.dtype == torch.float32 else lib.lt_bsr_spmv_f64
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(blocks.data_ptr(), col_blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
             r, bm, s, bk, x.shape[0], n_out, x.device.index, stream)
    _build.check(err, "bsr_matvec (K1)")
    bsr_matvec.launches += 1
    return y


bsr_matvec.launches = 0


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
    ``rsmk`` form (float32 or float64; other dtypes raise) and counts the
    launch in ``bsr_matvec_rsmk.launches``; on CPU tensors it runs
    :func:`bsr_matvec_reference`.
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
    if blocks.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"K2 takes float32/float64 tiles on CUDA, got {blocks.dtype}; see {_RSMK_DTYPE_ITEM}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"x dtype {x.dtype} differs from the tile dtype {blocks.dtype}")
    if col_blocks.dtype != torch.int32:
        raise TypeError(f"col_blocks must be int32, got {col_blocks.dtype}")
    if not (blocks.device == col_blocks.device == x.device):
        raise ValueError("blocks, col_blocks and x must be on one device")
    if not (blocks.is_contiguous() and col_blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError("bsr_matvec_rsmk needs contiguous tensors")
    lib = _build.library()
    fn = lib.lt_bsr_spmv_rsmk_f32 if blocks.dtype == torch.float32 else lib.lt_bsr_spmv_rsmk_f64
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(blocks.data_ptr(), col_blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
             r, bm, s, bk, x.shape[0], n_out, x.device.index, stream)
    _build.check(err, "bsr_matvec_rsmk (K2)")
    bsr_matvec_rsmk.launches += 1
    return y


bsr_matvec_rsmk.launches = 0
