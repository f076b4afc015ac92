"""Classical Gram-Schmidt passes over the live Krylov rows: kernels K3
(one vector) and K4 (a block of vectors) and their plain versions (port of
``lanczos_tpu/ops/pallas_cgs.py`` ``cgs_pass`` and ``cgs_pass_block``).

One pass is classical GS over rows [0, k): every coefficient is measured
against the incoming vector, v <- v - B[:k]^T (B[:k] v) — the semantics of
the Pallas kernels (pallas_cgs.py:32-38) and of the JAX package's CPU path.
The block pass does the same for each row of a (b, n) block, reading the
basis once for all b rows.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["cgs_pass", "cgs_pass_reference", "cgs_pass_block", "cgs_pass_block_reference"]

_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K3 for complex and bfloat16 bases"
_BLOCK_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K4 for complex and bfloat16 bases"
MAX_BLOCK = 16  # widest block K4 takes


def cgs_pass_reference(v, basis, k: int):
    """Plain PyTorch pass: ``v - B[:k]^T (B[:k] v)`` (conjugated
    coefficients for complex bases); returns a new tensor."""
    if k <= 0:
        return v
    rows = basis[:k]
    c = rows.conj() @ v if rows.is_complex() else rows @ v
    return v - c @ rows


def cgs_pass(v, basis, k: int):
    """K3: one classical GS pass of ``v`` against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/cgs.cu`` (float32 or float64; other
    dtypes raise), overwrites ``v`` with the result and returns it — the JAX
    kernel aliases ``v`` to its output the same way (pallas_cgs.py:226) —
    and counts the launch in ``cgs_pass.launches``.  ``k == 0`` launches
    nothing.  On CPU tensors it returns :func:`cgs_pass_reference`.
    Callers use the return value.
    """
    k = int(k)
    cap, n = basis.shape
    if v.shape != (n,) or not 0 <= k <= cap:
        raise ValueError(f"v of shape {tuple(v.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if v.device.type == "cpu":
        return cgs_pass_reference(v, basis, k)
    if v.device.type != "cuda":
        raise ValueError(f"cgs_pass runs on CPU or CUDA tensors, got {v.device}")
    if basis.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"K3 takes float32/float64 bases on CUDA, got {basis.dtype}; see {_DTYPE_ITEM}")
    if v.dtype != basis.dtype:
        raise TypeError(f"v dtype {v.dtype} differs from the basis dtype {basis.dtype}")
    if basis.device != v.device:
        raise ValueError("v and basis must be on one device")
    if not (basis.is_contiguous() and v.is_contiguous()):
        raise ValueError("cgs_pass needs contiguous tensors")
    if k == 0:
        return v
    lib = _build.library()
    f32 = basis.dtype == torch.float32
    n_tiles = (lib.lt_cgs_num_tiles_f32 if f32 else lib.lt_cgs_num_tiles_f64)(n)
    part = torch.empty((k, n_tiles), dtype=basis.dtype, device=v.device)
    c = torch.empty(k, dtype=basis.dtype, device=v.device)
    fn = lib.lt_cgs_pass_f32 if f32 else lib.lt_cgs_pass_f64
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = fn(basis.data_ptr(), v.data_ptr(), part.data_ptr(), c.data_ptr(), n, k, v.device.index, stream)
    _build.check(err, "cgs_pass (K3)")
    cgs_pass.launches += 1
    return v


cgs_pass.launches = 0


def cgs_pass_block_reference(vblk, basis, k: int):
    """Plain PyTorch block pass: ``V - (B[:k] V^H)^T B[:k]`` for a (b, n)
    block ``V`` (conjugated coefficients for complex bases); returns a new
    tensor."""
    if k <= 0:
        return vblk
    rows = basis[:k]
    c = (rows.conj() if rows.is_complex() else rows) @ vblk.T  # (k, b)
    return vblk - c.T @ rows


def cgs_pass_block(vblk, basis, k: int):
    """K4: one classical GS pass of every row of the (b, n) block ``vblk``
    against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/cgs_block.cu`` (float32 or float64,
    1 <= b <= 16; other dtypes raise), overwrites ``vblk`` with the result
    and returns it — the JAX kernel aliases the block to its output the same
    way (pallas_cgs.py:190) — and counts the launch in
    ``cgs_pass_block.launches``.  ``k == 0`` launches nothing.  On CPU
    tensors it returns :func:`cgs_pass_block_reference`.  Callers use the
    return value.
    """
    k = int(k)
    cap, n = basis.shape
    if vblk.ndim != 2 or vblk.shape[1] != n or not 0 <= k <= cap:
        raise ValueError(f"block of shape {tuple(vblk.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if vblk.device.type == "cpu":
        return cgs_pass_block_reference(vblk, basis, k)
    if vblk.device.type != "cuda":
        raise ValueError(f"cgs_pass_block runs on CPU or CUDA tensors, got {vblk.device}")
    if basis.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"K4 takes float32/float64 bases on CUDA, got {basis.dtype}; see {_BLOCK_DTYPE_ITEM}")
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
    f32 = basis.dtype == torch.float32
    n_tiles = (lib.lt_cgs_block_num_tiles_f32 if f32 else lib.lt_cgs_block_num_tiles_f64)(n, b)
    part = torch.empty((k * b, n_tiles), dtype=basis.dtype, device=vblk.device)
    c = torch.empty(k * b, dtype=basis.dtype, device=vblk.device)
    fn = lib.lt_cgs_block_pass_f32 if f32 else lib.lt_cgs_block_pass_f64
    stream = torch.cuda.current_stream(vblk.device).cuda_stream
    err = fn(basis.data_ptr(), vblk.data_ptr(), part.data_ptr(), c.data_ptr(), n, k, b, vblk.device.index, stream)
    _build.check(err, "cgs_pass_block (K4)")
    cgs_pass_block.launches += 1
    return vblk


cgs_pass_block.launches = 0
