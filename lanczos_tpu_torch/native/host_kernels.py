"""ctypes bindings of the port's host library (``host_kernels.cpp``, the
JAX package's source): the implicit-shift QL tridiagonal eigensolver, Sturm
bisection and the COO -> BSR packer, with the signatures of
``lanczos_tpu.native.host_kernels``.

The library is built at the first call, never at import
(:mod:`.build`).  :func:`available` says whether it loads; every solver
raises with the build's message when it does not.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import build

__all__ = [
    "available",
    "tridiagonal_eigh",
    "tridiagonal_eigvals_bisect",
    "tridiagonal_eigh_bisect",
    "consume_unconverged",
    "pack_bsr",
]

# Running total of small-solve blocks that hit the QL iteration cap (the
# reference's forced-break count, tridiagonal_impl.hpp:290-343).  api.run
# reads it around a solve and reports the delta in RunStats.
_UNCONVERGED_TOTAL = 0


def consume_unconverged() -> int:
    """The accumulated unconverged-block count since the process started."""
    return _UNCONVERGED_TOTAL


_i64 = ctypes.c_int64
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


@functools.cache
def _load():
    """``(library, None)``, or ``(None, why it did not build or load)``:
    the outcome of one attempt per process."""
    try:
        lib = ctypes.CDLL(str(build.shared_object_path()))
    except (RuntimeError, OSError) as exc:
        return None, str(exc)
    lib.lt_tridiagonal_eigh.restype = ctypes.c_int
    lib.lt_tridiagonal_eigh.argtypes = [_f64p, _f64p, _i64, _f64p, _f64p, ctypes.c_int]
    lib.lt_tridiagonal_eigvals_bisect.restype = None
    lib.lt_tridiagonal_eigvals_bisect.argtypes = [_f64p, _f64p, _i64, _i64, _i64, _f64p]
    lib.lt_tridiagonal_eigh_bisect.restype = None
    lib.lt_tridiagonal_eigh_bisect.argtypes = [_f64p, _f64p, _i64, _i64, _i64, _f64p, _f64p]
    lib.lt_bsr_count.restype = _i64
    lib.lt_bsr_count.argtypes = [_i64p, _i64p, _i64, _i64, _i64, _i64, _i64p]
    lib.lt_bsr_fill_f32.restype = None
    lib.lt_bsr_fill_f32.argtypes = [_i64p, _i64p, _f32p, _i64, _i64, _i64, _i64, _i64p, _i64, _i64p, _f32p]
    lib.lt_bsr_fill_f64.restype = None
    lib.lt_bsr_fill_f64.argtypes = [_i64p, _i64p, _f64p, _i64, _i64, _i64, _i64, _i64p, _i64, _i64p, _f64p]
    return lib, None


def available() -> bool:
    """Whether the library builds and loads."""
    return _load()[0] is not None


def _require_lib():
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native tridiagonal library is not available: {why}")
    return lib


def _validate_tridiag(alpha, beta, first=None, count=None):
    m = alpha.shape[0]
    if beta.shape[0] < max(m - 1, 0):
        raise ValueError(f"beta must have at least m-1 entries, got {beta.shape[0]} for m={m}")
    if first is not None and not (0 <= first and first + count <= m):
        raise ValueError(f"eigenvalue index range [{first}, {first + count}) out of [0, {m})")


def _f64(x):
    return np.ascontiguousarray(x, dtype=np.float64)


def tridiagonal_eigh(alpha, beta, *, eigvals_only: bool = False):
    """Implicit-shift QL eigensolver (eigenvalues ascending, one row per
    eigenvector); counterpart of the reference's self-contained QR backend
    (lambda_lanczos_tridiagonal_impl.hpp:290-343)."""
    global _UNCONVERGED_TOTAL
    lib = _require_lib()
    alpha, beta = _f64(alpha), _f64(beta)
    m = alpha.shape[0]
    _validate_tridiag(alpha, beta)
    eigvals = np.empty(m, dtype=np.float64)
    eigvecs = np.empty((m, m) if not eigvals_only else 0, dtype=np.float64)
    _UNCONVERGED_TOTAL += int(lib.lt_tridiagonal_eigh(alpha, beta, m, eigvals, eigvecs, int(not eigvals_only)))
    return (eigvals,) if eigvals_only else (eigvals, eigvecs)


def tridiagonal_eigvals_bisect(alpha, beta, first: int, count: int):
    """Sturm bisection: the eigenvalues with ascending indices [first,
    first + count)."""
    lib = _require_lib()
    alpha, beta = _f64(alpha), _f64(beta)
    _validate_tridiag(alpha, beta, first, count)
    out = np.empty(count, dtype=np.float64)
    lib.lt_tridiagonal_eigvals_bisect(alpha, beta, alpha.shape[0], first, count, out)
    return out


def tridiagonal_eigh_bisect(alpha, beta, first: int, count: int):
    """Bisection eigenpairs: the eigenvalues with ascending indices [first,
    first + count) and their backward-recurrence eigenvectors, one row each
    (lambda_lanczos_tridiagonal_impl.hpp:93-134)."""
    lib = _require_lib()
    alpha, beta = _f64(alpha), _f64(beta)
    m = alpha.shape[0]
    _validate_tridiag(alpha, beta, first, count)
    vals = np.empty(count, dtype=np.float64)
    vecs = np.empty((count, m), dtype=np.float64)
    lib.lt_tridiagonal_eigh_bisect(alpha, beta, m, first, count, vals, vecs)
    return vals, vecs


def pack_bsr(rows, cols, vals, n_col_blocks: int, bm: int, bk: int, *, dtype=np.float32):
    """COO -> BSR packing, duplicates summed in input order.  Returns
    ``(block_ids, blocks)``: ``block_ids[j] = row_block * n_col_blocks +
    col_block``, sorted ascending, and ``blocks`` of shape (nblocks, bm,
    bk) in ``dtype`` (float32 or float64)."""
    lib = _require_lib()
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"pack_bsr packs float32 or float64 blocks, not {dtype}")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=dtype)
    nnz = rows.shape[0]
    if rows.ndim != 1 or cols.shape != (nnz,) or vals.shape != (nnz,):
        raise ValueError(f"rows, cols and vals must be 1-D of one length, got {rows.shape}, {cols.shape}, {vals.shape}")
    if nnz and (min(rows.min(), cols.min()) < 0 or cols.max() >= n_col_blocks * bk):
        raise ValueError(f"COO indices out of range for {n_col_blocks} column blocks of {bk}")
    scratch = np.empty(nnz, dtype=np.int64)
    nblocks = lib.lt_bsr_count(rows, cols, nnz, bm, bk, n_col_blocks, scratch)
    block_ids = np.empty(nblocks, dtype=np.int64)
    blocks = np.empty((nblocks, bm, bk), dtype=dtype)
    fill = lib.lt_bsr_fill_f64 if dtype == np.float64 else lib.lt_bsr_fill_f32
    fill(rows, cols, vals, nnz, bm, bk, n_col_blocks, scratch, nblocks, block_ids, blocks)
    return block_ids, blocks
