"""Carry the JAX package's state into the port.

Everything here takes numpy arrays and plain Python values, never JAX
objects (``np.asarray`` of a JAX array gives one), so the port never imports
JAX.  The tests build both packages' problems from the same arrays with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import from_numpy
from .ops.filters import ChebyshevFilterOperator
from .ops.hermitian_split import HermitianSplitOperator
from .ops.operators import (
    BSROperator,
    COOOperator,
    CSROperator,
    DenseDFOperator,
    DenseOperator,
    DIAOperator,
    ShiftInvertOperator,
    resolve_device,
)
from .parallel.sharded import ShardedBSROperator, ShardedDIAOperator
from .solvers.lanczos import LanczosConfig

__all__ = [
    "bsr_operator_from_arrays",
    "coo_operator_from_arrays",
    "csr_operator_from_arrays",
    "dense_operator_from_array",
    "dia_operator_from_arrays",
    "chebyshev_filter_from_arrays",
    "hermitian_split_from_arrays",
    "shift_invert_from",
    "sharded_bsr_operator_from_arrays",
    "sharded_dia_operator_from_arrays",
    "config_from_dict",
]


def bsr_operator_from_arrays(blocks, col_blocks, n: int, layout: str, device=None) -> BSROperator:
    """A :class:`BSROperator` from ``lanczos_tpu.BSROperator``'s ``blocks``,
    ``col_blocks``, ``n`` and ``layout``.  Canonical ``rsmk`` tiles
    (R, S, bm, bk) are transposed once to the ``rmsk`` layout the port
    stores; the values are unchanged (bfloat16 tiles too: their bits are
    carried, :func:`~lanczos_tpu_torch.core.types.from_numpy`)."""
    blocks = np.asarray(blocks)
    if layout == "rsmk":
        blocks = np.moveaxis(blocks, 2, 1)
    elif layout != "rmsk":
        raise ValueError(f"layout must be 'rmsk' or 'rsmk', got {layout!r}")
    # from_numpy copies: the arrays of a JAX package operator are read-only.
    device = resolve_device(device)
    blocks = from_numpy(blocks)
    col_blocks = torch.from_numpy(np.array(col_blocks, dtype=np.int32, order="C"))
    return BSROperator(blocks.to(device), col_blocks.to(device), int(n))


def coo_operator_from_arrays(rows, cols, vals, n: int, device=None) -> COOOperator:
    """A :class:`COOOperator` from ``lanczos_tpu.COOOperator``'s ``rows``,
    ``cols``, ``vals`` and ``n`` (indices become int64)."""
    return COOOperator.from_arrays(np.array(rows), np.array(cols), np.array(vals), int(n), device=device)


def csr_operator_from_arrays(indptr, indices, data, n: int, device=None) -> CSROperator:
    """A :class:`CSROperator` from ``lanczos_tpu.CSROperator``'s ``indptr``,
    ``indices``, ``data`` and ``n``; ``row_of_nnz`` is derived again."""
    return CSROperator.from_arrays(np.array(indptr), np.array(indices), np.array(data), int(n), device=device)


def dense_operator_from_array(a, device=None) -> DenseOperator:
    """A :class:`DenseOperator` from a square array."""
    return DenseOperator(torch.from_numpy(np.array(a, order="C")), device=device)


def dia_operator_from_arrays(offsets, data, n: int, device=None) -> DIAOperator:
    """A :class:`DIAOperator` from ``lanczos_tpu.DIAOperator``'s ``offsets``,
    ``data`` (ndiag, n) and ``n``."""
    data = torch.from_numpy(np.array(data, order="C"))
    return DIAOperator(offsets, data.to(resolve_device(device)), int(n))


def chebyshev_filter_from_arrays(offsets, data, n: int, c, e, degree: int, side: int, use_fused: bool,
                                 device=None) -> ChebyshevFilterOperator:
    """A :class:`ChebyshevFilterOperator` over a DIA operator from the
    values of a ``lanczos_tpu`` ChebyshevFilterOperator: its base's
    ``offsets``, ``data`` and ``n``, and ``c``, ``e``, ``degree``, ``side``
    and ``use_fused`` as plain values (``float(fop.c)``)."""
    op = dia_operator_from_arrays(offsets, data, n, device=device)
    return ChebyshevFilterOperator(op, float(c), float(e), int(degree), side=int(side), use_fused=bool(use_fused))


def _part(kind: str, arrays, device):
    """One part of a carried split operator: ``kind`` names the JAX
    operator class and ``arrays`` its arrays (as the matching
    ``*_from_arrays`` function takes them, the dense ones the matrix)."""
    if kind == "dense":
        return dense_operator_from_array(arrays[0], device=device)
    if kind == "dense_df":
        return DenseDFOperator.from_f64(np.array(arrays[0], np.float64), device=device)
    if kind == "bsr":
        return bsr_operator_from_arrays(*arrays, device=device)
    if kind == "dia":
        return dia_operator_from_arrays(*arrays, device=device)
    raise ValueError(f"kind must be 'dense', 'dense_df', 'bsr' or 'dia', got {kind!r}")


def hermitian_split_from_arrays(kind: str, real_arrays, imag_arrays=None, device=None) -> HermitianSplitOperator:
    """A :class:`~lanczos_tpu_torch.ops.hermitian_split.HermitianSplitOperator`
    from the arrays of a ``lanczos_tpu`` HermitianSplitOperator's parts:
    ``kind`` is the parts' operator class ('dense' and 'dense_df' take
    ``(matrix,)``, the float64 matrix of a DenseDFOperator for the latter;
    'bsr' ``(blocks, col_blocks, n, layout)``; 'dia' ``(offsets, data,
    n)``), ``real_arrays`` those of ``op_r`` and ``imag_arrays`` those of
    ``op_i`` (None for a real symmetric operator)."""
    op_i = None if imag_arrays is None else _part(kind, imag_arrays, device)
    return HermitianSplitOperator(_part(kind, real_arrays, device), op_i)


def shift_invert_from(operator, sigma, inner_tol: float = 1e-8, inner_maxiter: int = 500) -> ShiftInvertOperator:
    """A :class:`~lanczos_tpu_torch.ops.operators.ShiftInvertOperator` over
    a port operator (carried with the functions above) from the values of
    a ``lanczos_tpu`` ShiftInvertOperator: ``float(op.sigma)``,
    ``op.inner_tol`` and ``op.inner_maxiter``."""
    return ShiftInvertOperator(operator, float(sigma), float(inner_tol), int(inner_maxiter))


def sharded_bsr_operator_from_arrays(blocks, col_blocks, n: int, mesh, comm: str = "gather") -> ShardedBSROperator:
    """This rank's :class:`~lanczos_tpu_torch.parallel.sharded.ShardedBSROperator`
    from ``lanczos_tpu.parallel.sharded.ShardedBSROperator``'s global
    ``blocks`` (canonical ``rsmk``) and ``col_blocks`` and its ``n``; the
    JAX operator's mesh has as many devices as ``mesh`` has ranks, so the
    padding and the row slabs are the same.  ``comm`` is resolved again
    from the arrays, by the JAX package's rules; bfloat16 tiles keep their
    bits."""
    return ShardedBSROperator.from_blocks(np.asarray(blocks), np.asarray(col_blocks), int(n), mesh, comm=comm)


def sharded_dia_operator_from_arrays(offsets, data, n: int, mesh) -> ShardedDIAOperator:
    """This rank's :class:`~lanczos_tpu_torch.parallel.sharded.ShardedDIAOperator`
    from ``lanczos_tpu.parallel.sharded.ShardedDIAOperator``'s ``offsets``,
    global ``data`` (ndiag, n) and ``n``."""
    data = np.asarray(data)
    return ShardedDIAOperator.from_diagonals(offsets, list(data), int(n), mesh)


def config_from_dict(d: dict) -> LanczosConfig:
    """A :class:`LanczosConfig` from ``dataclasses.asdict`` of a
    ``lanczos_tpu`` LanczosConfig (the field names are the same)."""
    return LanczosConfig(**d)
