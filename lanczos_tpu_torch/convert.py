"""Carry the JAX package's state into the port.

Everything here takes numpy arrays and plain Python values, never JAX
objects (``np.asarray`` of a JAX array gives one), so the port never imports
JAX.  The tests build both packages' problems from the same arrays with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.filters import ChebyshevFilterOperator
from .ops.operators import BSROperator, DenseOperator, DIAOperator, resolve_device
from .parallel.sharded import ShardedBSROperator, ShardedDIAOperator
from .solvers.lanczos import LanczosConfig

__all__ = [
    "bsr_operator_from_arrays",
    "dense_operator_from_array",
    "dia_operator_from_arrays",
    "chebyshev_filter_from_arrays",
    "sharded_bsr_operator_from_arrays",
    "sharded_dia_operator_from_arrays",
    "config_from_dict",
]


def bsr_operator_from_arrays(blocks, col_blocks, n: int, layout: str, device=None) -> BSROperator:
    """A :class:`BSROperator` from ``lanczos_tpu.BSROperator``'s ``blocks``,
    ``col_blocks``, ``n`` and ``layout``.  Canonical ``rsmk`` tiles
    (R, S, bm, bk) are transposed once to the ``rmsk`` layout the port
    stores; the values are unchanged."""
    blocks = np.asarray(blocks)
    if layout == "rsmk":
        blocks = np.moveaxis(blocks, 2, 1)
    elif layout != "rmsk":
        raise ValueError(f"layout must be 'rmsk' or 'rsmk', got {layout!r}")
    # np.array copies: the arrays of a JAX package operator are read-only.
    device = resolve_device(device)
    blocks = torch.from_numpy(np.array(blocks, order="C"))
    col_blocks = torch.from_numpy(np.array(col_blocks, dtype=np.int32, order="C"))
    return BSROperator(blocks.to(device), col_blocks.to(device), int(n))


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


def sharded_bsr_operator_from_arrays(blocks, col_blocks, n: int, mesh, comm: str = "gather") -> ShardedBSROperator:
    """This rank's :class:`~lanczos_tpu_torch.parallel.sharded.ShardedBSROperator`
    from ``lanczos_tpu.parallel.sharded.ShardedBSROperator``'s global
    ``blocks`` (canonical ``rsmk``) and ``col_blocks`` and its ``n``; the
    JAX operator's mesh has as many devices as ``mesh`` has ranks, so the
    padding and the row slabs are the same.  ``comm`` is resolved again
    from the arrays, by the JAX package's rules."""
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
