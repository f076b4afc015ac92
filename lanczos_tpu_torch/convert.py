"""Carry the JAX package's state into the port.

Everything here takes numpy arrays and plain Python values, never JAX
objects (``np.asarray`` of a JAX array gives one), so the port never imports
JAX.  The tests build both packages' problems from the same arrays with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.operators import BSROperator, DenseOperator
from .solvers.lanczos import LanczosConfig

__all__ = ["bsr_operator_from_arrays", "dense_operator_from_array", "config_from_dict"]


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
    blocks = torch.from_numpy(np.array(blocks, order="C"))
    col_blocks = torch.from_numpy(np.array(col_blocks, dtype=np.int32, order="C"))
    return BSROperator(blocks.to(device), col_blocks.to(device), int(n))


def dense_operator_from_array(a, device=None) -> DenseOperator:
    """A :class:`DenseOperator` from a square array."""
    return DenseOperator(torch.from_numpy(np.array(a, order="C")), device=device)


def config_from_dict(d: dict) -> LanczosConfig:
    """A :class:`LanczosConfig` from ``dataclasses.asdict`` of a
    ``lanczos_tpu`` LanczosConfig (the field names are the same)."""
    return LanczosConfig(**d)
