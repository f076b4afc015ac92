"""Spectral-bound estimators for choosing ``eigenvalue_offset`` and the
filter window (port of ``lanczos_tpu.utils.estimate``).

Reference counterpart: the demo
src/determine_eigenvalue_offset/determine_eigenvalue_offset.cpp:12-49,
``max_i sum_j |a_ij|`` (the infinity-norm Gershgorin bound).  Here it is a
function over the port's operators, plus a matrix-free power-iteration
bound for operators whose entries are not stored.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.linalg import norm
from ..ops.operators import LinearOperator, ScaledOperator, ShiftSquaredOperator, SumOperator
from ..parallel.sharded import sharded_base

__all__ = ["gershgorin_bound", "power_bound", "suggest_eigenvalue_offset"]


class _MatrixFreeError(TypeError):
    """The operator's entries are not stored: use power_bound()."""


def gershgorin_bound(op) -> float:
    """``max_i sum_j |a_ij|``: every eigenvalue satisfies |lambda| <= bound.

    Takes a square array or a Dense, COO, CSR, DIA or BSR operator, their
    row-partitioned forms (every rank of the group calls it: one
    all-reduce), Sum and Scaled compositions of those (by the triangle
    inequality: still a bound), and a :class:`ShiftSquaredOperator` over
    one of those, whose eigenvalues (lambda - sigma)^2 are at most
    (bound(A) + |sigma|)^2.
    Raises ``_MatrixFreeError`` (a ``TypeError``) for other operators.
    """
    if isinstance(op, SumOperator):
        return float(sum(gershgorin_bound(t) for t in op.terms))
    elif isinstance(op, ScaledOperator):
        return abs(float(op.scale)) * gershgorin_bound(op.base) + abs(float(op.shift))
    elif isinstance(op, ShiftSquaredOperator):
        return (gershgorin_bound(op.base) + abs(op.sigma)) ** 2
    elif isinstance(op, LinearOperator):
        sums = op.abs_row_sums()
        if sums is None:
            raise _MatrixFreeError("matrix-free operator: use power_bound() instead")
        group = getattr(op, "group", None)
        if group is None:
            return float(sums.max())
        # Row-partitioned: this rank's rows, the largest sum over the group.
        best = torch.zeros(1, dtype=torch.float64, device=sums.device)
        if sums.numel():
            best[0] = sums.max().to(torch.float64)
        dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
        return float(best[0])
    return float(torch.as_tensor(np.asarray(op)).abs().sum(dim=1).max())


def power_bound(op: LinearOperator, *, iters: int = 30, seed: int = 0, safety: float = 1.1) -> float:
    """Matrix-free bound on the spectral radius by power iteration:
    ``safety * max_k ||A v_k|| / ||v_k||``, which approaches ||A||_2 from
    below.  The start vector is numpy's ``default_rng(seed)`` normal draw,
    the JAX function's, so the two agree."""
    n = op.n
    group = getattr(op, "group", None)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(n), device=op.device).to(op.dtype)
    if group is not None:  # a row-partitioned operator: this rank's slab of the same draw
        v = sharded_base(op).scatter(v)
    v = v / norm(v, group)
    best = 0.0
    for _ in range(iters):
        w = op.matvec(v)
        nw = float(norm(w, group))
        best = max(best, nw)
        if nw == 0.0:
            break
        v = w / nw
    return best * safety


def suggest_eigenvalue_offset(op, find_maximum: bool) -> float:
    """Offset that pushes the wanted end of the spectrum to the largest
    magnitude: +bound when maximizing, -bound when minimizing."""
    try:
        bound = gershgorin_bound(op)
    except _MatrixFreeError:
        # Only matrix-free operators take the power bound (an estimate from
        # below); other errors propagate.
        bound = power_bound(op)
    return bound if find_maximum else -bound
