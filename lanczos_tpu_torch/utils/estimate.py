"""Spectral-bound estimators for choosing ``eigenvalue_offset`` and the
filter window (port of ``lanczos_tpu.utils.estimate``).

Reference counterpart: the demo
src/determine_eigenvalue_offset/determine_eigenvalue_offset.cpp:12-49,
``max_i sum_j |a_ij|`` (the infinity-norm Gershgorin bound).  Here it is a
function over the port's operators, plus a matrix-free power-iteration
bound for operators whose entries are not stored.  The COO, CSR, Sum and
Scaled branches of the JAX function wait for those operators (ROADMAP.md,
module item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.linalg import norm
from ..ops.operators import BSROperator, DenseOperator, DIAOperator, LinearOperator, ShiftSquaredOperator

__all__ = ["gershgorin_bound", "power_bound", "suggest_eigenvalue_offset"]


class _MatrixFreeError(TypeError):
    """The operator's entries are not stored: use power_bound()."""


def gershgorin_bound(op) -> float:
    """``max_i sum_j |a_ij|``: every eigenvalue satisfies |lambda| <= bound.

    Takes a square array or a Dense, DIA or BSR operator, and a
    :class:`ShiftSquaredOperator` over one of those, whose eigenvalues
    (lambda - sigma)^2 are at most (bound(A) + |sigma|)^2.  Raises
    ``_MatrixFreeError`` (a ``TypeError``) for other operators.
    """
    if isinstance(op, DenseOperator):
        a = op.a
    elif isinstance(op, DIAOperator):
        # |row sums| over the stored rows (off-matrix entries are zero in
        # the port's DIAOperator), accumulated in float64.  A bound must
        # never underestimate: float32 data keeps the JAX package's few-ulp
        # inflation of the float64 sum.
        total = torch.zeros(op.n, dtype=torch.float64, device=op.device)
        for j in range(len(op.offsets)):
            total = total + op.data[j].abs().to(torch.float64)
        pad = 1.0 + 8.0 * float(torch.finfo(torch.float64).eps) if op.dtype == torch.float32 else 1.0
        return float(total.max()) * pad
    elif isinstance(op, BSROperator):
        # |row sums| of the rmsk tiles (R, bm, S, bk) over (S, bk); padding
        # tiles are zero.
        sums = op.blocks.abs().sum(dim=(2, 3)).reshape(-1)
        return float(sums[: op.n].max())
    elif isinstance(op, ShiftSquaredOperator):
        return (gershgorin_bound(op.base) + abs(op.sigma)) ** 2
    elif isinstance(op, LinearOperator):
        raise _MatrixFreeError("matrix-free operator: use power_bound() instead")
    else:
        a = torch.as_tensor(np.asarray(op))
    return float(a.abs().sum(dim=1).max())


def power_bound(op: LinearOperator, *, iters: int = 30, seed: int = 0, safety: float = 1.1) -> float:
    """Matrix-free bound on the spectral radius by power iteration:
    ``safety * max_k ||A v_k|| / ||v_k||``, which approaches ||A||_2 from
    below.  The start vector is numpy's ``default_rng(seed)`` normal draw,
    the JAX function's, so the two agree."""
    n = op.n
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(n), device=op.device).to(op.dtype)
    v = v / norm(v)
    best = 0.0
    for _ in range(iters):
        w = op.matvec(v)
        nw = float(norm(w))
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
