"""Chebyshev-filtered Lanczos: extremal eigenpairs at huge n (port of
``lanczos_tpu.solvers.filtered``).

``filtered_lanczos`` wraps the operator in a
:class:`~lanczos_tpu_torch.ops.filters.ChebyshevFilterOperator`, runs the
deflation-driven thick-restart engine on the filtered operator B, where the
wanted mu-band is an exponentially separated top cluster (so the basis
stays a few dozen rows and reorthogonalization costs little), and recovers
A-space eigenpairs by a Rayleigh-Ritz over the converged B-space vectors.
``sigma=`` targets interior eigenvalues through
:class:`~lanczos_tpu_torch.ops.operators.ShiftSquaredOperator`.

The JAX package's double-float grams become float64 products of the cast
rows, and every projection here is a float64 product, so no float32 product
can take a TF32 path on the card.  ``precise=True`` runs the B-space solve
with ``precise_vectors`` over the filter's float64 chain
(``ChebyshevFilterOperator.matvec_f64``) and maps its Ritz values back
through the filter's analytic inverse; ``refine_vectors`` (on by default
with ``precise``) is the JAX package's ``_refine_vectors_df`` in float64:
filter-subspace sweeps on a steeper filter, block orthonormalization and a
Rayleigh-Ritz, all float64 products of ``matvec_f64``.
``checkpoint_path=`` saves the round state after every deflation round and
resumes from it, in the format of :mod:`lanczos_tpu_torch.utils.checkpoint`.

A row-partitioned operator (its ``ShardedDIAOperator`` or
``ShardedBSROperator``, or a shift-squared one over it) is solved by every
rank of its group together: the filter runs its unfused chain over the
sharded matvec (kernel K5 stays the route of a ``DIAOperator`` on one
device, as in the JAX package), the B-space engine reduces over the group
(:class:`_Filter` carries it), the Rayleigh-Ritz grams, the refinement's
grams and norms and the probe are all-reduced, the probe's start is the
one-process draw's slab, and the returned vectors are gathered to the
global n on every rank.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import scipy.linalg as sla
import torch

from ..diagnostics import (
    AccuracyWarning,
    BandCoverageWarning,
    BudgetExhaustedWarning,
    LanczosWarning,
    MissedCopyWarning,
    OverflowGuardWarning,
)
from ..ops.filters import ChebyshevFilterOperator
from ..core import linalg
from ..ops.operators import ShiftSquaredOperator, as_operator, float64_view
from ..parallel.sharded import draw_group, sharded_base
from ..utils import checkpoint, estimate
from ..utils.random import random_initializer
from . import lanczos as _lanczos

__all__ = ["filtered_lanczos"]


class _Filter(ChebyshevFilterOperator):
    """The filter with its base operator's process group (None on one
    device), so that the engines' reductions over a row-partitioned base
    go through it."""

    @property
    def group(self):
        return getattr(self.op, "group", None)


def _safe_bound(op) -> float:
    """Gershgorin where the entries are stored, the power bound otherwise."""
    try:
        return float(estimate.gershgorin_bound(op))
    except estimate._MatrixFreeError:
        return float(estimate.power_bound(op))


def _edge_estimate(op, find_maximum: bool) -> float:
    """Cheap plain-Lanczos estimate of the wanted spectral edge.

    Ritz values converge to the edge from inside the spectrum, the safe side
    for the filter window: a true edge left outside the damp window on the
    wanted side is amplified more, not less.  (The far side is the
    dangerous one; it gets the safe bound.)
    """
    from ..api import LambdaLanczos  # late import: api imports the solvers

    eng = LambdaLanczos(op, find_maximum=find_maximum, num_eigs=1)
    eng.eps = 1e-3
    eng.max_iteration = min(48, op.n)
    eng.max_restarts = 1
    with warnings.catch_warnings():
        # The 48-row cap is intended: a coarse edge is all the window needs.
        warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
        val, _ = eng.run_one()
    return float(val)


def _spectrum_bounds(op, lo, hi, find_maximum: bool):
    """Target side: a tight edge estimate; far side: a safe bound."""
    if lo is None:
        lo = _edge_estimate(op, False) if not find_maximum else -_safe_bound(op)
    if hi is None:
        hi = _safe_bound(op) if not find_maximum else _edge_estimate(op, True)
    return float(lo), float(hi)


def _rayleigh_ritz(op, V, num_eigs: int, find_maximum: bool):
    """A-space Rayleigh-Ritz over the rows of ``V``.

    The B-space Ritz values are no use as A eigenvalues, so A is projected
    onto the small converged subspace.  The grams S = V A V^T and G = V V^T
    are float64 products of the rows cast once, the k x k problem is solved
    on the host in float64, and the rotation and residuals reuse the cast
    rows (A(Y^T V) = Y^T (AV), no new matvecs).  Returns the best
    ``num_eigs`` values (engine order), their unit Ritz vectors in V's dtype
    and the A-space residual norms ||A q - theta q||.
    """
    group = getattr(op, "group", None)
    wide = torch.complex128 if V.is_complex() else torch.float64
    V64 = V.to(wide)
    AV64 = op.matvec_rows(V).to(wide)
    S = _gram(V64, AV64, group)
    G = _gram(V64, V64, group)
    theta, Y = sla.eigh(0.5 * (S + S.conj().T), 0.5 * (G + G.conj().T))
    order = np.argsort(theta) if not find_maximum else np.argsort(theta)[::-1]
    theta = theta[order][:num_eigs]
    Y = torch.as_tensor(np.ascontiguousarray(Y[:, order][:, :num_eigs]), device=V.device)
    Q = Y.T @ V64
    AQ = Y.T @ AV64
    norms = _row_norms(Q, group)[:, None]
    R = AQ / norms - torch.as_tensor(theta, device=V.device)[:, None] * (Q / norms)
    res = _row_norms(R, group).tolist()
    return theta, (Q / norms).to(V.dtype), res


def _row_norms(X, group=None):
    """The Euclidean norm of every row of ``X`` (over the ranks of ``group``
    for slab rows)."""
    return torch.sqrt(linalg.reduce_sum(torch.sum(X.abs() ** 2, dim=1), group))


def _whiten_coeffs(G):
    """Host float64 combination rows C with C G C^T = I, robust to a
    (near-)collapsed gram: inverse Cholesky when it is positive definite,
    eigen-whitening with a floored spectrum otherwise (a steep filter apply
    can align block rows to ~1e-17, and the gram then loses definiteness at
    float64 resolution)."""
    try:
        return np.linalg.inv(np.linalg.cholesky(G))
    except np.linalg.LinAlgError:
        w, E = np.linalg.eigh(0.5 * (G + G.conj().T))
        w = np.maximum(w, max(float(w.max()), 1.0) * 1e-28)
        return (E / np.sqrt(w)).conj().T


def _gram(X, Y, group=None):
    """The host matrix ``X^H Y^T`` of two row blocks (float64 products;
    summed over the ranks of ``group`` for slab rows)."""
    return linalg.reduce_sum(X.conj() @ Y.T, group).cpu().numpy()


def _rotate_rows(C, X, group=None):
    """Rows ``C @ X`` for host coefficients ``C``, each divided by its norm."""
    Y = torch.as_tensor(np.ascontiguousarray(C), device=X.device).to(X.dtype) @ X
    return Y / _row_norms(Y, group)[:, None].clamp_min(torch.finfo(torch.float64).tiny)


def _orthonormalize_block(X, group=None):
    """Block orthonormalization by the gram's whitening rows: keeps k
    independent directions through steep filter applies (plain row
    normalization lets the block collapse onto the most amplified one)."""
    G = _gram(X, X, group)
    return _rotate_rows(_whiten_coeffs(0.5 * (G + G.conj().T)), X, group)


def _refine_filter(base_op, lo, hi, mu, find_maximum):
    """A much steeper filter dedicated to vector refinement (the JAX
    package's).  The decay per sweep is T_p(contaminant)/T_p(target), and
    the dangerous contaminants are in-band states barely shallower than the
    targets; at the solve filter's d*theta ~ 3 that ratio is ~0.95.  Each
    sweep chains two normalized applies of a d*theta ~ 36 filter (the same
    d*theta <= 40 wall as the solve's: the norms square the amplified
    components), a degree capped at 2n (past ~n it buys nothing)."""
    e_half = 0.5 * ((hi - lo) - mu)
    theta = float(np.arccosh(1.0 + mu / max(e_half, mu)))
    d_cap = int(min(8192, max(64, 2 * int(getattr(base_op, "n", 8192)))))
    degree = int(np.clip(np.ceil(36.0 / max(theta, 1e-9)), 16, d_cap))
    degree = ((degree + 31) // 32) * 32
    if degree * theta > 40.0:
        degree = max(2, int(40.0 / max(theta, 1e-9)))
    degree = int(degree) + (int(degree) % 2)
    return _Filter.from_interval(base_op, degree, lo, hi, mu, find_maximum=find_maximum)


def _refine_vectors(op, fop, vecs, find_maximum, span, *, tol: float | None = None, max_sweeps: int = 8):
    """Push the returned Ritz vectors to float64-grade A-space residuals by
    filter-subspace iteration (the JAX package's ``_refine_vectors_df``,
    whose word-pair products are float64 products here).

    Each sweep is a Rayleigh-Ritz of A over the rows (grams of
    ``matvec_f64`` products, solved on the host), the rows rotated and
    normalized, their residuals, and, while the residuals exceed ``tol``
    (default ``1e-11 * max(span, 1)``), two applies of the refinement
    filter ``fop`` each followed by a block orthonormalization.  Returns
    ``(theta (k,) float64, X (k, n) float64 tensor, residuals, sweeps)``.
    """
    group = getattr(op, "group", None)
    X = vecs.to(torch.complex128 if vecs.is_complex() else torch.float64)
    if tol is None:
        tol = 1e-11 * max(float(span), 1.0)
    theta, res, sweeps = None, None, 0
    for sweep in range(max_sweeps):
        sweeps = sweep + 1
        AX = op.matvec_rows_f64(X)
        S = _gram(X, AX, group)
        G = _gram(X, X, group)
        S = 0.5 * (S + S.conj().T)
        G = 0.5 * (G + G.conj().T)
        try:
            theta_all, Y = sla.eigh(S, G)
        except np.linalg.LinAlgError:
            # a near-collapsed block: whiten explicitly and solve the
            # standard problem in the whitened coordinates
            W = _whiten_coeffs(G)
            M = W @ S @ W.conj().T
            theta_all, Z = np.linalg.eigh(0.5 * (M + M.conj().T))
            Y = W.conj().T @ Z
        order = np.argsort(theta_all)
        if find_maximum:
            order = order[::-1]
        theta = theta_all[order]
        X = _rotate_rows(Y[:, order].T, X, group)
        AX = op.matvec_rows_f64(X)
        res = _row_norms(AX - torch.as_tensor(theta, device=X.device)[:, None] * X, group).tolist()
        if max(res) <= tol:
            break
        if sweep < max_sweeps - 1:
            for _rep in range(2):
                X = _orthonormalize_block(fop.matvec_rows_f64(X), group)
    return np.asarray(theta, np.float64), X, res, sweeps


def _probe_remaining_band(fop, V, w0, steps: int) -> float:
    """Power-iterate the filter on a vector deflated against the held rows:
    the growth rate converges to the largest B-value among band directions
    not captured, the amplification of the best missed state.  Deflates
    every step (the leakage of captured band directions would regrow by b
    per step and fire falsely)."""
    group = getattr(fop, "group", None)
    V64 = V.to(torch.complex128 if V.is_complex() else torch.float64)
    w = w0
    r = torch.ones((), dtype=w0.dtype, device=w0.device)
    for _ in range(steps):
        bw = fop.matvec(w)
        coef = linalg.reduce_sum(V64.conj() @ bw.to(V64.dtype), group)
        bw = bw - (coef @ V64).to(bw.dtype)
        r = linalg.norm(bw, group)
        w = bw / r.clamp_min(1e-30)
    return float(r)


def _missed_copy_probe(fop, V, vals_b, theta_worst, margin, find_maximum, num_eigs) -> bool:
    """True when no missed band state beats the worst returned value.

    The stop_when_full path skips the reference's confirming deflation
    round, and a single Krylov start cannot see the second copy of a
    degenerate eigenvalue.  The deflated power iteration's growth rate r
    estimates the best missed state's B-value, and ``invert_value(r)`` its
    A-value; an extra round is due only when that beats ``theta_worst`` by
    more than ``margin``.  Underconvergence underestimates r, so weak
    amplification degrades to never firing, the safe direction.
    """
    b_kept = float(np.asarray(vals_b)[: max(num_eigs, 1)].min())
    n = fop.n
    steps = int(np.ceil(np.log(8.0 * np.sqrt(n)) / np.log(max(b_kept, 1.2))))
    steps = min(max(((steps + 3) // 4) * 4, 4), 32)
    # the global draw (the same on every rank), this rank's slab of it
    w0 = linalg.slab(torch.as_tensor(random_initializer(V.dtype, draw_group(fop))(n), device=V.device), V.shape[1], fop.group)
    r = _probe_remaining_band(fop, V, w0, steps)
    a_probe = float(np.asarray(fop.invert_value(np.asarray(r, np.float64))))
    if not np.isfinite(a_probe):
        return True
    if find_maximum:
        return not (a_probe > theta_worst + margin)
    return not (a_probe < theta_worst - margin)


def _auto_mu(op, num_eigs, find_maximum, lo, hi, guard):
    """Two-stage windowing: a coarse scout pass with a wide band (1% of the
    span, then 5% if its residuals say the targets fell outside) measures
    where the targets sit, and the band becomes 16x their distance from
    the edge, snapped to a factor-2 grid of the span (the scout's distance
    carries up to ~2x noise, and an unquantized mu feeds an unquantized
    degree)."""
    edge = lo if not find_maximum else hi
    span = hi - lo
    dist = None
    for frac in (0.01, 0.05):
        with warnings.catch_warnings():
            # the scout's own warnings are superseded by the ladder and the
            # main pass's checks
            warnings.simplefilter("ignore", LanczosWarning)
            vals0, _v0, i0 = filtered_lanczos(op, num_eigs, find_maximum, mu=frac * span, lo=lo, hi=hi, guard=guard)
        dist = max(abs(float(v) - edge) for v in np.asarray(vals0))
        bar0 = 0.5 * float(np.sqrt(frac * span * span))
        if max(i0["residuals"]) <= bar0 and dist <= 0.5 * frac * span:
            break
    mu = float(np.clip(16.0 * dist, 2.5e-6 * span, 0.05 * span))
    return float(span * 2.0 ** np.round(np.log2(mu / span)))


def _filtered_interior(op, num_eigs, *, sigma, degree, mu, lo, hi, guard, residual_bound, max_extra_rounds,
                       precise, refine_vectors, checkpoint_path, configure, device):
    """The ``num_eigs`` eigenvalues of A nearest an interior ``sigma``,
    through ``(A - sigma)^2``: "nearest sigma" becomes the bottom edge, with
    the exact lower bound 0.  sigma-symmetric pairs merge in the squared
    spectrum; the subspace still spans both A-eigenvectors, so a final
    A-space Rayleigh-Ritz splits them.  Returned nearest-sigma first.
    ``precise`` maps the squared values back as sigma + sign(theta - sigma)
    sqrt(v2), pairing each Rayleigh-Ritz theta with its nearest inverse
    value; ``refine_vectors`` refines against the squared operator's filter
    with the Rayleigh-Ritz of the base operator."""
    base = as_operator(op, device=device)
    if lo is None or hi is None:
        g = _safe_bound(base)
        lo = -g if lo is None else lo
        hi = g if hi is None else hi
    sq = ShiftSquaredOperator(base, float(sigma))
    hi2 = max((hi - sigma) ** 2, (sigma - lo) ** 2)
    if mu is None:
        # The static default (2.5e-6 of the span) is calibrated for an edge
        # cluster; interior spacings in squared units vary with sigma.
        mu = _auto_mu(sq, num_eigs, False, 0.0, float(hi2), guard)
    vals2, vecs, info = filtered_lanczos(
        sq, num_eigs, False, degree=degree, mu=mu, lo=0.0, hi=float(hi2), guard=guard,
        residual_bound=residual_bound, max_extra_rounds=max_extra_rounds, precise=precise,
        refine_vectors=False,  # refined below against the base operator
        checkpoint_path=checkpoint_path, configure=configure)
    sh = sharded_base(base)
    if sh is not None:  # the solve returns global rows; the Rayleigh-Ritz runs on slabs
        vecs = linalg.slab(vecs, sh.n_local, sh.group)
    theta, vecs_out, res = _rayleigh_ritz(base, vecs, num_eigs, False)
    order = np.argsort(np.abs(np.asarray(theta) - sigma))
    theta = np.asarray(theta)[order]
    vecs_out = vecs_out[torch.as_tensor(order, device=vecs_out.device)]
    res = [res[i] for i in order]
    if precise:
        v2 = np.asarray(vals2, np.float64)
        vals = np.empty(len(theta), np.float64)
        for j, t in enumerate(theta):
            k = int(np.argmin(np.abs(v2 - (t - sigma) ** 2)))
            vals[j] = sigma + np.sign(t - sigma) * np.sqrt(max(v2[k], 0.0))
        info["rr_values"] = [float(t) for t in theta]
    else:
        vals = theta
    if refine_vectors is None:
        refine_vectors = precise
    if refine_vectors:
        # The squared operator's filter amplifies this target's band; the
        # Rayleigh-Ritz against the base operator splits the sigma-symmetric
        # pairs.  The values are (near-)exact, so the band can hug the
        # targets: one ending at 2x the deepest target depth usually leaves
        # the next level outside, where it decays by the full band/damp
        # separation.
        max_v2 = float(np.max((np.asarray(vals, np.float64) - sigma) ** 2))
        mu_ref = min(float(info["mu"]), max(2.0 * max_v2, 1e-3 * float(info["mu"])))
        fop_sq = _refine_filter(sq, 0.0, float(hi2), mu_ref, find_maximum=False)
        theta_r, X, res_r, sweeps = _refine_vectors(base, fop_sq, vecs_out, False, hi - lo, max_sweeps=12)
        order_r = np.argsort(np.abs(theta_r - sigma))
        vals = theta_r[order_r]
        vecs_out = linalg.gather_rows(X[torch.as_tensor(order_r.copy(), device=X.device)], base).cpu().numpy()
        res = [res_r[i] for i in order_r]
        info["refine_sweeps"] = sweeps
    if not refine_vectors:
        vecs_out = linalg.gather_rows(vecs_out, base)
    info["sigma"] = float(sigma)
    info["residuals"] = res
    info["matvecs"] = 2 * int(info["matvecs"])  # each squared application is two base matvecs
    return np.asarray(vals), vecs_out, info


def filtered_lanczos(op, num_eigs: int = 1, find_maximum: bool = False, *,
                     degree: int | None = None, mu: float | None = None,
                     lo: float | None = None, hi: float | None = None,
                     guard: int = 0, residual_bound: float | None = None,
                     max_extra_rounds: int | None = None, precise: bool = False,
                     sigma: float | None = None, auto_window: bool | None = None,
                     refine_vectors: bool | None = None,
                     checkpoint_path=None, configure=None, device=None):
    """(eigenvalues, eigenvectors, info) at the wanted spectral edge.

    Parameters mirror ``lanczos_tpu.filtered_lanczos``.  ``mu`` is the
    amplified band's width, both the eigenvalue-error budget and the window
    that must contain every wanted eigenvalue (default ``2.5e-6 * (hi -
    lo)``).  ``degree`` is the filter degree (default: amplification
    exponent ~1.3 for the band, quantized up to 32, coerced even).
    ``lo``/``hi`` default to a plain-Lanczos estimate on the target side and
    a safe bound on the far side (``precise=True`` scouts the window unless
    ``auto_window=False``).  ``configure(engine)`` adjusts the B-space
    engine before it runs (``eng.operator.use_fused`` selects the fused
    chain, kernel K5 on the card, where it is the default).  ``guard`` oversamples the B-space
    solve by that many pairs and returns the best ``num_eigs`` after the
    final Rayleigh-Ritz.  Rounds are adaptive: after each deflation round
    the A-space residuals are checked against ``residual_bound`` (default
    ``0.5 * sqrt(mu * (hi - lo))``) for up to ``max_extra_rounds`` extra
    rounds (default ``num_eigs + 2``).  ``sigma`` targets the eigenvalues
    nearest an interior point through ``(A - sigma)^2``; ``auto_window``
    runs the scout-based band sizing (default: only with ``precise``).  An
    array or callable ``op`` becomes an operator on ``device`` (default:
    the CUDA card).

    ``precise=True`` returns reference-grade eigenvalues: the B-space solve
    runs with ``precise_vectors`` (a float64 basis over the filter's
    float64 chain; for a complex operator a complex128 basis over its
    float64 view) to a drift eps that the filter's steepness attenuates on
    the way back, and the values are the B Ritz values mapped through the
    filter's analytic inverse (``invert_value``); a value farther than 4 mu
    from its Rayleigh-Ritz value falls back to it with an
    ``AccuracyWarning`` (``info['rr_values']`` keeps the Rayleigh-Ritz
    values).  ``refine_vectors`` (default: ``precise``) refines the
    eigenvectors by float64 filter-subspace sweeps and returns them as host
    float64 rows (a numpy array), the JAX package's contract; a refined
    value replaces the returned one where its residual is at most 1e-8 of
    the spectral scale (``info`` gains ``refine_sweeps``,
    ``rr_values_refined`` and, with ``precise``, ``inverse_map_values``).

    Returns ascending eigenvalues (descending with ``find_maximum``,
    nearest-``sigma`` first with ``sigma``), eigenvectors as rows of a
    tensor on the operator's device, and ``info`` with ``iteration_counts``,
    ``filter_degree``, ``mu``, ``interval``, ``residuals`` and ``matvecs``.
    """
    from ..api import LambdaLanczos  # late import: api imports the solvers

    if sigma is not None:
        if find_maximum:
            raise ValueError("sigma (interior targets) and find_maximum are exclusive")
        return _filtered_interior(
            op, num_eigs, sigma=float(sigma), degree=degree, mu=mu, lo=lo, hi=hi, guard=guard,
            residual_bound=residual_bound, max_extra_rounds=max_extra_rounds, precise=precise,
            refine_vectors=refine_vectors, checkpoint_path=checkpoint_path, configure=configure, device=device)
    scout = auto_window if auto_window is not None else precise

    op = as_operator(op, device=device)
    if precise and op.dtype.is_complex:
        # precise_vectors takes real dtypes only: a complex operator reaches
        # the same grade through a complex128 basis over its float64 view.
        op = float64_view(op)
    lo, hi = _spectrum_bounds(op, lo, hi, find_maximum)
    if scout and mu is None:
        mu = _auto_mu(op, num_eigs, find_maximum, lo, hi, guard)
    if mu is None:
        mu = 2.5e-6 * (hi - lo)
    theta = float(np.arccosh(1.0 + 2.0 * mu / max((hi - lo) - mu, mu)))
    if degree is None:
        # Amplification exponent d*theta ~ 1.3 (the flagship's optimum:
        # d = 400 at mu = 1e-5 on a span of 4) and ~3 (cosh ~ 10) with
        # ``precise``, where band/bulk separation drives both the B-space
        # rate and the inverse map's attenuation; quantized up to a 32-grid
        # so that run-to-run jitter of a scouted mu gives few distinct
        # degrees.
        target_exp = 3.0 if precise else 1.3
        degree = int(np.clip(np.ceil(target_exp / max(theta, 1e-9)), 16, 2400))
        degree = ((degree + 31) // 32) * 32
    if degree * theta > 40.0:
        # The band tops out at cosh(d*theta) and the engine squares norms of
        # B-vectors: cap the exponent at 40 (1.2e17, squared below the
        # float32 maximum).
        clipped = max(2, int(40.0 / max(theta, 1e-9)))
        warnings.warn(
            f"filtered_lanczos: degree {degree} would amplify the mu-band to "
            f"cosh({degree * theta:.0f}) — beyond f32 range once squared; "
            f"clipping to {clipped} (widen mu or lower degree to silence)",
            OverflowGuardWarning,
            stacklevel=2,
        )
        degree = clipped
    # Even degree: T_p is +cosh on both sides outside the window, so the
    # band is a top cluster in B-space whichever edge is targeted.
    degree = int(degree) + (int(degree) % 2)

    fop = _Filter.from_interval(op, degree, lo, hi, mu, find_maximum=find_maximum)
    sharded = sharded_base(op)

    eng = LambdaLanczos(fop, find_maximum=True, num_eigs=num_eigs + max(int(guard), 0))
    # In B-space the band is a separated top cluster: a shallow basis and a
    # loose eps suffice (A-space accuracy comes from mu and the final
    # Rayleigh-Ritz).  The adaptive loop below decides how many rounds run.
    eng.eps = 1e-4
    eng.max_iteration = 48
    eng.max_restarts = 4
    if precise:
        # Inverse-map refinement: the B-space solve runs with a float64
        # basis to a drift eps_b, and its Ritz values map back through the
        # analytic inverse of the filter, which attenuates their error: a_err
        # <= eps_b * e * max(1, d theta_mu) / d^2 across the band, so the eps
        # below returns 1e-12 A values.  A deeper unrestarted basis than the
        # coarse mode's, bounded by 2^28 / n rows (512 at n = 4000).
        a_target = 1e-12
        e_half = 0.5 * ((hi - lo) - mu)  # window half-width
        theta_mu = float(np.arccosh(1.0 + mu / e_half))
        eng.precise_vectors = not op.dtype.is_complex
        eng.eps = max(1e-13, a_target * degree**2 / (e_half * 8.0 * max(1.0, degree * theta_mu)))
        eng.max_iteration = int(max(96, min(512, (1 << 28) // max(op.n, 1))))
        eng.max_restarts = 64
    # Each driver call stops as soon as the manager holds the wanted count:
    # the A-space residuals, not the B-space fixed point, govern the rounds.
    eng.stop_when_full = True
    eng.restart_policy = "thick"
    if configure is not None:
        configure(eng)

    # ---- B-space solve: adaptive deflation rounds over one manager ------
    # A pair whose A-space residual exceeds res_bar is a shallow or noise
    # copy: run one more deflated round and project again.  err ~ res^2 /
    # gap_eff with gap_eff ~ 0.75 (hi - lo) (the JAX package's n = 2^22
    # measurement), so res <= 0.5 sqrt(mu (hi - lo)) keeps errors ~mu/3.
    res_bar = float(residual_bound) if residual_bound is not None else float(0.5 * np.sqrt(mu * (hi - lo)))
    extra_cap = (num_eigs + 2) if max_extra_rounds is None else int(max_extra_rounds)
    # The manager's capacity exceeds the wanted count by extra_cap, so extra
    # rounds grow the Rayleigh-Ritz span (a high-B-value noise copy can never
    # be evicted by value, but a larger span demotes it past num_eigs);
    # stop_when_count grows by one whenever a round fails to improve the
    # worst residual by 1.5x.
    k_want = num_eigs + max(int(guard), 0)
    capacity = int(eng.num_eigs) + max(extra_cap, 0)
    eng.num_eigs = capacity
    cfg = eng._config().resolved(eng.dtype)
    cfg.stop_when_count = min(k_want, capacity)
    iterate_one, v0_rows, use_warm = eng._iterate_factory(cfg)
    manager = _lanczos.EigenPairManager(cfg.find_maximum, cfg.num_eigs)
    iter_counts: list[int] = []
    extra = 0
    prev_worst = np.inf
    skip_round = False
    if checkpoint_path is not None and os.path.exists(checkpoint.npz_path(checkpoint_path)):
        # Round-boundary resume: the adaptive loop's state is the B-space
        # manager and three loop scalars; a resumed run replays the checks
        # after the saved round (skip_round) before any new round.
        mgr_l, counts_l, extras_l = checkpoint.load_state(checkpoint_path, eng.dtype, device=fop.device,
                                                          with_extras=True, sharded=sharded)
        if mgr_l.num_eigs != capacity or mgr_l.find_maximum != cfg.find_maximum:
            raise ValueError(
                f"checkpoint at {checkpoint_path} was written for capacity={mgr_l.num_eigs}/"
                f"find_maximum={mgr_l.find_maximum}, this solve needs {capacity}/{cfg.find_maximum}: the "
                "num_eigs/guard/max_extra_rounds configuration changed; delete the file or restore the "
                "original parameters")
        manager, iter_counts = mgr_l, counts_l
        extra = int(extras_l.get("round", 0))
        prev_worst = float(extras_l.get("prev_worst", np.inf))
        cfg.stop_when_count = int(extras_l.get("stop_when_count", cfg.stop_when_count))
        skip_round = len(manager.pairs) > 0
    while True:
        if not skip_round:
            with warnings.catch_warnings():
                # B-space eps-convergence is not this solve's accuracy
                # contract, and degenerate band copies routinely exhaust the
                # B-space budget.
                warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
                _lanczos.deflation_driver(
                    iterate_one, cfg, eng._init_fn(), eng.dtype, device=fop.device,
                    v0_rows=v0_rows, use_warm_restarts=use_warm, manager=manager, iter_counts=iter_counts,
                    sharded=sharded,
                )
            if checkpoint_path is not None:
                checkpoint.save_state(checkpoint_path, manager, iter_counts,
                                      extra={"round": extra, "prev_worst": prev_worst,
                                             "stop_when_count": cfg.stop_when_count}, sharded=sharded)
        skip_round = False
        vals_b = np.asarray(manager.eigenvalues())
        V = torch.stack(manager.eigenvectors())
        theta, vecs_out, res = _rayleigh_ritz(op, V, num_eigs, find_maximum)
        worst = max(res)
        if extra >= extra_cap:
            break
        if worst <= res_bar:
            # The residuals passed, but a degenerate copy the Krylov space
            # never saw leaves no residual trace: the probe buys it a round.
            # Its margin covers the returned values' own error: ~mu/3, and
            # ~1e-6 of the span with ``precise`` (the inverse map makes the
            # values near-exact).
            margin = (1e-6 * (hi - lo)) if precise else mu
            if _missed_copy_probe(fop, V, vals_b, float(theta[num_eigs - 1]), margin, find_maximum, num_eigs):
                break
            cfg.stop_when_count = min(cfg.stop_when_count + 1, capacity)
        elif worst > prev_worst / 1.5:
            cfg.stop_when_count = min(cfg.stop_when_count + 1, capacity)
        prev_worst = worst
        extra += 1
    eng._iteration_counts = iter_counts
    if extra >= extra_cap and max(res) <= res_bar:
        # Out on the round cap with clean residuals, possibly without the
        # probe ever running: probe the final subspace once before warning.
        margin = (1e-6 * (hi - lo)) if precise else mu
        if not _missed_copy_probe(fop, V, vals_b, float(theta[num_eigs - 1]), margin, find_maximum, num_eigs):
            warnings.warn(
                "filtered_lanczos: the deflated band-weight probe detects a "
                f"missed band state after {extra} extra round(s) — a "
                "degenerate copy may be absent from the returned set; raise "
                "max_extra_rounds or check multiplicities",
                MissedCopyWarning,
                stacklevel=2,
            )
    if max(res) > res_bar:
        warnings.warn(
            f"filtered_lanczos: A-space residuals {[f'{r:.2g}' for r in res]} "
            f"still exceed the mu-scale bound {res_bar:.2g} after "
            f"{extra} extra deflation round(s) — eigenvalue errors may "
            f"exceed the ~mu budget; raise degree/mu or max_extra_rounds",
            AccuracyWarning,
            stacklevel=2,
        )
    # Scale-free band check: the damped bulk has |T_p| <= 1, so a returned
    # vector whose B-space value is not above it never lived in the band.
    # Only the best num_eigs gate the warning (guard pairs may be bulk).
    vals_b = [float(v) for v in vals_b]
    if any(v < 1.1 for v in vals_b[:num_eigs]):
        warnings.warn(
            f"filtered_lanczos: B-space Ritz values {[f'{v:.2g}' for v in vals_b]} "
            f"include entries at the damped-bulk level (|T_p| <= 1) — some wanted "
            f"eigenvalues likely lie OUTSIDE the amplified mu-band; raise mu to "
            f"cover the wanted spread (mu={mu:g}), raise degree for more "
            f"amplification, or lower num_eigs (check info['residuals'])",
            BandCoverageWarning,
            stacklevel=2,
        )
    info = {
        "iteration_counts": list(eng.iteration_counts),
        "filter_degree": degree,
        "mu": mu,
        "interval": (lo, hi),
        "residuals": res,
        "matvecs": int(sum(eng.iteration_counts)) * degree * max(int(eng.block_size), 1),
    }
    # theta is in engine order: ascending when minimizing, descending when
    # maximizing.
    vals = np.asarray([float(t) for t in theta])
    if precise:
        # Values from the analytic inverse of the float64-basis B Ritz
        # values; theta stays in info as the mu-grade cross-check.  A
        # disagreement beyond the mu budget means the pairing broke (a
        # bulk-level value, an unresolved cluster): warn and keep the
        # Rayleigh-Ritz value there.
        lam = np.asarray(fop.invert_value(vals_b[:num_eigs]), np.float64)
        info["rr_values"] = [float(t) for t in vals]
        bad = [i for i in range(len(lam)) if not np.isfinite(lam[i]) or abs(lam[i] - vals[i]) > 4.0 * mu]
        if bad:
            warnings.warn(
                f"filtered_lanczos(precise=True): inverse-map values at indices {bad} disagree with the "
                "Rayleigh-Ritz values beyond the mu budget (or fell below the bulk ceiling) — returning "
                "the RR values there; raise degree or tighten the window",
                AccuracyWarning,
                stacklevel=2,
            )
            for i in bad:
                lam[i] = vals[i]
        vals = lam
    if refine_vectors is None:
        refine_vectors = precise
    if refine_vectors:
        # Tighten the refinement band around the returned values: cutting
        # it at the deepest target + 0.8x the target spacing usually pushes
        # the next level outside the band, where it decays by the full
        # band/damp separation; degenerate targets keep a 1.3x-depth band.
        depth_max = float((hi - np.min(vals)) if find_maximum else (np.max(vals) - lo))
        gaps = np.diff(np.sort(vals))
        gap_est = float(np.max(gaps)) if gaps.size else 0.0
        mu_ref = float(mu)
        if depth_max > 0:
            mu_ref = min(mu_ref, depth_max + max(0.8 * gap_est, 0.3 * depth_max))
        fop_ref = _refine_filter(op, lo, hi, mu_ref, find_maximum)
        theta_r, X, res_r, sweeps = _refine_vectors(op, fop_ref, vecs_out, find_maximum, hi - lo)
        vecs_out = linalg.gather_rows(X, op).cpu().numpy()
        info["residuals"] = res_r
        info["refine_sweeps"] = sweeps
        info["rr_values_refined"] = [float(t) for t in theta_r]
        if precise:
            info["inverse_map_values"] = [float(v) for v in vals]
        # A refined Rayleigh-Ritz value carries err ~ res^2 / gap: adopt it
        # entry by entry where its residual supports it.
        scale = max(1.0, float(np.max(np.abs(theta_r))))
        vals = np.asarray(vals, np.float64).copy()
        for i in range(len(theta_r)):
            if res_r[i] <= 1e-8 * scale:
                vals[i] = theta_r[i]
    else:
        vecs_out = linalg.gather_rows(vecs_out, op)
    return vals, vecs_out, info
