"""Chebyshev-filtered Lanczos: extremal eigenpairs at huge n (port of
``lanczos_tpu.solvers.filtered`` without its precise parts).

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
can take a TF32 path on the card.  ``precise=True``, ``refine_vectors=True``
and ``checkpoint_path=`` raise: they need the precise engines,
``matvec_df`` and the checkpoint module (ROADMAP.md, module items 10 and 12).
"""

from __future__ import annotations

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
from ..ops.operators import ShiftSquaredOperator, as_operator
from ..parallel.sharded import refuse_sharded
from ..utils import estimate
from ..utils.random import random_initializer
from . import lanczos as _lanczos

__all__ = ["filtered_lanczos"]

_PRECISE_ITEM = "ROADMAP.md, module item 10 (precise paths on native float64)"
_CHECKPOINT_ITEM = "ROADMAP.md, module item 12 (checkpoint)"


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
    wide = torch.complex128 if V.is_complex() else torch.float64
    V64 = V.to(wide)
    AV64 = op.matvec_rows(V).to(wide)
    S = (V64.conj() @ AV64.T).cpu().numpy()
    G = (V64.conj() @ V64.T).cpu().numpy()
    theta, Y = sla.eigh(0.5 * (S + S.conj().T), 0.5 * (G + G.conj().T))
    order = np.argsort(theta) if not find_maximum else np.argsort(theta)[::-1]
    theta = theta[order][:num_eigs]
    Y = torch.as_tensor(np.ascontiguousarray(Y[:, order][:, :num_eigs]), device=V.device)
    Q = Y.T @ V64
    AQ = Y.T @ AV64
    norms = torch.linalg.vector_norm(Q, dim=1, keepdim=True)
    R = AQ / norms - torch.as_tensor(theta, device=V.device)[:, None] * (Q / norms)
    res = torch.linalg.vector_norm(R, dim=1).tolist()
    return theta, (Q / norms).to(V.dtype), res


def _probe_remaining_band(fop, V, w0, steps: int) -> float:
    """Power-iterate the filter on a vector deflated against the held rows:
    the growth rate converges to the largest B-value among band directions
    not captured, the amplification of the best missed state.  Deflates
    every step (the leakage of captured band directions would regrow by b
    per step and fire falsely)."""
    V64 = V.to(torch.complex128 if V.is_complex() else torch.float64)
    w = w0
    r = torch.ones((), dtype=w0.dtype, device=w0.device)
    for _ in range(steps):
        bw = fop.matvec(w)
        coef = V64.conj() @ bw.to(V64.dtype)
        bw = bw - (coef @ V64).to(bw.dtype)
        r = torch.linalg.vector_norm(bw)
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
    n = V.shape[1]
    steps = int(np.ceil(np.log(8.0 * np.sqrt(n)) / np.log(max(b_kept, 1.2))))
    steps = min(max(((steps + 3) // 4) * 4, 4), 32)
    w0 = torch.as_tensor(random_initializer(V.dtype)(n), device=V.device)
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
                       configure, device):
    """The ``num_eigs`` eigenvalues of A nearest an interior ``sigma``,
    through ``(A - sigma)^2``: "nearest sigma" becomes the bottom edge, with
    the exact lower bound 0.  sigma-symmetric pairs merge in the squared
    spectrum; the subspace still spans both A-eigenvectors, so a final
    A-space Rayleigh-Ritz splits them.  Returned nearest-sigma first."""
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
    _vals2, vecs, info = filtered_lanczos(
        sq, num_eigs, False, degree=degree, mu=mu, lo=0.0, hi=float(hi2), guard=guard,
        residual_bound=residual_bound, max_extra_rounds=max_extra_rounds, configure=configure)
    theta, vecs_out, res = _rayleigh_ritz(base, vecs, num_eigs, False)
    order = np.argsort(np.abs(np.asarray(theta) - sigma))
    info["sigma"] = float(sigma)
    info["residuals"] = [res[i] for i in order]
    info["matvecs"] = 2 * int(info["matvecs"])  # each squared application is two base matvecs
    return np.asarray(theta)[order], vecs_out[torch.as_tensor(order, device=vecs_out.device)], info


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
    a safe bound on the far side.  ``configure(engine)`` adjusts the B-space
    engine before it runs (``eng.operator.use_fused = True`` selects the
    fused chain, kernel K5 on the card).  ``guard`` oversamples the B-space
    solve by that many pairs and returns the best ``num_eigs`` after the
    final Rayleigh-Ritz.  Rounds are adaptive: after each deflation round
    the A-space residuals are checked against ``residual_bound`` (default
    ``0.5 * sqrt(mu * (hi - lo))``) for up to ``max_extra_rounds`` extra
    rounds (default ``num_eigs + 2``).  ``sigma`` targets the eigenvalues
    nearest an interior point through ``(A - sigma)^2``; ``auto_window``
    runs the scout-based band sizing (default off).  An array or callable
    ``op`` becomes an operator on ``device`` (default: the CUDA card).

    Returns ascending eigenvalues (descending with ``find_maximum``,
    nearest-``sigma`` first with ``sigma``), eigenvectors as rows of a
    tensor on the operator's device, and ``info`` with ``iteration_counts``,
    ``filter_degree``, ``mu``, ``interval``, ``residuals`` and ``matvecs``.
    """
    from ..api import LambdaLanczos  # late import: api imports the solvers

    refuse_sharded(op, "filtered_lanczos")
    if precise or refine_vectors:
        raise NotImplementedError(f"precise=True and refine_vectors=True are not ported; see {_PRECISE_ITEM}")
    if checkpoint_path is not None:
        raise NotImplementedError(f"checkpoint_path is not ported; see {_CHECKPOINT_ITEM}")
    if sigma is not None:
        if find_maximum:
            raise ValueError("sigma (interior targets) and find_maximum are exclusive")
        return _filtered_interior(
            op, num_eigs, sigma=float(sigma), degree=degree, mu=mu, lo=lo, hi=hi, guard=guard,
            residual_bound=residual_bound, max_extra_rounds=max_extra_rounds, configure=configure, device=device)

    op = as_operator(op, device=device)
    lo, hi = _spectrum_bounds(op, lo, hi, find_maximum)
    if auto_window and mu is None:
        mu = _auto_mu(op, num_eigs, find_maximum, lo, hi, guard)
    if mu is None:
        mu = 2.5e-6 * (hi - lo)
    theta = float(np.arccosh(1.0 + 2.0 * mu / max((hi - lo) - mu, mu)))
    if degree is None:
        # Amplification exponent d*theta ~ 1.3 (the flagship's optimum:
        # d = 400 at mu = 1e-5 on a span of 4), quantized up to a 32-grid so
        # that run-to-run jitter of a scouted mu gives few distinct degrees.
        degree = int(np.clip(np.ceil(1.3 / max(theta, 1e-9)), 16, 2400))
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

    fop = ChebyshevFilterOperator.from_interval(op, degree, lo, hi, mu, find_maximum=find_maximum)

    eng = LambdaLanczos(fop, find_maximum=True, num_eigs=num_eigs + max(int(guard), 0))
    # In B-space the band is a separated top cluster: a shallow basis and a
    # loose eps suffice (A-space accuracy comes from mu and the final
    # Rayleigh-Ritz).  The adaptive loop below decides how many rounds run.
    eng.eps = 1e-4
    eng.max_iteration = 48
    eng.max_restarts = 4
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
    while True:
        with warnings.catch_warnings():
            # B-space eps-convergence is not this solve's accuracy contract,
            # and degenerate band copies routinely exhaust the B-space budget.
            warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
            _lanczos.deflation_driver(
                iterate_one, cfg, eng._init_fn(), eng.dtype, device=fop.device,
                v0_rows=v0_rows, use_warm_restarts=use_warm, manager=manager, iter_counts=iter_counts,
            )
        vals_b = np.asarray(manager.eigenvalues())
        V = torch.stack(manager.eigenvectors())
        theta, vecs_out, res = _rayleigh_ritz(op, V, num_eigs, find_maximum)
        worst = max(res)
        if extra >= extra_cap:
            break
        if worst <= res_bar:
            # The residuals passed, but a degenerate copy the Krylov space
            # never saw leaves no residual trace: the probe buys it a round.
            # Its margin covers the returned values' own error, ~mu/3.
            if _missed_copy_probe(fop, V, vals_b, float(theta[num_eigs - 1]), mu, find_maximum, num_eigs):
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
        if not _missed_copy_probe(fop, V, vals_b, float(theta[num_eigs - 1]), mu, find_maximum, num_eigs):
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
    return np.asarray([float(t) for t in theta]), vecs_out, info
