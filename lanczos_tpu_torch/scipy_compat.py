"""scipy.sparse.linalg-compatible facade (port of ``lanczos_tpu.scipy_compat``).

Users coming from ``scipy.sparse.linalg.eigsh``, ``expm_multiply`` and
``minres`` get the same call shapes backed by the port's engines, with
numpy in and numpy out.  A numpy array, a scipy.sparse matrix or a tensor
becomes an operator on ``device`` (default: the CUDA card; ``device="cpu"``
for the CPU), as the port's other entry points do; an operator keeps its
own device.

Complex Hermitian input is solved natively on a complex operator (kernels
K1 and K3 in their complex instances on the card), where the JAX package
embeds it as a real 2n problem and folds the doubled pairs.  Four faults
of the JAX facade are repaired here (ROADMAP.md queue 3):

* R1: a tight or default tolerance sent complex input to the filtered
  path, whose mu clip could leave the wanted values in the damped bulk
  (k = 2 smallest of an n = 24 random Hermitian: -2.48 where -7.55 is
  right).  Here complex input runs the plain engines on the complex
  operator, in complex128 (over ``float64_view`` for complex64 entries)
  at tight or default tolerances.
* R2: ``method='filtered'`` returned values with O(1) residuals behind a
  ``BandCoverageWarning``.  ``filtered_lanczos`` keeps that contract; here
  an end whose pairs are flagged, or whose residuals exceed the filtered
  solve's own bar, is solved again by the plain engines with an
  ``AccuracyWarning``.
* R3 is a test bar (complex ``expm_multiply`` against scipy at the
  reference's 2.2e-14).
* R4: ``eigsh(sigma=)`` on complex Hermitian input raised; here it runs
  :class:`~lanczos_tpu_torch.ops.operators.ShiftInvertOperator` over the
  complex operator with the complex MINRES.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .api import Exponentiator, LambdaLanczos
from .core.types import machine_eps, real_dtype
from .diagnostics import AccuracyWarning, BandCoverageWarning
from .ops.hermitian_split import HermitianSplitOperator
from .ops.operators import CSROperator, DenseOperator, LinearOperator, ShiftInvertOperator, as_operator, float64_view

__all__ = ["eigsh", "expm_multiply", "minres"]


def _check_hermitian(h) -> None:
    scale = max(1.0, float(abs(h).max())) if h.shape[0] else 1.0
    if float(abs(h - h.conj().T).max()) > 1e-6 * scale:
        raise ValueError("complex input must be Hermitian (A == A.conj().T)")


def _as_engine_operand(a, device=None) -> LinearOperator:
    """``a`` as an operator: an operator as it is (a
    ``HermitianSplitOperator`` as its native complex operator), a
    scipy.sparse matrix as a ``CSROperator``, an array or tensor as a
    ``DenseOperator``; complex input must be Hermitian."""
    if isinstance(a, HermitianSplitOperator):
        return a.complex_operator()
    if isinstance(a, LinearOperator):
        return a
    import scipy.sparse as sp

    if sp.issparse(a):
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"operator must be square, got shape {a.shape}")
        if np.iscomplexobj(a):
            _check_hermitian(a.tocsr())
        return CSROperator.from_scipy(a, device=device)
    if isinstance(a, torch.Tensor):
        return as_operator(a, device=device)
    h = np.asarray(a)
    if h.ndim != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"operator must be square, got shape {h.shape}")
    if np.iscomplexobj(h):
        _check_hermitian(h)
    return DenseOperator(h, device=device)


def _tight(tol) -> bool:
    return tol is None or tol == 0 or 0 < float(tol) <= 1e-8


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _configure(engine_kwargs):
    """Engine keyword arguments as attributes of the engine; an unknown
    name raises ``TypeError``."""
    def cfg(eng):
        for key, val in engine_kwargs.items():
            if not hasattr(eng, key):
                raise TypeError(f"unknown engine option {key!r}")
            setattr(eng, key, val)
    return cfg


def _one_end(operand, k, find_maximum, v0, maxiter, tol, engine_kwargs, *, want_vecs: bool = True):
    eng = LambdaLanczos(operand, find_maximum=find_maximum, num_eigs=int(k))
    if maxiter is not None:
        eng.max_iteration = int(maxiter)
    if tol is not None and tol > 0:
        eng.eps = float(tol)
    # tol = 0 (scipy: machine precision) keeps the engine's default, 1e3
    # machine epsilons of relative change: the fused engine compares
    # Sturm-multisected Ritz values between checks, which move in their
    # last bits, so a test at machine_eps itself never passes there and
    # the build runs to n (the JAX facade's mapping; on the H100 it grew
    # the basis of an n = 65536 complex128 solve to 64 GiB).
    if v0 is not None:
        eng.init_vector = np.asarray(v0)
    _configure(engine_kwargs)(eng)
    vals, vecs = eng.run()
    return np.asarray(vals, np.float64), (_host(vecs) if want_vecs else None)


def _join(lo, hi):
    """Two ends' values or vectors in one array (None without vectors)."""
    return None if lo is None else np.concatenate([lo, hi], axis=0)


def _ends(solve, k, which):
    """``(w, vecs)`` of scipy's ``which`` in {'LM', 'LA', 'SA', 'BE'} from
    ``solve(kk, find_maximum) -> (w, vecs)``, one end or both (``vecs``
    None when the solves return none)."""
    if which == "LM":
        # the largest |lambda| of a Hermitian matrix lie at its two ends
        w_hi, v_hi = solve(k, True)
        w_lo, v_lo = solve(k, False)
        w = _join(w_lo, w_hi)
        keep = np.argsort(np.abs(w))[::-1][:k]
        vecs = _join(v_lo, v_hi)
        return w[keep], None if vecs is None else vecs[keep]
    if which == "BE":
        k_hi, k_lo = k - k // 2, k // 2  # scipy: the extra one comes from the high end
        w_hi, v_hi = solve(k_hi, True)
        if not k_lo:
            return w_hi, v_hi
        w_lo, v_lo = solve(k_lo, False)
        return _join(w_lo, w_hi), _join(v_lo, v_hi)
    if which in ("LA", "SA"):
        return solve(k, which == "LA")
    raise ValueError(
        "which must be 'LM' (largest magnitude), 'LA' (largest algebraic), 'SA' (smallest algebraic), "
        "'BE' (both ends) or 'SM' (smallest magnitude, via shift-invert at 0)"
    )


def _ascending(w, vecs, return_eigenvectors):
    """scipy's result: ascending values and column eigenvectors."""
    order = np.argsort(w)
    w = np.asarray(w)[order]
    if not return_eigenvectors:
        return w
    return w, np.asarray(vecs)[order].T


def eigsh(a, k: int = 6, *, which: str = "LM", v0=None, maxiter=None, tol=None, return_eigenvectors: bool = True,
          sigma=None, method: str = "auto", device=None, **engine_kwargs):
    """Drop-in for ``scipy.sparse.linalg.eigsh`` (symmetric/Hermitian).

    ``which``: 'LM' (largest magnitude, scipy's default: both ends solved,
    the k largest |lambda| kept), 'LA', 'SA', 'BE' (k//2 from each end, the
    odd one from the high end) or 'SM' (shift-invert at sigma = 0).
    ``sigma`` selects shift-invert: Lanczos on ``(A - sigma I)^{-1}``
    applied by an inner MINRES solve (``inner_tol``/``inner_maxiter``
    bound it), with ``which`` in scipy's shift-invert sense ('LM' nearest
    sigma, 'LA' just above, 'SA' just below).  ``method='filtered'`` runs
    the Chebyshev-filtered solve.  Other keyword arguments are set on the
    ``LambdaLanczos`` engine.  ``device`` places array input (default: the
    card).  Returns ``(w, v)`` with scipy's column vectors ``v[:, i]``, or
    ``w`` alone.
    """
    if method not in ("auto", "filtered"):
        raise ValueError("method must be 'auto' (Lanczos engines / shift-invert) or 'filtered' (Chebyshev-filtered solve)")
    operand = _as_engine_operand(a, device)
    k = int(k)
    cplx = operand.dtype.is_complex
    if method == "filtered":
        return _eigsh_filtered(operand, k, which, sigma, tol, return_eigenvectors, engine_kwargs)
    if sigma is not None or which == "SM":
        sig = float(sigma) if sigma is not None else 0.0
        sense = which if sigma is not None else "LM"
        tight = _tight(tol)
        explicit_minres = any(key in engine_kwargs for key in ("inner_tol", "inner_maxiter"))
        if cplx:
            # R4: the complex MINRES; complex64 entries take it in
            # complex128 at tight tolerances (R1's route).
            if tight and operand.dtype == torch.complex64:
                operand = float64_view(operand)
        elif tight and sense == "LM" and not explicit_minres:
            # The MINRES accuracy is capped by the inner solve's floor
            # (~1e-6 relative in float32); the filtered interior mode has
            # none, so tight nearest-sigma requests go there first, as in
            # the JAX package.
            try:
                return _eigsh_filtered(operand, k, "LM", sig, tol, return_eigenvectors, engine_kwargs)
            except (TypeError, NotImplementedError):
                pass  # the operator lacks a usable float64 path: MINRES below
        if tight and real_dtype(operand.dtype) == torch.float32:
            warnings.warn(
                "eigsh shift-invert (MINRES): the requested tolerance is below the f32 inner-solve floor "
                "(~1e-6 relative); use method='filtered' (or which='LM' with a float64-capable operator, "
                "which auto-routes) for reference-grade interior accuracy",
                AccuracyWarning,
                stacklevel=2,
            )
        return _eigsh_shift_invert(operand, k, sig, sense, v0, maxiter, tol, return_eigenvectors, engine_kwargs)
    if cplx and _tight(tol) and operand.dtype == torch.complex64:
        operand = float64_view(operand)  # R1: the plain engines in complex128
    wv = bool(return_eigenvectors)
    w, vecs = _ends(lambda kk, fm: _one_end(operand, kk, fm, v0, maxiter, tol, dict(engine_kwargs), want_vecs=wv),
                    k, which)
    return _ascending(w, vecs, return_eigenvectors)


def _filtered_missed(caught, info) -> bool:
    """R2: whether a filtered solve's pairs are flagged (a
    ``BandCoverageWarning``) or its residuals exceed its own bar,
    ``0.5 sqrt(mu (hi - lo))``."""
    lo, hi = info["interval"]
    bar = 0.5 * np.sqrt(float(info["mu"]) * (hi - lo))
    return any(issubclass(c.category, BandCoverageWarning) for c in caught) or max(info["residuals"]) > bar


def _filtered_or_plain(run_filtered, run_plain, what: str):
    """``run_filtered()`` -> ``(vals, vecs, info)``; where its pairs are
    missed (R2), ``run_plain()`` with an ``AccuracyWarning`` instead of the
    filtered solve's warnings, else the filtered result with its warnings
    raised again."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vals, vecs, info = run_filtered()
    if _filtered_missed(caught, info):
        warnings.warn(
            f"eigsh(method='filtered'): the filtered solve of {what} left pairs outside its amplified band or "
            f"above its residual bar (residuals {[f'{r:.2g}' for r in info['residuals']]}); solved again "
            "through the plain Lanczos engines",
            AccuracyWarning,
            stacklevel=3,
        )
        return run_plain()
    for c in caught:
        warnings.warn_explicit(c.message, c.category, c.filename, c.lineno)
    return np.asarray(vals, np.float64), _host(vecs)


def _eigsh_filtered(operand, k, which, sigma, tol, return_eigenvectors, engine_kwargs):
    """eigsh through the Chebyshev-filtered solve: automatic windowing, and
    ``tol`` <= 1e-8 (None or 0 included) selects ``precise=True`` for real
    operators; a complex operator runs in complex128 there
    (``float64_view``: the precise engines take real dtypes only).  An end
    the filtered solve misses is solved again by the plain engines (R2);
    ``sigma`` uses the squared-transform interior mode, and a miss there
    falls back to shift-invert."""
    from .solvers.filtered import filtered_lanczos

    tight = _tight(tol)
    cplx = operand.dtype.is_complex
    fop = float64_view(operand) if (cplx and tight) else operand
    precise = tight and not cplx
    cfg = _configure(engine_kwargs)

    if sigma is not None or which == "SM":
        if sigma is not None and which != "LM":
            # the interior mode implements nearest-sigma only (scipy's
            # 'LM' sense): fail loudly instead of changing the semantics.
            raise ValueError(
                "method='filtered' with sigma supports which='LM' (nearest sigma) only; use method='auto' "
                "for the 'LA'/'SA' shift-invert senses")
        sig = float(sigma) if sigma is not None else 0.0

        def plain_interior():
            w, vecs = _eigsh_shift_invert(operand, k, sig, "LM", None, None, tol, True, dict(engine_kwargs))
            return w, vecs.T

        w, vecs = _filtered_or_plain(
            lambda: filtered_lanczos(fop, k, sigma=sig, precise=precise, configure=cfg), plain_interior,
            f"the {k} eigenvalues nearest {sig}")
        return _ascending(w, vecs, return_eigenvectors)

    def one_end(kk, find_max):
        # auto_window: the scout sizes the band to the requested states'
        # spread (the static default can miss the 2nd+ state of a
        # well-separated spectrum).
        return _filtered_or_plain(
            lambda: filtered_lanczos(fop, kk, find_max, precise=precise, auto_window=True, configure=cfg),
            lambda: _one_end(fop, kk, find_max, None, None, tol, dict(engine_kwargs)),
            f"the {'largest' if find_max else 'smallest'} {kk}")

    if which not in ("LM", "LA", "SA", "BE"):
        raise ValueError("which must be 'LM', 'LA', 'SA', 'BE' or 'SM' for method='filtered'")
    w, vecs = _ends(one_end, k, which)
    return _ascending(w, vecs, return_eigenvectors)


def _eigsh_shift_invert(base, k, sigma, which, v0, maxiter, tol, return_eigenvectors, engine_kwargs):
    """eigsh in shift-invert mode (scipy semantics on theta = 1/(lambda -
    sigma)): 'LM' nearest sigma (both extremes of theta merged by
    |theta|), 'LA' just above, 'SA' just below.  Real or complex Hermitian
    ``base``."""
    if which not in ("LM", "LA", "SA"):
        raise ValueError("with sigma, which must be 'LM' (nearest), 'LA' (above) or 'SA' (below)")
    inner_tol = engine_kwargs.pop("inner_tol", None)
    inner_maxiter = engine_kwargs.pop("inner_maxiter", None)
    if inner_tol is None:
        inner_tol = machine_eps(base.dtype) * 100.0
    if inner_maxiter is None:
        # MINRES ends in <= n steps only in exact arithmetic; interior
        # shifts are ill-conditioned and commonly need a few n in floats.
        inner_maxiter = min(4 * int(base.n), 10_000)
    op = ShiftInvertOperator(base, sigma, inner_tol, int(inner_maxiter))

    def thetas(find_maximum, kk):
        th, vecs = _one_end(op, kk, find_maximum, v0, maxiter, tol, dict(engine_kwargs))
        keep = np.abs(th) > 0
        return th[keep], vecs[keep]

    if which == "LM":
        th_hi, v_hi = thetas(True, k)
        th_lo, v_lo = thetas(False, k)
        th = np.concatenate([th_hi, th_lo])
        vecs = np.concatenate([v_hi, v_lo], axis=0)
        # Dedup (a theta extreme can appear in both runs) by eigenvector
        # overlap alone: the same pair from the two runs agrees in theta
        # only to the engine eps, while distinct pairs (two members of a
        # degenerate cluster too) are near-orthogonal.
        order = np.argsort(-np.abs(th))
        th, vecs = th[order], vecs[order]
        uniq = []
        for i in range(th.shape[0]):
            if all(abs(np.vdot(vecs[i], vecs[j])) < 0.9 for j in uniq):
                uniq.append(i)
            if len(uniq) == k:
                break
        th, vecs = th[uniq], vecs[uniq]
    else:
        th, vecs = thetas(which == "LA", k)
        th, vecs = th[:k], vecs[:k]

    w = sigma + 1.0 / th
    order = np.argsort(w)
    w, vecs = w[order], vecs[order]

    # A-posteriori check against A itself: an inner solve that hit
    # inner_maxiter feeds a silently wrong inverse through the outer engine.
    scale = float(np.max(np.abs(w))) if w.size else 1.0
    eff_tol = max(float(tol) if tol else 0.0, np.sqrt(inner_tol)) * max(scale, 1.0)
    bad = []
    for i in range(w.shape[0]):
        v_i = torch.as_tensor(vecs[i], device=base.device).to(base.dtype)
        r = float(torch.linalg.vector_norm(base.matvec(v_i) - float(w[i]) * v_i))
        if r > eff_tol:
            bad.append((float(w[i]), r))
    if bad:
        warnings.warn(
            f"shift-invert eigsh: {len(bad)} eigenpair(s) have residuals above {eff_tol:.1e} (worst "
            f"{max(b for _, b in bad):.1e}): the inner MINRES solves likely hit inner_maxiter; raise "
            "inner_maxiter or loosen sigma",
            AccuracyWarning,
            stacklevel=3,
        )
    if not return_eigenvectors:
        return w
    return w, vecs.T


def _expm_multiply_chebyshev(expo, b, t, ts):
    """expm_multiply through the whole-evolution Chebyshev chain (complex
    states for a complex operator, split words for a real one)."""
    def one_vec(vec):
        vr = np.ascontiguousarray(np.real(vec))
        vi = np.ascontiguousarray(np.imag(vec)) if np.iscomplexobj(vec) else np.zeros_like(vr)
        if ts is None:
            (o_re, o_im), _ = expo.run_chebyshev(t, vr, vi)
        else:
            (o_re, o_im), _ = expo.run_chebyshev_grid(list(ts), vr, vi)
        out = _host(o_re).astype(np.float64) + 1j * _host(o_im).astype(np.float64)
        return out if (np.iscomplexobj(vec) or expo.operator.dtype.is_complex) else np.real(out)

    if b.ndim == 1:
        return one_vec(b)
    return np.stack([one_vec(b[:, j]) for j in range(b.shape[1])], axis=-1)


def minres(a, b, *, x0=None, shift: float = 0.0, rtol: float = 1e-5, maxiter=None, tol=None, device=None):
    """Drop-in for ``scipy.sparse.linalg.minres``: solve ``(A - shift I) x =
    b`` for a symmetric/Hermitian A (indefinite-safe).  Returns ``(x,
    info)`` with scipy's convention: info 0 when converged to ``rtol``,
    else the iteration count at which ``maxiter`` stopped it.  ``tol`` is
    scipy's deprecated alias of ``rtol``."""
    from .solvers.minres import minres as _minres

    op = _as_engine_operand(a, device)
    if tol is not None:
        rtol = tol
    if maxiter is None:
        maxiter = 5 * int(op.n)
    bt = torch.as_tensor(np.asarray(b), device=op.device).to(op.dtype)
    x0t = torch.as_tensor(np.asarray(x0), device=op.device).to(op.dtype) if x0 is not None else None
    x, relres, iters = _minres(op, bt, shift=shift, tol=rtol, maxiter=int(maxiter), x0=x0t)
    info = 0 if float(relres) <= rtol else int(iters)
    return _host(x), info


def expm_multiply(a, b, *, t: float = 1.0, start=None, stop=None, num=None, endpoint=None, method: str = "auto",
                  device=None, **engine_kwargs):
    """Drop-in for ``scipy.sparse.linalg.expm_multiply(A, B)``.

    A single point: ``exp(t*A) @ B`` for a vector or an (n, m) block.  A
    time grid (scipy's start/stop/num/endpoint): the stacked ``exp(t_i*A)
    @ B``, (num, n) for a vector and (num, n, m) for a block, from one
    Krylov build per input vector.  ``method='chebyshev'`` evaluates
    through the Chebyshev propagator (one matvec chain for the whole
    evolution or grid).  A complex Hermitian A takes complex states
    natively; a complex ``b`` for a real A is split into its parts.  Other
    keyword arguments configure the ``Exponentiator``; ``device`` places
    array input (default: the card).  Returns numpy arrays.
    """
    if method not in ("auto", "chebyshev"):
        raise ValueError("method must be 'auto' (Krylov) or 'chebyshev'")
    expo = Exponentiator(_as_engine_operand(a, device))
    for key, val in engine_kwargs.items():
        if not hasattr(expo, key):
            raise TypeError(f"unknown engine option {key!r}")
        setattr(expo, key, val)
    b = np.asarray(b)
    ts = None
    if start is not None or stop is not None or num is not None:
        if start is None or stop is None or num is None:
            raise ValueError("time grids need start, stop and num together (scipy semantics)")
        ts = list(np.linspace(float(start), float(stop), int(num), endpoint=True if endpoint is None else bool(endpoint)))
    if method == "chebyshev":
        return _expm_multiply_chebyshev(expo, b, t, ts)
    split = np.iscomplexobj(b) and not expo.operator.dtype.is_complex

    def grid(vec):
        if split:  # exp(tA) is real-linear: the parts' outputs add up
            return _host(expo.run_grid(ts, np.real(vec))[0]) + 1j * _host(expo.run_grid(ts, np.imag(vec))[0])
        return _host(expo.run_grid(ts, vec)[0])

    def point(vec):
        if split:
            (o_re, o_im), _ = expo.run_split(t, np.real(vec), np.imag(vec))
            return _host(o_re) + 1j * _host(o_im)
        return _host(expo.run(t, vec)[0])

    if ts is not None:
        if b.ndim == 1:
            return grid(b)
        return np.stack([grid(b[:, j]) for j in range(b.shape[1])], axis=-1)  # (num, n, m)
    if b.ndim == 1:
        return point(b)
    if split:
        return np.stack([point(b[:, j]) for j in range(b.shape[1])], axis=-1)
    outs, _ = expo.run_batch(t, np.ascontiguousarray(b.T))  # columns -> batch rows
    return _host(outs).T
