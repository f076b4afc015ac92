"""Chebyshev propagator: exp(a*A) v as one polynomial matvec chain (port of
``lanczos_tpu.solvers.cheby_expm``).

The Tal-Ezer/Kosloff expansion: with the spectrum of A inside [lo, hi],
map x = (A - c)/e (c, e the window's center and half-width) and

    exp(a*A) v = exp(a*c) * [ I_0(z) + 2 * sum_{k>=1} I_k(z) T_k(x) ] v,
    z = a*e,

with I_k the modified Bessel function of the first kind (complex argument:
a = i*t is the unitary propagator, real a the heat kernel).  |I_k(z)| dies
superexponentially once k > |z|, so the whole evolution costs about |a|*e
matvecs, whatever the step count.  A grid of times shares one T_k chain:
time enters only through the host coefficients.

T_k is real, so the chain applies the real operator to the real and
imaginary words apart (the matvec sees real vectors only: kernel K1 over a
``BSROperator`` on CUDA) and the complex coefficients mix them into the
accumulators.  [lo, hi] MUST enclose the spectrum (|x| > 1 makes T_k grow
like cosh); the defaults are +-Gershgorin, which always do.

``precise=True`` (:func:`chebyshev_expm_apply_split_precise`) runs the
same chain in float64 over the operator's ``matvec_f64``, the state taken
in float64 from the start: the JAX package's word-pair chain
(``_cheby_chain_df``) with float64 in place of the pairs.

A complex Hermitian operator (native, or a
:class:`~lanczos_tpu_torch.ops.hermitian_split.HermitianSplitOperator`)
takes the complex chain (:func:`chebyshev_expm_apply_hermitian`,
:func:`chebyshev_expm_grid_hermitian`): T_k(x) psi is complex, the matvec
is the complex operator's (kernel K1's complex instances over a complex
BSR operator), and the coefficients multiply it as complex scalars, where
the JAX package runs the real chain on the 2n embedding and recombines the
halves.  Its precise form runs in complex128 over ``matvec_f64``.

The chain has no reduction, so over a row-partitioned operator it runs on
the slabs as it is (the window's Gershgorin bound is one all-reduce); the
precise forms gather the host results to the global n.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import linalg
from ..core.types import real_dtype
from ..ops.operators import as_operator, float64_view
from ..utils import estimate
from .exponentiator import complex_operator, complex_state, precise_state

__all__ = [
    "chebyshev_expm_coeffs",
    "chebyshev_expm_apply_split",
    "chebyshev_expm_grid_split",
    "chebyshev_expm_apply_split_precise",
    "chebyshev_expm_apply_hermitian",
    "chebyshev_expm_grid_hermitian",
]



def chebyshev_expm_coeffs(a, c, e, tol: float = 1e-16, kmax: int = 100_000):
    """Host expansion coefficients exp(a*c) * (2 - delta_k0) * I_k(a*e), a
    complex128 array cut where the tail falls below ``tol`` relative to the
    largest term.  ``kmax`` bounds the term count (|z| ~ 1e5 means ~1e5
    matvecs: almost certainly a wrong window)."""
    from scipy.special import iv

    z = complex(a) * float(e)
    K = int(min(abs(z) + 20.0 * (abs(z) ** (1.0 / 3.0) + 2.0), kmax))
    ks = np.arange(K + 1)
    with np.errstate(over="ignore", invalid="ignore"):
        ck = iv(ks, z).astype(np.complex128)
    if not np.all(np.isfinite(ck)):
        # |z| large enough to overflow iv's internals: the scaled form.
        # scipy defines ive(k, z) = iv(k, z) * exp(-abs(Re z)) for complex
        # z, so the unscale is exp(abs(Re z)), not exp(z).
        from scipy.special import ive

        ck = ive(ks, z).astype(np.complex128)
        with np.errstate(over="ignore"):
            pref = np.exp(complex(a) * float(c) + abs(z.real))
        if not np.isfinite(pref):
            raise OverflowError(
                f"chebyshev_expm_coeffs: prefactor exp(a*c + |Re(a*e)|) overflows for a={a!r}, window "
                f"center {c}, half-width {e}: the requested evolution amplifies beyond float range; "
                "split the time interval or shrink the window."
            )
    else:
        pref = np.exp(complex(a) * float(c))
    mag = np.abs(ck)
    floor = tol * max(mag.max(), 1e-300)
    keep = np.nonzero(mag > floor)[0]
    kcut = int(keep[-1]) + 1 if keep.size else 1
    coef = ck[:kcut] * 2.0 * pref
    coef[0] *= 0.5
    return coef


def _window(op, lo, hi):
    """(center, half-width) of [lo, hi]; a missing end is the Gershgorin
    bound, or 1.1 times the power bound for a matrix-free operator (an
    underestimated window makes T_k blow up)."""
    if lo is None or hi is None:
        try:
            g = float(estimate.gershgorin_bound(op))
        except TypeError:  # matrix-free: the entries are not stored
            g = 1.1 * float(estimate.power_bound(op))
        lo = -g if lo is None else float(lo)
        hi = g if hi is None else float(hi)
    if not (hi > lo):
        raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def _as_real(coef, dtype) -> list[float]:
    """The host values of ``coef`` rounded to ``dtype``, as Python floats
    (the chain scales device vectors by them without a device read)."""
    return np.asarray(coef, dtype=np.float32 if dtype == torch.float32 else np.float64).tolist()


def _mapped_matvec(op, c: float, e: float, dtype):
    """w -> x w = (A w - c w) / e, with c and 1/e rounded to ``dtype``."""
    inv_e = _as_real(1.0 / _as_real(e, dtype), dtype)
    c = _as_real(c, dtype)
    return lambda w: (op.matvec(w) - c * w) * inv_e


def _cheby_chain(op, c: float, e: float, coef_re, coef_im, v_re, v_im):
    """acc = sum_k coef_k T_k(x) (v_re + i v_im) on split words: T_k is
    real, so it acts on each word alone; the complex coefficient mixes them
    into the accumulators.  ``coef_*`` are Python floats."""
    xmv = _mapped_matvec(op, c, e, v_re.dtype)

    def accumulate(acc_re, acc_im, cr, ci, tr, ti):
        return acc_re + cr * tr - ci * ti, acc_im + cr * ti + ci * tr

    acc_re, acc_im = accumulate(torch.zeros_like(v_re), torch.zeros_like(v_im), coef_re[0], coef_im[0], v_re, v_im)
    if len(coef_re) == 1:
        return acc_re, acc_im
    pr, pi = v_re, v_im
    qr, qi = xmv(v_re), xmv(v_im)
    acc_re, acc_im = accumulate(acc_re, acc_im, coef_re[1], coef_im[1], qr, qi)
    for cr, ci in zip(coef_re[2:], coef_im[2:]):
        nr = 2.0 * xmv(qr) - pr
        ni = 2.0 * xmv(qi) - pi
        acc_re, acc_im = accumulate(acc_re, acc_im, cr, ci, nr, ni)
        pr, pi, qr, qi = qr, qi, nr, ni
    return acc_re, acc_im


def chebyshev_expm_apply_split(op, a, v_re, v_im, *, lo=None, hi=None, tol: float = 1e-16):
    """exp(a*A) (v_re + i v_im) -> ``((out_re, out_im), n_terms)``.

    ``a`` may be complex (a = i*t is the unitary propagator).  ``lo`` and
    ``hi`` default to +-Gershgorin; they MUST enclose the spectrum.
    """
    op = as_operator(op)
    c, e = _window(op, lo, hi)
    coef = chebyshev_expm_coeffs(a, c, e, tol=tol)
    dtype = v_re.dtype
    out = _cheby_chain(op, c, e, _as_real(coef.real, dtype), _as_real(coef.imag, dtype), v_re, v_im)
    return out, int(coef.shape[0])


def _cheby_chain_grid(op, c: float, e: float, coef_re, coef_im, v_re, v_im):
    """The grid form: ``coef_*`` are (num_t, K) device tensors, and one
    T_k chain feeds every time point's (num_t, n) accumulator."""
    xmv = _mapped_matvec(op, c, e, v_re.dtype)

    def accumulate(acc_re, acc_im, k, tr, ti):
        cr, ci = coef_re[:, k], coef_im[:, k]
        acc_re = acc_re + torch.outer(cr, tr) - torch.outer(ci, ti)
        acc_im = acc_im + torch.outer(cr, ti) + torch.outer(ci, tr)
        return acc_re, acc_im

    num_t = coef_re.shape[0]
    zeros = torch.zeros((num_t, v_re.shape[0]), dtype=v_re.dtype, device=v_re.device)
    acc_re, acc_im = accumulate(zeros, zeros, 0, v_re, v_im)
    pr, pi = v_re, v_im
    qr, qi = xmv(v_re), xmv(v_im)
    acc_re, acc_im = accumulate(acc_re, acc_im, 1, qr, qi)
    for k in range(2, coef_re.shape[1]):
        nr = 2.0 * xmv(qr) - pr
        ni = 2.0 * xmv(qi) - pi
        acc_re, acc_im = accumulate(acc_re, acc_im, k, nr, ni)
        pr, pi, qr, qi = qr, qi, nr, ni
    return acc_re, acc_im


def chebyshev_expm_grid_split(op, a_list, v_re, v_im, *, lo=None, hi=None, tol: float = 1e-16):
    """exp(a_j*A) (v_re + i v_im) for every a_j from ONE matvec chain, set
    by the largest |a_j * e|; each extra time point costs a coefficient row
    and an (n,) accumulator.  Returns ``((out_re (num, n), out_im (num,
    n)), n_terms)``."""
    op = as_operator(op)
    c, e = _window(op, lo, hi)
    per = [chebyshev_expm_coeffs(a, c, e, tol=tol) for a in a_list]
    K = max(2, max(p.shape[0] for p in per))
    coef = np.zeros((len(per), K), np.complex128)
    for j, p in enumerate(per):
        coef[j, : p.shape[0]] = p
    dev, dtype = v_re.device, v_re.dtype
    coef_re = torch.from_numpy(np.ascontiguousarray(coef.real)).to(dev, dtype)
    coef_im = torch.from_numpy(np.ascontiguousarray(coef.imag)).to(dev, dtype)
    return _cheby_chain_grid(op, c, e, coef_re, coef_im, v_re, v_im), int(K)


def chebyshev_expm_apply_split_precise(op, a, v_re, v_im, *, lo=None, hi=None, tol: float = 1e-16):
    """exp(a*A) (v_re + i v_im) at float64 grade from the operator's
    storage: the chain over ``matvec_f64`` with the state in float64 (a
    missing ``v_im`` is zero).  Returns ``((re, im) host float64 arrays,
    n_terms)``, as the JAX package's word-pair chain does."""
    op = as_operator(op)
    c, e = _window(op, lo, hi)
    coef = chebyshev_expm_coeffs(a, c, e, tol=tol)
    vr = precise_state(v_re, op.device)
    vi = torch.zeros_like(vr) if v_im is None else precise_state(v_im, op.device)
    re, im = _cheby_chain(float64_view(op), c, e, coef.real.tolist(), coef.imag.tolist(), vr, vi)
    return tuple(linalg.gather_rows(t, op).cpu().numpy() for t in (re, im)), int(coef.shape[0])


def _cheby_chain_complex(op, c: float, e: float, coef, v):
    """acc = sum_k coef_k T_k(x) v for a complex operator and state:
    ``coef`` (host complex128) rounded to the state's dtype, the chain in
    the state's dtype."""
    xmv = _mapped_matvec(op, c, e, real_dtype(v.dtype))
    cs = np.asarray(coef, np.complex64 if v.dtype == torch.complex64 else np.complex128).tolist()
    acc = cs[0] * v
    if len(cs) == 1:
        return acc
    p, q = v, xmv(v)
    acc = acc + cs[1] * q
    for ck in cs[2:]:
        p, q = q, 2.0 * xmv(q) - p
        acc = acc + ck * q
    return acc


def chebyshev_expm_apply_hermitian(op, a, psi_re, psi_im, *, lo=None, hi=None, tol: float = 1e-16,
                                   precise: bool = False):
    """exp(a*H) psi for a complex Hermitian H (a complex operator or a
    ``HermitianSplitOperator``) and the complex n-state ``psi_re + i
    psi_im``, by the complex chain.  The window defaults to +-Gershgorin of
    ``op`` as given (the power bound of the embedding for a split operator,
    as in the JAX package).  Returns ``((out_re, out_im), n_terms)``;
    ``precise=True`` runs in complex128 over ``matvec_f64`` from a float64
    state and returns host float64 arrays."""
    c, e = _window(op, lo, hi)
    coef = chebyshev_expm_coeffs(a, c, e, tol=tol)
    cop = complex_operator(op)
    if precise:
        psi = torch.complex(precise_state(psi_re, cop.device), precise_state(psi_im, cop.device))
        out = _cheby_chain_complex(float64_view(cop), c, e, coef, psi)
        return tuple(linalg.gather_rows(t, cop).cpu().numpy() for t in (out.real, out.imag)), int(coef.shape[0])
    out = _cheby_chain_complex(cop, c, e, coef, complex_state(cop, psi_re, psi_im))
    return (out.real, out.imag), int(coef.shape[0])


def chebyshev_expm_grid_hermitian(op, a_list, psi_re, psi_im, *, lo=None, hi=None, tol: float = 1e-16):
    """The grid form of :func:`chebyshev_expm_apply_hermitian`: every a_j
    from one complex chain, set by the largest |a_j * e|.  Returns
    ``((out_re (num, n), out_im (num, n)), n_terms)``."""
    c, e = _window(op, lo, hi)
    per = [chebyshev_expm_coeffs(a, c, e, tol=tol) for a in a_list]
    K = max(2, max(p.shape[0] for p in per))
    coef = np.zeros((len(per), K), np.complex128)
    for j, p in enumerate(per):
        coef[j, : p.shape[0]] = p
    cop = complex_operator(op)
    v = complex_state(cop, psi_re, psi_im)
    ct = torch.from_numpy(coef).to(v.device, v.dtype)
    xmv = _mapped_matvec(cop, c, e, real_dtype(v.dtype))
    acc = torch.outer(ct[:, 0], v)
    p, q = v, xmv(v)
    acc = acc + torch.outer(ct[:, 1], q)
    for k in range(2, K):
        p, q = q, 2.0 * xmv(q) - p
        acc = acc + torch.outer(ct[:, k], q)
    return (acc.real, acc.imag), int(K)
