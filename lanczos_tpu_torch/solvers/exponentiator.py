"""Krylov matrix exponentiation, v' = exp(a*A) v (port of
``lanczos_tpu.solvers.exponentiator`` and of the split and multi-step parts
of ``lanczos_tpu.solvers.exponentiator_fused``; reference
include/lambda_lanczos/exponentiator.hpp).

The scalar ``a`` may be complex (``-i*dt`` for quantum time evolution)
while the operator is Hermitian.  The small problem (the tridiagonal
eigensolve and the Krylov coefficients of the hybrid build) runs on the
host in float64/complex128; the O(n) work (matvec, recurrence,
reorthogonalization, recombination) runs on the operator's device.

Convergence follows the reference: successive Krylov coefficient vectors
agree within eps (exponentiator.hpp:147-158), with a tridiagonal
eigenpair solve on the host every iteration (:124-126), or the build
breaks down (beta below the storage dtype's machine eps).  The agreement
is measured as a relative change, which is the reference's overlap test
for the unit coefficient vectors of imaginary a and, unlike it, also
stops for a with a real part (see :func:`_coefficients_settled`).

The JAX package's split-real machinery exists because the TPU runtime has
no complex dtype.  Here :func:`krylov_expm_apply_split` builds one real
Krylov basis per part of a complex input (a real operator's matvec sees
only real vectors), takes complex coefficients on the host and recombines;
:func:`evolve_split` takes the small exponential of each step in
complex128 on the device.  The device-resident build, which queues whole
stages of iterations and replays the stop test on the host, is
:mod:`.exponentiator_fused`.

:func:`evolve_split_precise` is the JAX package's
``exponentiator_precise.evolve_split_precise``: the same multi-step
evolution with the state, the Krylov build (over the operator's
``matvec_f64``, CGS2 in float64: kernel K3 on the card) and the small
exponential in float64 and complex128, where the JAX module carries every
one of them as word pairs.

A complex Hermitian operator (native complex entries, or the JAX package's
:class:`~lanczos_tpu_torch.ops.hermitian_split.HermitianSplitOperator`,
through its ``complex_operator``) is built natively: one complex Krylov
basis per step (:func:`evolve_complex`, kernel K3's complex instances for
the full reorthogonalization on the card), where the JAX package builds a
real basis of the 2n embedding and recombines its halves
(``evolve_hermitian_split``); :func:`evolve_hermitian_split_precise` is
the same in complex128 over ``matvec_f64``.

Over a row-partitioned operator every state and basis row is this rank's
slab and every reduction (the coefficients, the norms, the basis passes)
goes through ``op.group``; ``api.Exponentiator`` scatters the global
states and gathers the results, and the functions that return host
arrays gather before they do (``linalg.gather_rows``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import linalg, tridiagonal
from ..core.types import machine_eps, real_dtype
from ..ops.hermitian_split import HermitianSplitOperator
from ..ops.operators import float64_view

__all__ = [
    "ExponentiatorConfig",
    "krylov_expm_apply",
    "krylov_expm_apply_grid",
    "krylov_expm_apply_split",
    "taylor_expm_apply",
    "evolve_split",
    "evolve_split_precise",
    "evolve_complex",
    "evolve_hermitian_split",
    "evolve_hermitian_split_precise",
    "precise_state",
    "complex_operator",
    "complex_state",
]


@dataclasses.dataclass
class ExponentiatorConfig:
    """Mirrors the reference's public fields (exponentiator.hpp:41-71)."""

    matrix_size: int
    max_iteration: int | None = None  # defaults to matrix_size (exponentiator.hpp:81)
    eps: float | None = None  # defaults to machine_eps*1e2 (exponentiator.hpp:58)
    full_orthogonalize: bool = False  # (exponentiator.hpp:63)
    # Krylov expm typically converges in ~10-30 iterations; a small initial
    # capacity keeps the (cap, n) buffer small, grown 4x on demand.
    initial_buffer_size: int = 16
    tridiag_backend: str | None = None

    def resolved(self, dtype):
        cfg = dataclasses.replace(self)
        if cfg.max_iteration is None:
            cfg.max_iteration = cfg.matrix_size
        if cfg.eps is None:
            cfg.eps = machine_eps(dtype) * 1e2
        return cfg


def _expm_step(op, u_buf, k: int, beta_prev, full_orth: bool = False):
    """One Krylov step (exponentiator.hpp:106-122): no eigenvalue shift and,
    by default, no reorthogonalization.  Writes the normalized u_k into row
    k of ``u_buf`` in place and returns ``(alpha_k, beta_k)``, 0-d real
    tensors on the device (beta_k unnormalized)."""
    return _expm_update(u_buf, k, op.matvec(u_buf[k - 1]), beta_prev, full_orth, getattr(op, "group", None))


def _expm_update(u_buf, k: int, au, beta_prev, full_orth: bool = False, group=None):
    """:func:`_expm_step` after its matvec, given ``au`` = A u_{k-1}."""
    rdtype = real_dtype(u_buf.dtype)
    u_prev = u_buf[k - 1]
    u_pp = u_buf[max(k - 2, 0)]
    alpha = linalg.inner_prod(u_prev, au, group).real.to(rdtype)
    w = au - alpha * u_prev
    if k >= 2:
        w = w - beta_prev * u_pp
    if full_orth:  # exponentiator.hpp:120-122; K3 on CUDA
        w = linalg.orthogonalize_bcgs_dyn(w, u_buf, k, group=group)
    beta = linalg.norm(w, group).to(rdtype)
    u_buf[k] = w / torch.clamp(beta, min=torch.finfo(rdtype).tiny)
    return alpha, beta


def _krylov_coefficients(a, alphas, betas, backend):
    """coeff[i] = sum_j p[j][i] exp(a*ev[j]) p[j][0] on the host in
    float64/complex128 (exponentiator.hpp:124-133)."""
    ev, p = tridiagonal.eigh_tridiagonal_host(np.asarray(alphas), np.asarray(betas), backend=backend)
    weights = np.exp(a * ev) * p[:, 0]
    return p.T @ weights


def _coefficients_settled(prev, coeff, eps: float) -> bool:
    """The stop test on successive Krylov coefficient vectors.

    The reference stops when ``|1 - |<prev, coeff>|| < eps``
    (exponentiator.hpp:147-158), which assumes unit vectors: so it is for
    imaginary a (exp(aT) is unitary), and there ``||coeff - prev||^2 / 2``
    is the same quantity.  For a with a real part ||exp(aT) e1|| is not 1,
    the reference test never fires, and the build runs to max_iteration (n
    by default; R7 in ROADMAP.md).  Here the relative change is tested,
    ``||coeff - prev||^2 / (2 ||coeff||^2) < eps``: the reference's test
    for unit vectors, and the same bound on the output's change for any
    a."""
    diff = coeff.copy()
    diff[: prev.shape[0]] -= prev
    return float(np.vdot(diff, diff).real) < 2.0 * eps * float(np.vdot(coeff, coeff).real)


def _recombine(coeff, u_buf, scale):
    """``scale * coeff @ u_buf`` (exponentiator.hpp:163-170) for the host
    coefficients ``coeff`` (num, cap).  Complex coefficients against a real
    basis are two real products, so the basis is never copied to complex;
    the result is complex then."""
    dev, dtype = u_buf.device, u_buf.dtype
    if np.iscomplexobj(coeff) and not dtype.is_complex:
        cr = torch.from_numpy(np.ascontiguousarray(coeff.real)).to(dev, dtype)
        ci = torch.from_numpy(np.ascontiguousarray(coeff.imag)).to(dev, dtype)
        return torch.complex(cr @ u_buf, ci @ u_buf) * scale
    c = torch.from_numpy(np.ascontiguousarray(coeff)).to(dev, dtype)
    return (c @ u_buf) * scale


def _grid_build(op, a_list, v, cfg: ExponentiatorConfig):
    """The Krylov build and the host coefficient grid, shared by the grid,
    single-point and split paths.

    Returns ``(u_buf, coeff_grid, input_norm, itern)`` with ``coeff_grid``
    (num, cap) on the host (complex128 when any a or v is complex, else
    float64), or ``None`` for a zero input (exp(a*A) 0 = 0)."""
    dtype = v.dtype
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    n = cfg.matrix_size
    max_iter = min(cfg.max_iteration, max(n, 1))
    if max_iter < 1:
        raise ValueError(f"max_iteration must be >= 1, got {cfg.max_iteration}")
    a_list = [complex(a) for a in a_list]
    if not a_list:
        raise ValueError("a_list must contain at least one scalar")
    any_imag = any(a.imag != 0 for a in a_list) or dtype.is_complex
    a_host = [a if any_imag else a.real for a in a_list]
    a_check = a_host[int(np.argmax([abs(a) for a in a_list]))]

    input_norm = linalg.norm(v, getattr(op, "group", None))
    if float(input_norm) == 0.0:
        return None
    cap = min(max(cfg.initial_buffer_size, 2), max_iter + 1)
    u_buf = torch.zeros((cap, v.shape[0]), dtype=dtype, device=v.device)
    u_buf[0] = v / input_norm

    alphas: list[float] = []
    betas: list[float] = []
    coeff_prev = None
    beta_threshold = machine_eps(rdtype)
    itern = max_iter
    beta_prev = None
    for k in range(1, max_iter + 1):
        if k >= u_buf.shape[0]:
            grown = torch.zeros((min(4 * u_buf.shape[0], max_iter + 1), v.shape[0]), dtype=dtype, device=v.device)
            grown[: u_buf.shape[0]] = u_buf
            u_buf = grown
        alpha_k, beta_prev = _expm_step(op, u_buf, k, beta_prev, full_orth=cfg.full_orthogonalize)
        alpha_h, beta_h = torch.stack([alpha_k, beta_prev]).tolist()  # the iteration's one device wait
        alphas.append(alpha_h)
        # The coefficients come BEFORE this iteration's beta is pushed
        # (exponentiator.hpp:124-145): they use the k x k tridiagonal.
        coeff = _krylov_coefficients(a_check, alphas, betas, cfg.tridiag_backend)
        betas.append(beta_h)
        converged = coeff_prev is not None and _coefficients_settled(coeff_prev, coeff, cfg.eps)
        coeff_prev = coeff
        if converged or betas[-1] < beta_threshold:
            itern = k
            break

    m = len(alphas)
    coeff_grid = np.zeros((len(a_host), u_buf.shape[0]), dtype=np.complex128 if any_imag else np.float64)
    for i, a in enumerate(a_host):
        coeff_grid[i, :m] = _krylov_coefficients(a, alphas, betas[:-1], cfg.tridiag_backend)
    return u_buf, coeff_grid, input_norm, itern


def krylov_expm_apply(op, a, v, cfg: ExponentiatorConfig):
    """exp(a*A) v in the Krylov basis (reference run, exponentiator.hpp:
    87-173); returns ``(output, iteration_count)``.  The single-point case
    of :func:`krylov_expm_apply_grid`, so the ordering invariants live in
    one place."""
    outputs, itern = krylov_expm_apply_grid(op, [a], v, cfg)
    return outputs[0], itern


def krylov_expm_apply_grid(op, a_list, v, cfg: ExponentiatorConfig):
    """exp(a_i*A) v for a grid of scalars from ONE Krylov build.

    The basis depends only on (A, v); time enters through the host
    coefficients exp(a T) e1 alone.  The build converges for the largest
    |a_i|, so every smaller point is at least as accurate, and the grid
    recombines as one (num, cap) x (cap, n) product.  Returns
    ``(outputs (num, n), iteration_count)``; the outputs are complex when
    any a_i is.
    """
    built = _grid_build(op, a_list, v, cfg)
    if built is None:
        return torch.zeros((len(list(a_list)), v.shape[0]), dtype=v.dtype, device=v.device), 0
    u_buf, coeff_grid, input_norm, itern = built
    return _recombine(coeff_grid, u_buf, input_norm), itern


def krylov_expm_apply_split(op, a, v_re, v_im, cfg: ExponentiatorConfig):
    """exp(a*A) (v_re + i v_im) for a REAL symmetric operator.

    A real start vector under a real operator gives a real Krylov basis, so
    each part gets its own real build (the hybrid build, as
    :func:`krylov_expm_apply` runs it) and only the coefficient vectors
    exp(a T) e1 are complex, on the host.  With p = exp(aA) v_re and
    q = exp(aA) v_im, the output is p + i q.  A part of norm below
    10 * tiny is exactly zero and counts one iteration, as in the JAX
    package's batched driver.  Returns ``((out_re, out_im), (iters_re,
    iters_im))``.
    """
    if v_re.dtype.is_complex or v_im.dtype.is_complex:
        raise TypeError("split expm takes the real and imaginary parts as separate real tensors")
    a = complex(a)
    tiny = torch.finfo(v_re.dtype).tiny
    parts = []
    for v in (v_re, v_im):
        if float(linalg.norm(v, getattr(op, "group", None))) < tiny * 10:
            parts.append((torch.zeros_like(v), torch.zeros_like(v), 1))
            continue
        u_buf, coeff, input_norm, itern = _grid_build(op, [a], v, cfg)
        out = _recombine(coeff.astype(np.complex128), u_buf, input_norm)[0]
        parts.append((out.real, out.imag, itern))
    (pr, pi, it_re), (qr, qi, it_im) = parts
    return (pr - qi, pi + qr), (it_re, it_im)


def taylor_expm_apply(op, a, v, cfg: ExponentiatorConfig):
    """Taylor-series exp(a*A) v with backward (small-to-large) summation
    (reference taylor_run, exponentiator.hpp:175-210); returns
    ``(output, term_count)``.

    As in the JAX package, the stored terms are the scaled ones,
    ``t_k = (|a|^k / k!) A^k v`` built as ``t_k = (|a|/k) A t_{k-1}``, with
    the unit phase ``(a/|a|)^k`` kept on the host: the reference's raw
    ``A^k v`` overflows float32 around k ~ 64 for ||A|| ~ 4, and its
    unbounded loop would then never stop.  Scaled terms decay once
    ``k > |a| ||A||``; a term that overflows raises ``OverflowError``.
    """
    a = complex(a)
    if a == 0:  # zero-a short circuit (:179-182)
        return v, 1
    terms, phase = _taylor_terms(op, a, v, cfg)
    out_dtype = v.dtype
    if a.imag != 0 and not out_dtype.is_complex:
        out_dtype = torch.complex64 if out_dtype == torch.float32 else torch.complex128
    output = torch.zeros(v.shape, dtype=out_dtype, device=v.device)
    for kk in range(len(terms) - 1, -1, -1):
        ph = phase**kk  # recomputed per term: no accumulated phase drift
        output = output + terms[kk].to(out_dtype) * (ph if out_dtype.is_complex else ph.real)
    return output, len(terms)


def _taylor_terms(op, a: complex, v, cfg: ExponentiatorConfig):
    """``(terms, phase)`` with ``terms[k] = (|a|^k / k!) A^k v`` and
    ``phase = a/|a|``; one host read of each term's norm."""
    cfg = cfg.resolved(v.dtype)
    group = getattr(op, "group", None)
    mag = abs(a)
    phase = a / mag  # unit complex; exactly +-1 for real a
    terms = [v]
    k = 1
    while True:
        t = op.matvec(terms[-1]) * (mag / k)
        terms.append(t)
        tn = float(linalg.norm(t, group))
        if not np.isfinite(tn):
            raise OverflowError(
                f"taylor_expm_apply: term {k} overflowed {v.dtype} storage. The peak intermediate term "
                "grows like exp(|a|*||A||) even when the final result is small (e.g. large negative a "
                "on a PSD operator), and a non-finite input surfaces here too: use a smaller time step, "
                "float64 storage, or the Krylov exponentiator, which never forms the raw series terms."
            )
        if tn < cfg.eps:
            break
        k += 1
    return terms, phase


# ---------------------------------------------------------------------------
# Multi-step evolution at a fixed Krylov dimension, with no host wait
# ---------------------------------------------------------------------------

_EXPM_THETA = 0.5  # the scaled matrix's 1-norm bound for the Taylor stage
_EXPM_TERMS = 18  # Taylor terms: 0.5**19 / 19! ~ 1.6e-23 relative
_EXPM_MAX_SQUARINGS = 30  # 1-norms of a * T up to 0.5 * 2**30


def _krylov_build_fixed(op, v, m: int, full_orth: bool):
    """m-step real Lanczos from (unnormalized) v: returns ``(U (m, n),
    alpha (m,), beta (m,), norm0)``, all on the device.  No convergence
    logic and no host wait."""
    rdtype = real_dtype(v.dtype)
    tiny = torch.finfo(rdtype).tiny
    group = getattr(op, "group", None)
    n = v.shape[0]
    norm0 = linalg.norm(v, group)
    u_buf = torch.zeros((m + 1, n), dtype=v.dtype, device=v.device)
    u_buf[0] = v / torch.clamp(norm0, min=tiny)
    alpha = torch.zeros(m, dtype=rdtype, device=v.device)
    beta = torch.zeros(m, dtype=rdtype, device=v.device)
    for k in range(m):
        u_prev = u_buf[k]
        au = op.matvec(u_prev)
        a_k = linalg.inner_prod(u_prev, au, group).real.to(rdtype)
        w = au - a_k * u_prev
        if k >= 1:
            w = w - beta[k - 1] * u_buf[k - 1]
        if full_orth:  # K3 on CUDA
            w = linalg.orthogonalize_bcgs_dyn(w, u_buf, k + 1, group=group)
        b_k = linalg.norm(w, group).to(rdtype)
        u_buf[k + 1] = w / torch.clamp(b_k, min=tiny)
        alpha[k] = a_k
        beta[k] = b_k
    return u_buf[:m], alpha, beta, norm0


def _expm_first_columns(t):
    """exp(t[b]) e1 for a (B, m, m) complex128 batch, on the device with no
    host wait: Taylor on t / 2**s with s chosen per matrix so that the
    1-norm is at most 0.5, then s squarings, each a batched product kept
    only where its index is below s.  (``torch.linalg.matrix_exp`` reads
    its scaling to the host.)  Returns ``(columns (B, m), too_large)``,
    the last a 0-d bool tensor set when some s exceeded the squaring
    budget."""
    norm1 = t.abs().sum(dim=-2).amax(dim=-1)  # (B,) the 1-norm
    s_real = torch.ceil(torch.log2(torch.nan_to_num(norm1, nan=0.0) / _EXPM_THETA)).clamp(min=0)
    too_large = (s_real > _EXPM_MAX_SQUARINGS).any()
    s = s_real.clamp(max=_EXPM_MAX_SQUARINGS)
    x = t / torch.pow(2.0, s)[:, None, None]
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device).expand_as(t)
    e = eye + x / _EXPM_TERMS  # Horner: I + x/1 (I + x/2 (... (I + x/N)))
    for j in range(_EXPM_TERMS - 1, 0, -1):
        e = eye + (x @ e) / j
    for i in range(_EXPM_MAX_SQUARINGS):
        e = torch.where((s > i)[:, None, None], e @ e, e)
    return e[:, :, 0], too_large


def evolve_split(op, v_re, v_im, a, steps: int, krylov_dim: int = 12, *, full_orth: bool = True,
                 renormalize: bool = False):
    """``steps`` applications of exp(a*A) to (v_re + i v_im) for a real
    operator, with no host wait between steps.

    Each step builds a fixed ``krylov_dim`` real Lanczos basis per part
    (full reorthogonalization through ``linalg.orthogonalize_bcgs_dyn``,
    kernel K3 on CUDA), takes exp(a T) e1 of both small tridiagonals in
    complex128 on the device, and recombines each part as a complex
    product of its real basis.  The per-step Krylov truncation error is
    O((|a| ||A||)^m / m!): pick ``krylov_dim`` ~ 2-4x |a| times the
    spectral radius.  ``renormalize`` divides by the norm after every step
    (unitary evolution).  Returns ``(out_re, out_im)``.
    """
    a = complex(a)
    m = int(krylov_dim)
    vr, vi = v_re, v_im
    flags = []
    for _ in range(int(steps)):
        built = [_krylov_build_fixed(op, v, m, full_orth) for v in (vr, vi)]
        t = torch.stack([torch.diag(al) + torch.diag(be[: m - 1], 1) + torch.diag(be[: m - 1], -1)
                         for _u, al, be, _n in built]).to(torch.complex128)
        cols, too_large = _expm_first_columns(a * t)
        flags.append(too_large)
        outs = []
        for (u, _al, _be, n0), c in zip(built, cols):
            cc = torch.stack([c.real, c.imag]).to(u.dtype)  # (2, m): re, im of the coefficients
            outs.append((cc @ u) * n0)
        (pr, pi), (qr, qi) = outs  # exp(aA) vr = pr + i pi, exp(aA) vi = qr + i qi
        vr, vi = pr - qi, pi + qr
        if renormalize:
            nrm = torch.sqrt(linalg.reduce_sum(torch.sum(vr * vr) + torch.sum(vi * vi), getattr(op, "group", None)))
            vr, vi = vr / nrm, vi / nrm
    if flags and bool(torch.stack(flags).any()):
        raise OverflowError(
            f"evolve: |a| * ||T||_1 exceeded {_EXPM_THETA} * 2**{_EXPM_MAX_SQUARINGS} in a step; "
            "use a smaller time step"
        )
    return vr, vi


def precise_state(v, device):
    """A real state word as a float64 tensor on ``device``, at full
    precision: a float64 host array is taken as it is, never rounded to the
    operator's dtype first (the JAX package's ``evolve(precise=True)``
    lesson: a float32 cast bakes a ~1e-8 error into the initial state)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.is_complex():
        raise TypeError("the precise evolution takes split (re, im) real arrays")
    return t.to(device=device, dtype=torch.float64)


def evolve_split_precise(op, v_re, v_im, a, steps: int, krylov_dim: int = 16, *, renormalize: bool = False):
    """``steps`` applications of exp(a*A) to (v_re + i v_im) at float64
    grade for a real operator: :func:`evolve_split` over the operator's
    ``matvec_f64`` with the state in float64 from the start.  Returns the
    float64 ``(re, im)`` on the operator's device."""
    dev = op.device
    return evolve_split(float64_view(op), precise_state(v_re, dev), precise_state(v_im, dev), a, int(steps),
                        int(krylov_dim), full_orth=True, renormalize=renormalize)


def complex_operator(op):
    """The native complex operator of a complex Hermitian ``op``: a
    ``HermitianSplitOperator``'s :meth:`complex_operator`, or ``op`` itself
    when its dtype is complex; a real operator raises ``TypeError``."""
    if isinstance(op, HermitianSplitOperator):
        return op.complex_operator()
    if not op.dtype.is_complex:
        raise TypeError(f"a complex Hermitian operator is needed here, got a real {op.dtype} one")
    return op


def complex_state(cop, v_re, v_im=None):
    """The complex n-state ``v_re + i v_im`` in ``cop``'s complex dtype on
    its device (complex128 for a float64 operator that an Exponentiator of
    complex dtype runs, as the JAX package's complex vectors through a real
    operator); ``v_re`` alone may be the complex state itself."""
    def tensor(x):
        return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(cop.device)

    re = tensor(v_re)
    if v_im is None:
        return re.to(torch.promote_types(cop.dtype, torch.complex64))
    rdt = real_dtype(cop.dtype)
    return torch.complex(re.to(rdt), tensor(v_im).to(rdt))


def evolve_complex(op, psi, a, steps: int, krylov_dim: int = 12, *, full_orth: bool = True,
                   renormalize: bool = False):
    """``steps`` applications of exp(a*H) to the complex state ``psi`` for
    a complex Hermitian operator, with no host wait between steps: a fixed
    ``krylov_dim`` complex Lanczos build per step (full
    reorthogonalization: kernel K3's complex instance on CUDA), exp(a T) e1
    of its real tridiagonal in complex128 on the device, and the complex
    recombination.  ``renormalize`` divides by the norm after every step.
    Returns the complex state."""
    a = complex(a)
    m = int(krylov_dim)
    flags = []
    for _ in range(int(steps)):
        u, al, be, n0 = _krylov_build_fixed(op, psi, m, full_orth)
        t = (torch.diag(al) + torch.diag(be[: m - 1], 1) + torch.diag(be[: m - 1], -1)).to(torch.complex128)
        cols, too_large = _expm_first_columns(a * t[None])
        flags.append(too_large)
        psi = (cols[0].to(u.dtype) @ u) * n0
        if renormalize:
            psi = psi / linalg.norm(psi, getattr(op, "group", None))
    if flags and bool(torch.stack(flags).any()):
        raise OverflowError(
            f"evolve: |a| * ||T||_1 exceeded {_EXPM_THETA} * 2**{_EXPM_MAX_SQUARINGS} in a step; "
            "use a smaller time step"
        )
    return psi


def evolve_hermitian_split(op, psi_re, psi_im, a, steps: int, krylov_dim: int = 12, *, full_orth: bool = True,
                           renormalize: bool = False):
    """``steps`` applications of exp(a*H) to the complex n-state ``psi_re +
    i psi_im`` of a complex Hermitian ``op`` (a ``HermitianSplitOperator``
    or a complex operator): :func:`evolve_complex` on its complex operator.
    Returns ``(out_re, out_im)`` on the device."""
    cop = complex_operator(op)
    out = evolve_complex(cop, complex_state(cop, psi_re, psi_im), a, steps, krylov_dim, full_orth=full_orth,
                         renormalize=renormalize)
    return out.real, out.imag


def evolve_hermitian_split_precise(op, psi_re, psi_im, a, steps: int, krylov_dim: int = 16, *,
                                   renormalize: bool = False):
    """:func:`evolve_hermitian_split` at float64 grade: the state from
    float64 host words, the build over ``matvec_f64`` and the small
    exponential in complex128.  Returns host float64 ``(re, im)``."""
    cop = complex_operator(op)
    psi = torch.complex(precise_state(psi_re, cop.device), precise_state(psi_im, cop.device))
    out = evolve_complex(float64_view(cop), psi, a, steps, krylov_dim, full_orth=True, renormalize=renormalize)
    return tuple(linalg.gather_rows(t, cop).cpu().numpy() for t in (out.real, out.imag))
