"""Tridiagonal eigensolvers (port of ``lanczos_tpu.core.tridiagonal``; the
reference's L3 layer).

Reference counterparts: the implicit-shift QR
(lambda_lanczos_tridiagonal_impl.hpp:181-343), Sturm bisection (:22-134)
and LAPACK ?stev (lambda_lanczos_tridiagonal_lapack.hpp:22-88).  As in the
JAX package the backend is chosen at run time.

Host backends (numpy in, numpy out, always float64 — the m x m problem is
tiny next to the n-dimensional matvec):

* ``native`` — the implicit-shift QL sweep of the port's C++ library
  (:mod:`lanczos_tpu_torch.native`, built with ``g++`` at first use);
* ``bisect`` — the same library's Sturm bisection eigenvalues with
  backward-recurrence eigenvectors refined by inverse iteration, then
  repaired where they fail (:func:`_repair_bisect_vectors`, fault R8 of
  the reference: clustered or badly conditioned eigenvectors);
* ``lapack`` — scipy's ``eigh_tridiagonal`` (LAPACK stev/steqr);
* ``numpy``  — densify + ``numpy.linalg.eigh``.

``auto`` resolves as in the JAX package: ``native`` when the library
builds and loads, else ``lapack``, else ``numpy``
(:func:`set_default_host_backend` changes the process default).  Asked for
by name, ``native`` and ``bisect`` raise with the compiler's message when
the library does not build.

:func:`extremal_eigenvalues_device` is the Sturm multisection of the JAX
fused engine's convergence test and :func:`convergence_check` that test
whole (breakdown screen, multisection, relative change): on CUDA buffers
each is one launch of kernel K6 (``ops/sturm_check.py``,
``csrc/sturm_check.cu``), on CPU buffers its plain version
(``*_reference``, eager torch ops).  :func:`eigenvectors_backward_device`
gives the backward-recurrence eigenvectors on the buffers' device.

Eigenvector layout matches the reference: ``vecs[k, :]`` is the k-th
eigenvector, eigenvalues ascending (tridiagonal_impl.hpp:177-179, :340).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..native import host_kernels
from ..ops import sturm_check
from .types import machine_eps

__all__ = [
    "eigh_tridiagonal_host",
    "eigvals_tridiagonal_host",
    "extremal_eigvals_host",
    "extremal_eigenvalues_device",
    "extremal_eigenvalues_reference",
    "convergence_check",
    "convergence_check_reference",
    "eigenvectors_backward_device",
    "machine_eps_value",
    "set_default_host_backend",
    "unconverged_total",
]

_BACKENDS = ("auto", "native", "bisect", "lapack", "numpy")
_DEFAULT_HOST_BACKEND = "auto"


def unconverged_total() -> int:
    """Accumulated count of small-solve blocks that hit the native QL
    iteration cap (the reference's forced-break count,
    tridiagonal_impl.hpp:342); ``api.run`` reports the per-run delta.  The
    LAPACK and numpy backends report non-convergence by raising."""
    return host_kernels.consume_unconverged()


def set_default_host_backend(name: str) -> None:
    """Set the process-wide default host backend ('auto', 'native',
    'bisect', 'lapack', 'numpy')."""
    global _DEFAULT_HOST_BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown tridiagonal backend {name!r}")
    _DEFAULT_HOST_BACKEND = name


def _resolve_backend(backend: str | None) -> str:
    backend = backend or _DEFAULT_HOST_BACKEND
    if backend not in _BACKENDS:
        raise ValueError(f"unknown tridiagonal backend {backend!r}")
    if backend != "auto":
        return backend
    if host_kernels.available():
        return "native"
    try:
        import scipy.linalg  # noqa: F401
    except ImportError:  # pragma: no cover
        return "numpy"
    return "lapack"


def eigh_tridiagonal_host(alpha, beta, *, eigvals_only: bool = False, backend: str | None = None):
    """Eigen-decompose the symmetric tridiagonal (diag=alpha, offdiag=beta).

    Returns ``(eigvals,)`` if ``eigvals_only`` else ``(eigvals, eigvecs)``
    with ``eigvecs[k]`` the k-th eigenvector, eigenvalues ascending.
    """
    alpha = np.asarray(alpha, dtype=np.float64).reshape(-1)
    beta = np.asarray(beta, dtype=np.float64).reshape(-1)
    m = alpha.shape[0]
    if beta.shape[0] not in (max(m - 1, 0), m):
        raise ValueError(f"beta must have length m-1 (or m with a trailing slot), got {beta.shape[0]} for m={m}")
    beta = beta[: m - 1]
    if m == 0:
        raise ValueError("empty tridiagonal matrix")
    if m == 1:
        if eigvals_only:
            return (alpha.copy(),)
        return alpha.copy(), np.ones((1, 1), dtype=np.float64)

    backend = _resolve_backend(backend)
    if backend == "native":
        return host_kernels.tridiagonal_eigh(alpha, beta, eigvals_only=eigvals_only)
    if backend == "bisect":
        # Sturm-count eigenvalues and backward-recurrence eigenvectors
        # (tridiagonal_impl.hpp:93-134); _eigh_bisect_np is its plain version.
        vals, vecs = host_kernels.tridiagonal_eigh_bisect(alpha, beta, 0, m)
        return (vals,) if eigvals_only else (vals, _repair_bisect_vectors(alpha, beta, vals, vecs))
    if backend == "lapack":
        from scipy.linalg import eigh_tridiagonal as _stev

        if eigvals_only:
            return (np.asarray(_stev(alpha, beta, eigvals_only=True)),)
        w, z = _stev(alpha, beta)
        # scipy returns column eigenvectors; the reference layout is one row
        # per vector (lambda_lanczos_tridiagonal_lapack.hpp:63-69).
        return np.asarray(w), np.ascontiguousarray(z.T)

    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    if eigvals_only:
        return (np.linalg.eigvalsh(t),)
    w, z = np.linalg.eigh(t)
    return w, np.ascontiguousarray(z.T)


def eigvals_tridiagonal_host(alpha, beta, *, backend: str | None = None):
    """Eigenvalues only (ascending)."""
    return eigh_tridiagonal_host(alpha, beta, eigvals_only=True, backend=backend)[0]


def extremal_eigvals_host(alpha, beta, nroot: int, find_maximum: bool, *, backend: str | None = None):
    """The ``nroot`` smallest (or largest) eigenvalues: ``out[i]`` is the
    i-th largest when ``find_maximum`` else the i-th smallest (the order the
    convergence test consumes).  The native backend bisects only the wanted
    index range (host_kernels.cpp ``lt_tridiagonal_eigvals_bisect``,
    tridiagonal_impl.hpp:63-88); the others take the full spectrum."""
    alpha = np.asarray(alpha, dtype=np.float64).reshape(-1)
    beta = np.asarray(beta, dtype=np.float64).reshape(-1)[: max(alpha.shape[0] - 1, 0)]
    m = alpha.shape[0]
    k = min(int(nroot), m)
    if _resolve_backend(backend) == "native" and m > 1:
        first = m - k if find_maximum else 0
        vals = host_kernels.tridiagonal_eigvals_bisect(alpha, beta, first, k)  # ascending
        return vals[::-1].copy() if find_maximum else vals
    full = eigvals_tridiagonal_host(alpha, beta, backend=backend)
    return full[::-1][:k].copy() if find_maximum else full[:k]


def _eigh_bisect_np(alpha, beta):
    """Plain version of the ``bisect`` backend (the JAX package's numpy
    fallback): numpy eigenvalues, each eigenvector from the backward
    recurrence refined by two inverse iterations."""
    (vals,) = eigh_tridiagonal_host(alpha, beta, eigvals_only=True, backend="numpy")
    vecs = np.stack([
        _inverse_iter_np(alpha, beta, lam, _inverse_iter_np(alpha, beta, lam, _eigvec_backward_np(alpha, beta, lam)))
        for lam in vals
    ])
    return vals, _repair_bisect_vectors(alpha, beta, vals, vecs)


# LAPACK dstein's cluster tolerance (its ORTOL), relative to ||T||_1.
CLUSTER_TOL = 1e-3
# A bisection eigenvector is kept when its residual is at most this times
# ||T||_1 sqrt(m); a repaired one lands near eps ||T||_1.
RESIDUAL_TOL = 1e-14
_REPAIR_ROUNDS = 3  # inverse iterations from a fresh start


def _repair_bisect_vectors(alpha, beta, vals, vecs):
    """The ``bisect`` eigenvectors made right (fault R8 of the reference,
    ROADMAP.md queue 3), given eigenvalues from Sturm bisection, which are
    accurate.

    The backward recurrence gives garbage for an eigenvector whose last
    component is tiny (isolated eigenvalues too: overlaps of 1e-33 with
    the true vector on a seeded m = 128 case), which one inverse iteration
    cannot recover, and two near-equal eigenvalues get the same vector.
    So, as LAPACK's dstein does: the eigenvalues are grouped where
    consecutive gaps fall below ``CLUSTER_TOL * ||T||_1``; every member of
    a group of two or more, and every vector whose residual exceeds
    ``RESIDUAL_TOL * ||T||_1 * sqrt(m)``, is recomputed by
    ``_REPAIR_ROUNDS`` inverse iterations from a seeded random start, each
    preceded by modified Gram-Schmidt against the group's earlier members.
    Then every vector passes classical Gram-Schmidt twice against the
    vectors before it (m^3 work on the host: orthogonality to rounding,
    each residual moved by about its own size).  Returns the rows."""
    m = vals.shape[0]
    if m < 2:
        return vecs
    vecs = np.array(vecs, dtype=np.float64)
    ab = np.abs(beta)
    t_norm = float(np.max(np.abs(alpha) + np.concatenate([[0.0], ab]) + np.concatenate([ab, [0.0]])))
    tv = vecs * alpha[None, :]
    tv[:, :-1] += vecs[:, 1:] * beta[None, :]
    tv[:, 1:] += vecs[:, :-1] * beta[None, :]
    bad = np.linalg.norm(tv - vals[:, None] * vecs, axis=1) > RESIDUAL_TOL * t_norm * np.sqrt(m)
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    shift = np.finfo(np.float64).eps * t_norm  # keeps T - lambda I off exact singularity
    start = 0
    for i in range(1, m + 1):
        if i < m and vals[i] - vals[i - 1] < CLUSTER_TOL * t_norm:
            continue
        for j in range(start, i):
            if i - start == 1 and not bad[j]:
                continue
            lu = sla.lu_factor(t - (vals[j] + shift) * np.eye(m), check_finite=False)
            v = np.random.default_rng(j).uniform(-1.0, 1.0, m)
            for _ in range(_REPAIR_ROUNDS):
                for u in vecs[start:j]:
                    v -= (u @ v) * u
                v = sla.lu_solve(lu, v / np.linalg.norm(v), check_finite=False)
            for u in vecs[start:j]:
                v -= (u @ v) * u
            vecs[j] = v / np.linalg.norm(v)
        start = i
    for j in range(1, m):
        v = vecs[j] - (vecs[:j] @ vecs[j]) @ vecs[:j]
        v = v - (vecs[:j] @ v) @ vecs[:j]
        vecs[j] = v / np.linalg.norm(v)
    return vecs


def _eigvec_backward_np(alpha, beta, lam):
    """Backward three-term-recurrence eigenvector (numpy; the contract of
    the native ``lt_tridiagonal_eigvec_backward``)."""
    m = alpha.shape[0]
    eps = np.finfo(np.float64).eps
    v = np.zeros(m, np.float64)
    v[m - 1] = 1.0
    if m > 1:
        b = beta[m - 2] if beta[m - 2] != 0 else eps
        v[m - 2] = (lam - alpha[m - 1]) / b
        for k in range(m - 2, 0, -1):
            bkm1 = beta[k - 1] if beta[k - 1] != 0 else eps
            w = ((lam - alpha[k]) * v[k] - beta[k] * v[k + 1]) / bkm1
            if abs(w) > 1e100:
                v[k:] /= abs(w)
                w = np.sign(w) * 1.0
            v[k - 1] = w
    nrm = np.linalg.norm(v)
    return v / nrm if nrm > 0 else v


def _inverse_iter_np(alpha, beta, lam, v):
    """One inverse-iteration refinement: a dense solve with a pivot-floor
    shift (m is the small Krylov dimension; the native path does the O(m)
    pivoted solve)."""
    m = alpha.shape[0]
    t = np.diag(alpha) + (np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1) if m > 1 else 0)
    scale = max(np.max(np.abs(alpha)), np.max(np.abs(beta)) if beta.size else 0.0, 1.0)
    shift = lam + np.finfo(np.float64).eps * scale
    try:
        w = np.linalg.solve(t - shift * np.eye(m), v)
    except np.linalg.LinAlgError:
        return v
    nrm = np.linalg.norm(w)
    return w / nrm if (nrm > 0 and np.isfinite(nrm)) else v


def _sturm_counts(cs, alpha, beta_sq, size: int):
    """Eigenvalue counts below each point of ``cs`` (tridiagonal_impl.hpp:22-43).

    The leading principal minors obey the linear two-term recurrence
    ``d_k = (a_{k-1} - c) d_{k-1} - b2_{k-2} d_{k-2}``, i.e.
    ``[d_k, d_{k-1}] = M_k [d_{k-1}, d_{k-2}]``, so all minors come from a
    prefix product of 2x2 matrices.  The prefix is a log-depth doubling
    (Hillis-Steele) loop: step s multiplies each partial product by the one
    s rows earlier.  Every product is elementwise multiply-adds — never a
    matmul, whose TF32 path on the card (like bf16 on the TPU) would fuzz
    the minor signs — and each is rescaled by its max-abs entry, a positive
    scalar, so the signs the count needs are exact.  Rows past ``size`` are
    the identity.

    cs: (K,) points; alpha, beta_sq: (cap,); returns (K,) int32 counts.
    """
    dtype = alpha.dtype
    tiny = torch.finfo(dtype).tiny
    cap = alpha.shape[0]
    active = (torch.arange(cap, device=alpha.device) < size)[:, None]  # (cap, 1)

    a_c = alpha[:, None] - cs[None, :]  # (cap, K)
    b2 = torch.cat([beta_sq.new_zeros(1), beta_sq[: cap - 1]])[:, None].expand_as(a_c)
    zeros = torch.zeros_like(a_c)
    ones = torch.ones_like(a_c)
    # The four entries [[a, b], [c, d]] of each row's 2x2 matrix, (cap, K) each.
    a = torch.where(active, a_c, ones)
    b = torch.where(active, -b2, zeros)
    c = torch.where(active, ones, zeros)
    d = torch.where(active, zeros, ones)

    shift = 1
    while shift < cap:
        # z = y @ x with y the later partial product and x the earlier one
        # (applied first).
        ya, yb, yc, yd = a[shift:], b[shift:], c[shift:], d[shift:]
        xa, xb, xc, xd = a[:-shift], b[:-shift], c[:-shift], d[:-shift]
        za = ya * xa + yb * xc
        zb = ya * xb + yb * xd
        zc = yc * xa + yd * xc
        zd = yc * xb + yd * xd
        scale = torch.maximum(torch.maximum(za.abs(), zb.abs()), torch.maximum(zc.abs(), zd.abs())).clamp_min_(tiny)
        a = torch.cat([a[:shift], za.div_(scale)])
        b = torch.cat([b[:shift], zb.div_(scale)])
        c = torch.cat([c[:shift], zc.div_(scale)])
        d = torch.cat([d[:shift], zd.div_(scale)])
        shift *= 2

    # [d_k, d_{k-1}] = P_k [1, 0]^T = [a, c].  q_k = d_k / d_{k-1} < 0 <=> a
    # sign change; an exactly-zero leading minor counts as +1 (the
    # reference's +eps substitution, tridiagonal_impl.hpp:37-39).
    d_k = a
    s_km1 = torch.sign(c)
    s_km1 = torch.where(s_km1 == 0, torch.ones_like(s_km1), s_km1)
    neg = (torch.sign(d_k) * s_km1) < 0
    return (neg & active).sum(dim=0).to(torch.int32)


def _rounds(dtype, iters, points) -> int:
    if iters is None:
        iters = 110 if dtype == torch.float64 else 46
    return int(np.ceil(iters / np.log2(points + 1)))


def _limit(alpha, beta, size):
    """The masked off-diagonal and the bound ``sum |alpha| + 2 sum |beta|``
    of the leading ``size`` x ``size`` block, by the torch ops the plain
    version has always used (K6 gets ``limit`` from here, so the two start
    from the same bits on one device)."""
    dtype = alpha.dtype
    cap = alpha.shape[0]
    ar = torch.arange(cap, device=alpha.device)
    mask = (ar < size).to(dtype)
    beta_masked = beta * (ar < size - 1).to(dtype)
    limit = torch.sum(alpha.abs() * mask) + 2.0 * torch.sum(beta_masked.abs())
    return beta_masked, limit


def extremal_eigenvalues_device(alpha, beta, size: int, nroot: int, find_maximum: bool, *, iters: int | None = None, points: int = 15):
    """The ``nroot`` smallest (or largest) eigenvalues of the leading
    ``size`` x ``size`` block of the tridiagonal in the (cap,) buffers
    ``alpha``/``beta``, by Sturm multisection over the Gershgorin-style
    interval ``|lambda| <= m_norm(alpha) + 2 m_norm(beta)``
    (tridiagonal_impl.hpp:52-58, :63-88).

    Each round evaluates ``points`` equally spaced cuts per root, shrinking
    every bracket (points+1)-fold; ``iters`` is given in equivalent
    bisection halvings (default 46 for float32, 110 for float64).

    Returns (nroot,) in the buffers' dtype and device: ``result[i]`` is the
    i-th largest eigenvalue when ``find_maximum`` else the i-th smallest;
    roots with index >= ``size`` repeat the closest valid root.  CUDA
    buffers go to kernel K6 (``ops/sturm_check.py``, one launch; a failed
    build or launch raises), CPU buffers to
    :func:`extremal_eigenvalues_reference`, its plain version; the two give
    the same bits on one device.
    """
    if alpha.device.type != "cuda":
        return extremal_eigenvalues_reference(alpha, beta, size, nroot, find_maximum, iters=iters, points=points)
    size = int(size)
    _, limit = _limit(alpha, beta, size)
    return sturm_check.sturm_check(alpha, beta, limit, size=size, nroot=int(nroot), find_maximum=find_maximum,
                                   rounds=_rounds(alpha.dtype, iters, points), points=points)


def extremal_eigenvalues_reference(alpha, beta, size: int, nroot: int, find_maximum: bool, *, iters: int | None = None, points: int = 15):
    """Plain PyTorch version of :func:`extremal_eigenvalues_device` (and of
    K6), on the buffers' device: eager torch ops, dozens a doubling step."""
    dtype = alpha.dtype
    dev = alpha.device
    rounds = _rounds(dtype, iters, points)
    beta_masked, limit = _limit(alpha, beta, size)
    beta_sq = beta_masked**2

    idx = torch.arange(nroot, device=dev)
    if find_maximum:
        m_indices = (size - 1 - idx).clamp_min(0)
    else:
        m_indices = idx.clamp_max(size - 1)

    fracs = (torch.arange(1, points + 1, device=dev, dtype=dtype) / (points + 1))[:, None]  # (P, 1)
    lower = (-limit).expand(nroot).clone()
    upper = limit.expand(nroot).clone()
    for _ in range(rounds):
        pts = torch.minimum(torch.maximum(lower + fracs * (upper - lower), lower), upper)  # (P, nroot)
        smaller = _sturm_counts(pts.reshape(-1), alpha, beta_sq, size).reshape(points, nroot)
        ge = smaller >= m_indices + 1  # the target root lies below the point
        # Counts are monotone in the point, so the new bracket is the
        # smallest ge point and the largest non-ge point.
        upper = torch.where(ge, pts, upper).amin(dim=0)
        lower = torch.where(ge, lower, pts).amax(dim=0)
    return lower


def convergence_check(alpha, beta, evs_prev, *, screened: int, k: int, nroot: int, find_maximum: bool, eps: float,
                      breakdown_eps: float, have_prev: bool):
    """The fused engine's convergence check of iteration ``k`` on the
    (cap,) buffers' device, with no host read: returns an int32 tensor
    (stop, itern) of two values there, stop 0 (go on), 1 (a breakdown) or
    2 (converged).

    The first ``beta[screened:k] < breakdown_eps`` stops the build at that
    iteration (itern = its index + 1).  Otherwise, unless ``eps == 0`` (no
    test), the extremal eigenvalues of the leading k x k block are tested
    against ``evs_prev`` by the relative change ``|evs - prev| < min(|evs|,
    |prev|) eps`` and replace it in place; the build stops at k (itern =
    k) when that holds for every root, ``have_prev`` and ``eps > 0``
    (``eps < 0``: the check runs and never stops).  CUDA buffers go to kernel K6 (one launch
    after the bound's few torch ops), CPU buffers to
    :func:`convergence_check_reference`."""
    if alpha.device.type != "cuda":
        return convergence_check_reference(alpha, beta, evs_prev, screened=screened, k=k, nroot=nroot,
                                           find_maximum=find_maximum, eps=eps, breakdown_eps=breakdown_eps,
                                           have_prev=have_prev)
    out = torch.empty(2, dtype=torch.int32, device=alpha.device)
    if eps == 0.0:
        return sturm_check.sturm_check(alpha, beta, None, size=k, nroot=nroot, find_maximum=find_maximum, rounds=0,
                                       mode="screen", out=out, screened=screened, k=k, breakdown_eps=breakdown_eps)
    _, limit = _limit(alpha[:k], beta[:k], k)
    return sturm_check.sturm_check(alpha, beta, limit, size=k, nroot=nroot, find_maximum=find_maximum,
                                   rounds=_rounds(alpha.dtype, None, 15), mode="check", evs=evs_prev, out=out,
                                   screened=screened, k=k, breakdown_eps=breakdown_eps, eps=eps,
                                   gate=have_prev and eps > 0)


def convergence_check_reference(alpha, beta, evs_prev, *, screened: int, k: int, nroot: int, find_maximum: bool,
                                eps: float, breakdown_eps: float, have_prev: bool):
    """Plain PyTorch version of :func:`convergence_check` (and of K6's check
    mode), on the buffers' device."""
    broke = torch.nonzero(beta[screened:k] < breakdown_eps)
    if broke.numel():
        return torch.tensor([1, screened + int(broke[0, 0]) + 1], dtype=torch.int32, device=alpha.device)
    if eps == 0.0:  # sentinel: no convergence test (JAX engine semantics)
        return torch.zeros(2, dtype=torch.int32, device=alpha.device)
    # The leading k entries only: the JAX engine passes its whole buffer,
    # whose rows past k the Sturm count treats as the identity.
    evs = extremal_eigenvalues_reference(alpha[:k], beta[:k], k, nroot, find_maximum)
    eps_t = torch.tensor(eps, dtype=alpha.dtype, device=alpha.device)
    rel_ok = bool(torch.all((evs - evs_prev).abs() < torch.minimum(evs.abs(), evs_prev.abs()) * eps_t))
    converged = have_prev and rel_ok and eps > 0
    evs_prev.copy_(evs)
    return torch.tensor([2, k] if converged else [0, 0], dtype=torch.int32, device=alpha.device)


def eigenvectors_backward_device(alpha, beta, size, lams):
    """Eigenvectors of the leading ``size`` x ``size`` block of the
    tridiagonal in the (cap,) buffers ``alpha``/``beta`` for the given
    (converged) eigenvalues ``lams``, on the buffers' device with no host
    read (the reference's bisection eigenvector path,
    tridiagonal_impl.hpp:93-115).

    For each eigenvalue the backward three-term recurrence from the last
    row, ``v[size-1] = 1``, ``v[k-1] = ((lam - alpha[k]) v[k] - beta[k]
    v[k+1]) / beta[k-1]``, runs over the static capacity with the dynamic
    active ``size`` (an int or a 0-d tensor); overflow is carried as a
    log-scale (components are ``u * exp(logscale)``, and the final
    renormalization subtracts the largest, so the negligible entries of a
    graded eigenvector underflow to 0).  Returns (K, cap) rows, zero past
    ``size`` and 2-normalized.  Meant for well-separated Ritz values, as
    the reference's recurrence is.
    """
    dtype, dev = alpha.dtype, alpha.device
    cap = alpha.shape[0]
    eps = torch.finfo(dtype).eps
    big = 1e15 if dtype == torch.float32 else 1e100
    size = torch.as_tensor(size, device=dev)
    lams = torch.as_tensor(lams, device=dev).to(dtype).reshape(-1)
    zero = lams.new_zeros(())
    u_prev, u_pp, ls = torch.ones_like(lams), torch.zeros_like(lams), torch.zeros_like(lams)
    us, lss = [u_prev], [ls]  # u_j and its log-scale, j = 0 .. cap-1
    for j in range(1, cap):
        a_k = alpha[(size - j).clamp(0, cap - 1)]
        b_k = zero if j == 1 else beta[(size - j).clamp(0, cap - 1)]
        b_km1 = beta[(size - 1 - j).clamp(0, cap - 1)]
        b_km1 = torch.where(b_km1 == 0, eps, b_km1)
        w = ((lams - a_k) * u_prev - b_k * u_pp) / b_km1
        mag = w.abs()
        rescale = mag > big
        scale = torch.where(rescale, 1.0 / mag.clamp(min=eps), 1.0)
        ls_new = ls + torch.where(rescale, torch.log(mag.clamp(min=eps)), 0.0)
        w = w * scale
        active = j <= size - 1
        u_prev, u_pp, ls = (torch.where(active, w, u_prev), torch.where(active, u_prev * scale, u_pp),
                            torch.where(active, ls_new, ls))
        us.append(torch.where(active, w, zero))
        lss.append(ls)
    u, ls = torch.stack(us, dim=1), torch.stack(lss, dim=1)  # (K, cap)
    # v[p] = u[size-1-p] * exp(ls[size-1-p] - max ls) for p < size.
    p = torch.arange(cap, device=dev)
    jidx = (size - 1 - p).clamp(0, cap - 1)
    in_range = p < size
    ls_p = torch.where(in_range, ls[:, jidx], -torch.inf)
    ls_max = ls_p.amax(dim=1, keepdim=True)
    ls_max = torch.where(torch.isfinite(ls_max), ls_max, 0.0)
    v = torch.where(in_range, u[:, jidx] * torch.exp(ls_p - ls_max), zero)
    return v / torch.sqrt(torch.sum(v * v, dim=1, keepdim=True)).clamp(min=eps)


def machine_eps_value(dtype) -> float:
    """Machine epsilon of ``dtype`` (a torch or numpy dtype; a complex
    dtype's is its real part's), as a Python float."""
    return machine_eps(dtype)
