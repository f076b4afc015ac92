"""Tridiagonal eigensolvers (port of ``lanczos_tpu.core.tridiagonal``,
main-path subset; the reference's L3 layer).

Host backends (numpy in, numpy out, always float64 — the m x m problem is
tiny next to the n-dimensional matvec):

* ``lapack`` — scipy's ``eigh_tridiagonal`` (LAPACK stev/steqr);
* ``numpy``  — densify + ``numpy.linalg.eigh``.

``auto`` resolves to ``lapack`` (``numpy`` where scipy is missing).  The
JAX package's native C++ QL and bisection backends are not ported yet
(ROADMAP.md, "Modules to port").

:func:`extremal_eigenvalues_device` is the Sturm multisection of the JAX
fused engine's convergence test.  The port runs it eagerly on whatever
device its tensors are on; the fused engine hands it CPU tensors, because
its dozens of tiny elementwise steps would each be one kernel launch on the
card.

Eigenvector layout matches the reference: ``vecs[k, :]`` is the k-th
eigenvector, eigenvalues ascending (tridiagonal_impl.hpp:177-179, :340).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "eigh_tridiagonal_host",
    "eigvals_tridiagonal_host",
    "extremal_eigvals_host",
    "extremal_eigenvalues_device",
    "unconverged_total",
]

_NATIVE_ITEM = "ROADMAP.md, 'Modules to port': core/tridiagonal.py native QL backend"


def unconverged_total() -> int:
    """Accumulated count of small-solve blocks that hit the native QL
    iteration cap.  Only the native backend counts them (the LAPACK and
    numpy backends report convergence by raising), and it is not ported, so
    this is 0; ``api.run`` reports the per-run delta all the same."""
    return 0


def _resolve_backend(backend: str | None) -> str:
    backend = backend or "auto"
    if backend == "auto":
        try:
            import scipy.linalg  # noqa: F401
        except ImportError:  # pragma: no cover
            return "numpy"
        return "lapack"
    if backend in ("native", "bisect"):
        raise NotImplementedError(f"tridiagonal backend {backend!r} is not ported; see {_NATIVE_ITEM}")
    if backend not in ("lapack", "numpy"):
        raise ValueError(f"unknown tridiagonal backend {backend!r}")
    return backend


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

    if _resolve_backend(backend) == "lapack":
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
    convergence test consumes)."""
    alpha = np.asarray(alpha, dtype=np.float64).reshape(-1)
    beta = np.asarray(beta, dtype=np.float64).reshape(-1)[: max(alpha.shape[0] - 1, 0)]
    k = min(int(nroot), alpha.shape[0])
    full = eigvals_tridiagonal_host(alpha, beta, backend=backend)
    return full[::-1][:k].copy() if find_maximum else full[:k]


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
    roots with index >= ``size`` repeat the closest valid root.
    """
    dtype = alpha.dtype
    dev = alpha.device
    if iters is None:
        iters = 110 if dtype == torch.float64 else 46
    rounds = int(np.ceil(iters / np.log2(points + 1)))
    cap = alpha.shape[0]
    ar = torch.arange(cap, device=dev)
    mask = (ar < size).to(dtype)
    beta_masked = beta * (ar < size - 1).to(dtype)
    beta_sq = beta_masked**2
    limit = torch.sum(alpha.abs() * mask) + 2.0 * torch.sum(beta_masked.abs())

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
