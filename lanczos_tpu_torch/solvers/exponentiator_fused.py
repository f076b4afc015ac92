"""The device-resident Krylov exponentiator (port of
``lanczos_tpu.solvers.exponentiator_fused``: ``krylov_expm_apply_fused`` and
``krylov_expm_apply_batch``; the module's split-complex names,
``krylov_expm_apply_split``, ``evolve_split`` and ``evolve_hermitian_split``,
are :mod:`.exponentiator`'s, exported here at the JAX module's path).

The hybrid build (:func:`.exponentiator.krylov_expm_apply`) waits for the
device once per iteration: the host needs alpha_k and beta_k for its
tridiagonal solve and stop test.  Here the build queues a whole stage of
iterations with no host read, each with the hybrid step's arithmetic in
its order (so the basis rows are the hybrid's), then reads the alphas and
the betas in one transfer and replays the stop test on the host over
every new prefix, as the hybrid runs it, breakdown exit included.  When no
prefix passes, the capacity grows 4x (up to ``max_iteration``) and the
build resumes where it stopped; no matvec is repeated.  The first
capacity is ``initial_buffer_size``, at least 8.

The replayed test is the port's (:func:`.exponentiator._coefficients_settled`;
R7 in ROADMAP.md), not the JAX replay's overlap test, so the iteration
counts are the hybrid's.  A stage runs past the stop, and past a
breakdown, where rows divided by a tiny beta may overflow: only the rows
below the stopping index reach the output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import linalg
from ..core.types import machine_eps, real_dtype
from .exponentiator import (
    ExponentiatorConfig,
    _coefficients_settled,
    _expm_update,
    _krylov_coefficients,
    _recombine,
    evolve_hermitian_split,
    evolve_split,
    krylov_expm_apply_split,
)

__all__ = [
    "krylov_expm_apply_fused", "krylov_expm_apply_batch",
    "krylov_expm_apply_split", "evolve_split", "evolve_hermitian_split",
]


@dataclasses.dataclass
class _BuildState:
    """One build on the device; the host knows only how far it is queued."""

    u_buf: torch.Tensor  # (cap+1, n): row 0 the normalized input, row k the k-th Lanczos vector
    alpha: torch.Tensor  # (cap,)
    beta: torch.Tensor  # (cap,)
    queued: int = 0  # iterations queued so far, past a breakdown too


def _new_state(u0, cap: int) -> _BuildState:
    u_buf = torch.zeros((cap + 1, u0.shape[0]), dtype=u0.dtype, device=u0.device)
    u_buf[0] = u0
    zeros = torch.zeros(cap, dtype=real_dtype(u0.dtype), device=u0.device)
    return _BuildState(u_buf, zeros, zeros.clone())


def _build(op, s: _BuildState, m_target: int, full_orth: bool) -> None:
    """Queue iterations ``s.queued + 1 .. m_target`` with no host read: one
    matvec each, and K3 when ``full_orth``."""
    for k in range(s.queued + 1, m_target + 1):
        beta_prev = s.beta[k - 2] if k >= 2 else None
        s.alpha[k - 1], s.beta[k - 1] = _expm_update(s.u_buf, k, op.matvec(s.u_buf[k - 1]), beta_prev, full_orth,
                                                     getattr(op, "group", None))
    s.queued = m_target


def _grow_state(s: _BuildState, new_cap: int) -> _BuildState:
    n, cap = s.u_buf.shape[1], s.alpha.shape[0]
    u_buf = s.u_buf.new_zeros((new_cap + 1, n))
    u_buf[: cap + 1] = s.u_buf
    pad = s.alpha.new_zeros(new_cap - cap)
    return _BuildState(u_buf, torch.cat([s.alpha, pad]), torch.cat([s.beta, pad]), s.queued)


def _read(s: _BuildState):
    """The stage's one host transfer: ``(alphas, betas)`` of the queued
    iterations as float64 arrays."""
    packed = torch.cat([s.alpha[: s.queued], s.beta[: s.queued]]).double().cpu().numpy()
    return packed[: s.queued], packed[s.queued :]


def _replay_convergence(a_check, alphas, betas, eps: float, backend, beta_eps: float, start=(1, None)):
    """The hybrid build's stop test replayed over the prefixes ``start[0]
    .. len(alphas)``: the coefficients at prefix k use ``alphas[:k]`` and
    ``betas[:k-1]`` (exponentiator.hpp:124-145), the test comes first and
    the breakdown exit, the first beta below the storage dtype's eps, after
    it (:147-158).  ``start`` is ``(first prefix, coefficients before it)``
    from an earlier stage.  Returns ``(k*, coefficients at k*)``, or
    ``(None, coefficients at the last prefix)``."""
    k0, coeff_prev = start
    for k in range(k0, len(alphas) + 1):
        coeff = _krylov_coefficients(a_check, alphas[:k], betas[: k - 1], backend)
        if coeff_prev is not None and _coefficients_settled(coeff_prev, coeff, eps):
            return k, coeff
        if betas[k - 1] < beta_eps:
            return k, coeff
        coeff_prev = coeff
    return None, coeff_prev


def _setup(a, dtype, cfg: ExponentiatorConfig):
    cfg = cfg.resolved(dtype)
    max_iter = min(cfg.max_iteration, max(cfg.matrix_size, 1))
    if max_iter < 1:
        raise ValueError(f"max_iteration must be >= 1, got {cfg.max_iteration}")
    a = complex(a)
    a_host = a if (a.imag != 0 or dtype.is_complex) else a.real
    return cfg, max_iter, a_host


def _apply(op, v, input_norm, a_host, cfg: ExponentiatorConfig, max_iter: int):
    """Build from ``v / input_norm`` a stage at a time, one host read per
    stage, until the replay stops or the build reaches ``max_iter``; returns
    ``(input_norm * coeff @ u_buf[:k*], k*)``: the rows past the stop never
    enter."""
    state = _new_state(v / input_norm, min(max(cfg.initial_buffer_size, 8), max_iter))
    beta_eps = machine_eps(v.dtype)
    resume = (1, None)
    while True:
        m_target = state.alpha.shape[0]
        _build(op, state, m_target, cfg.full_orthogonalize)
        alphas, betas = _read(state)
        kstar, coeff = _replay_convergence(a_host, alphas, betas, cfg.eps, cfg.tridiag_backend, beta_eps,
                                           start=resume)
        if kstar is None and m_target >= max_iter:
            kstar = m_target
        if kstar is not None:
            return _recombine(coeff[None], state.u_buf[:kstar], input_norm)[0], kstar
        resume = (m_target + 1, coeff)
        state = _grow_state(state, min(4 * m_target, max_iter))


def krylov_expm_apply_fused(op, a, v, cfg: ExponentiatorConfig):
    """exp(a*A) v with the device-resident build; returns ``(output,
    iteration_count)``, the count of the hybrid build.  A zero input returns
    zeros and 0 iterations."""
    cfg, max_iter, a_host = _setup(a, v.dtype, cfg)
    input_norm = linalg.norm(v, getattr(op, "group", None))
    if float(input_norm) == 0.0:
        return torch.zeros_like(v), 0
    return _apply(op, v, input_norm, a_host, cfg, max_iter)


def krylov_expm_apply_batch(op, a, v_batch, cfg: ExponentiatorConfig):
    """exp(a*A) applied to every row of the (B, n) ``v_batch``: the row norms
    in one host read, then :func:`krylov_expm_apply_fused`'s build on each
    row, so each row's iteration count and output are those of ``run`` on
    it.  A row of norm below 10 * tiny launches nothing and returns zeros
    with 1 iteration (the JAX batch's trivial rows); a NaN row is built and
    comes back NaN.  Returns ``(out (B, n), iterations (B,))``."""
    dtype = v_batch.dtype
    cfg, max_iter, a_host = _setup(a, dtype, cfg)
    norms = [linalg.norm(row, getattr(op, "group", None)) for row in v_batch]
    tiny = torch.finfo(real_dtype(dtype)).tiny
    out_dtype = torch.promote_types(dtype, torch.complex64) if isinstance(a_host, complex) else dtype
    out = torch.zeros(v_batch.shape, dtype=out_dtype, device=v_batch.device)
    iters = np.ones(v_batch.shape[0], dtype=np.int64)
    for i, x in enumerate(torch.stack(norms).tolist() if norms else []):
        if not x < 10 * tiny:
            out[i], iters[i] = _apply(op, v_batch[i], norms[i], a_host, cfg, max_iter)
    return out, iters
