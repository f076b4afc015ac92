"""Fused Lanczos engine (port of ``lanczos_tpu.solvers.lanczos_fused``).

The JAX engine runs the whole Krylov build as one ``lax.while_loop`` on the
device.  PyTorch has no device while-loop, so here the loop is Python and
every iteration's work is queued on the operator's device without waiting:
matvec (kernel K1 for a :class:`BSROperator`, K2 for a sharded one), alpha,
the three-term recurrence, the deflation projection, the basis
reorthogonalization (kernel K3) and beta, with alpha/beta written into
device buffers.  The host waits
for the device once per convergence check, every ``convergence_check_interval``
iterations and at each stage's capacity, as the JAX loop's checks fall:

* it pulls the alpha/beta buffers, finds the first ``beta < breakdown_eps``
  since the last check and, if there is one, stops the build *at* that
  iteration, as the JAX loop does (lanczos_fused.py:402, :422-427); the
  iterations queued after it are discarded;
* otherwise it runs :func:`~lanczos_tpu_torch.core.tridiagonal.extremal_eigenvalues_device`
  on CPU tensors of the JAX engine's dtype, and stops on the same
  relative-change test.

Capacity is staged as in the JAX engine: the build starts with a small
buffer and grows it fourfold, resuming without repeating a matvec.  The
thick-restart engine (``thick_restart.thick_lanczos_iteration_fused``) runs
its cycles on the same build state (``_Build``, reset in place per cycle)
and stage (``_run_stage`` with its own ``k_lim``), as the JAX engine reuses
``_fused_stage``.

For float32 storage the JAX engine carries alpha and ||w||^2 as df64 word
pairs.  The port takes float64 dot products of the float32 vectors instead
(every product is exact there): the recurrence uses alpha rounded to float32
and the host Ritz solve gets the float64 values.

Under ``reorth_policy='selective'`` the omega recurrence needs alpha and
beta each iteration, so that policy waits for the device once per iteration
and evaluates the recurrence on the host in the JAX engine's dtype; a
triggered pass runs kernel K3 as the full policy does.  (The JAX engine
kept its Pallas pass out of the ``lax.cond`` at that site for a measured
slowdown that eager execution does not have.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import linalg, tridiagonal
from ..core.types import machine_eps, real_dtype, to_numpy_dtype
from .lanczos import LanczosConfig, _prepare_init_vector, _ritz_combine

__all__ = ["lanczos_iteration_fused", "fused_krylov", "reorth_total"]

_PV_ITEM = "ROADMAP.md, 'Modules to port', item 10: precise paths on native float64"

# Cumulative basis-reorthogonalization count across fused solves in this
# process; api.run snapshots it around a run to fill RunStats.reorth_count.
_REORTH_TOTAL = 0


def reorth_total() -> int:
    return _REORTH_TOTAL


def _add_reorth(n) -> None:
    global _REORTH_TOTAL
    _REORTH_TOTAL += int(n)


class _Build:
    """State of one Krylov build (the JAX engine's ``_LoopState``)."""

    def __init__(self, v0, cap: int, nroot: int, precise: bool):
        dev = v0.device
        self.rdtype = real_dtype(v0.dtype)
        self.nroot = int(nroot)
        self.u = torch.zeros((cap + 1, v0.shape[0]), dtype=v0.dtype, device=dev)
        self.alpha = torch.zeros(cap, dtype=self.rdtype, device=dev)
        self.beta = torch.zeros(cap, dtype=self.rdtype, device=dev)
        # float64 alpha and ||w||^2 (precise reductions) for the host solve
        self.wide = torch.zeros((2, cap), dtype=torch.float64, device=dev) if precise else None
        self.reset(v0)

    def reset(self, v0) -> None:
        """Start a new build from ``v0`` in the same buffers (thick-restart
        cycles): rows and coefficients past the new live counts are stale and
        never read."""
        self.u[0] = v0
        cap = self.cap
        self.k = 1  # next iteration (1-based)
        self.screened = 0  # iterations whose beta has been checked for breakdown
        self.evs_prev = torch.full((self.nroot,), float("inf"), dtype=self.rdtype)
        self.have_prev = False
        self.stop = False
        self.itern = 0
        self.triggers: list[bool] = []  # per iteration: basis reorthogonalized?
        # selective policy: omega recurrence on the host (JAX engine dtype)
        npd = to_numpy_dtype(self.rdtype)
        self.omega = np.zeros(cap + 1, npd)
        self.omega[0] = 1.0  # w_0(0) = 1
        self.omega_prev = np.zeros(cap + 1, npd)
        self.force_reorth = False
        self.alpha_h = np.zeros(cap, npd)
        self.beta_h = np.zeros(cap, npd)

    @property
    def done(self) -> int:
        """Iterations of the build so far: up to a breakdown or convergence
        stop, else every one run."""
        return self.itern if self.stop else self.k - 1

    @property
    def cap(self) -> int:
        return self.alpha.shape[0]

    def grow(self, new_cap: int) -> None:
        u = self.u.new_zeros((new_cap + 1, self.u.shape[1]))
        u[: self.u.shape[0]] = self.u
        self.u = u
        for name in ("alpha", "beta"):
            t = getattr(self, name)
            g = t.new_zeros(new_cap)
            g[: t.shape[0]] = t
            setattr(self, name, g)
        if self.wide is not None:
            g = self.wide.new_zeros((2, new_cap))
            g[:, : self.wide.shape[1]] = self.wide
            self.wide = g
        for name, size in (("omega", new_cap + 1), ("omega_prev", new_cap + 1), ("alpha_h", new_cap), ("beta_h", new_cap)):
            t = getattr(self, name)
            setattr(self, name, np.concatenate([t, np.zeros(size - t.shape[0], t.dtype)]))


def _omega_step(st: _Build, k: int, alpha_k, beta_t, b):
    """Simon's omega recurrence for iteration k on host arrays of the JAX
    engine's dtype (lanczos_fused.py:347-383); returns (trigger, w_new)."""
    npd = st.omega.dtype
    eps_m = npd.type(machine_eps(st.rdtype))
    tiny = npd.type(np.finfo(npd).tiny)
    cap = st.cap
    j = np.arange(cap + 1)
    a_vec = np.concatenate([st.alpha_h, np.zeros(1, npd)])
    b_vec = np.concatenate([st.beta_h, np.zeros(1, npd)])
    b_jm1 = np.concatenate([np.zeros(1, npd), st.beta_h])
    om_p1 = np.roll(st.omega, -1)
    om_m1 = np.roll(st.omega, 1)
    noise = eps_m * (b_vec + beta_t)
    w_new = (b_vec * om_p1 + (a_vec - alpha_k) * st.omega + b_jm1 * om_m1 - b * st.omega_prev) / max(beta_t, tiny) + noise
    w_new = np.abs(w_new)
    # Boundary rows: w_k(k-1) ~ eps, w_k(k) = 1, nothing beyond k.
    w_new = np.where(j == k - 1, eps_m, w_new)
    w_new = np.where(j == k, npd.type(1.0), w_new)
    w_new = np.where(j > k, npd.type(0.0), w_new)
    w_new = np.maximum(w_new, np.where(j <= k, eps_m, npd.type(0.0))).astype(npd)
    drift = np.max(np.where(j <= k - 2, w_new, npd.type(0.0)))
    trigger = bool(drift > np.sqrt(eps_m)) or st.force_reorth
    return trigger, w_new


def _iterate(op, st: _Build, defl, defl_mask, offset: float, passes: int, selective: bool) -> None:
    """Queue iteration k = st.k on the device (waits only under 'selective')."""
    k = st.k
    rdtype = st.rdtype
    group = getattr(op, "group", None)  # row slabs: every reduction all-reduces
    u_prev = st.u[k - 1]
    au = op.matvec(u_prev)
    if offset != 0.0:
        au = au + offset * u_prev
    if st.wide is not None:
        a64 = linalg.inner_prod_f64(u_prev, au, group).real
        alpha_k = a64.to(rdtype)
    else:
        alpha_k = linalg.inner_prod(u_prev, au, group).real.to(rdtype)
    w = au - alpha_k * u_prev
    if k >= 2:
        w = w - st.beta[k - 2] * st.u[k - 2]
    w = linalg.orthogonalize_cgs2(w, defl, defl_mask, passes=passes, group=group)

    if not selective:
        w = linalg.orthogonalize_bcgs_dyn(w, st.u, k, passes=passes, group=group)
        st.triggers.append(True)
    else:
        beta_t = linalg.norm(w, group).to(rdtype)
        prev = st.beta[k - 2] if k >= 2 else torch.zeros((), dtype=rdtype, device=w.device)
        a_h, bt_h, bprev_h = torch.stack([alpha_k, beta_t, prev]).cpu().numpy()
        if k >= 2:
            st.beta_h[k - 2] = bprev_h
        trigger, w_new = _omega_step(st, k, a_h, bt_h, bprev_h)
        if trigger:
            w = linalg.orthogonalize_bcgs_dyn(w, st.u, k, passes=passes, group=group)
        j = np.arange(st.cap + 1)
        eps_m = st.omega.dtype.type(machine_eps(rdtype))
        # After a reorthogonalization the stored-basis overlaps are at noise level.
        w_new = np.where(trigger & (j <= k - 2), eps_m, w_new)
        st.omega_prev = np.where(trigger, eps_m, st.omega).astype(st.omega.dtype)
        st.omega = w_new.astype(st.omega.dtype)
        st.force_reorth = trigger  # two-consecutive-steps rule
        st.alpha_h[k - 1] = a_h
        st.triggers.append(trigger)

    if st.wide is not None:
        bsq = linalg.inner_prod_f64(w, w, group).real
        beta_k = torch.sqrt(bsq.to(rdtype).clamp_min(0))
        st.wide[0, k - 1] = a64
        st.wide[1, k - 1] = bsq
    else:
        beta_k = linalg.norm(w, group).to(rdtype)
    st.u[k] = w / beta_k.clamp_min(torch.finfo(rdtype).tiny)
    st.alpha[k - 1] = alpha_k
    st.beta[k - 1] = beta_k
    st.k = k + 1


def _check(st: _Build, k: int, nroot: int, find_maximum: bool, eps: float, breakdown_eps: float) -> None:
    """The host side of iteration k's convergence check: breakdown since
    the last check, then the Sturm multisection and relative-change test."""
    alpha = st.alpha.cpu()  # waits for the device
    beta = st.beta.cpu()
    broke = torch.nonzero(beta[st.screened : k] < breakdown_eps)
    if broke.numel():
        st.stop = True
        st.itern = st.screened + int(broke[0, 0]) + 1
        return
    st.screened = k
    if eps == 0.0:  # sentinel: no convergence test (JAX engine semantics)
        return
    # The leading k entries only: the JAX engine passes its whole buffer,
    # whose rows past k the Sturm count treats as the identity.
    evs = tridiagonal.extremal_eigenvalues_device(alpha[:k], beta[:k], k, nroot, find_maximum)
    eps_t = torch.tensor(eps, dtype=st.rdtype)
    rel_ok = bool(torch.all((evs - st.evs_prev).abs() < torch.minimum(evs.abs(), st.evs_prev.abs()) * eps_t))
    converged = st.have_prev and rel_ok and eps > 0
    st.evs_prev = evs
    # A full previous estimate exists once a solve saw >= nroot rows
    # (the reference's pevs.size() == evs.size() gate, lambda_lanczos.hpp:291).
    st.have_prev = k >= nroot
    if converged:
        st.stop = True
        st.itern = k


def _run_stage(op, st: _Build, defl, defl_mask, *, eps, offset, nroot, find_maximum, check_every, passes, selective, k_lim):
    """Advance the build until it stops or reaches iteration ``k_lim``."""
    breakdown_eps = machine_eps(st.rdtype) * 10.0
    while st.k <= k_lim and not st.stop:
        k = st.k
        _iterate(op, st, defl, defl_mask, offset, passes, selective)
        if k % check_every == 0 or k >= k_lim:
            _check(st, k, nroot, find_maximum, eps, breakdown_eps)


def fused_krylov(op, v0, defl, defl_mask, eps, offset, *, nroot: int, m_cap: int, find_maximum: bool, check_every: int = 1, reorth_policy: str = "full"):
    """Fixed-capacity Krylov build (no staging, one classical pass, no
    float64 reductions): returns ``(u_buf, alpha, beta, itern, evs)``."""
    st = _Build(v0, m_cap, nroot, precise=False)
    _run_stage(
        op, st, defl, defl_mask, eps=float(eps), offset=float(offset), nroot=nroot,
        find_maximum=find_maximum, check_every=max(int(check_every), 1), passes=1,
        selective=reorth_policy == "selective", k_lim=m_cap,
    )
    return st.u, st.alpha, st.beta, st.done, st.evs_prev


def lanczos_iteration_fused(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """One deflated restart with the fused engine; the return contract of
    :func:`lanczos_tpu_torch.solvers.lanczos.lanczos_iteration`."""
    if cfg.precise_vectors:
        raise NotImplementedError(f"precise_vectors is not ported; see {_PV_ITEM}")
    if cfg.reorth_policy not in ("full", "selective"):
        raise ValueError(f"reorth_policy must be 'full' or 'selective', got {cfg.reorth_policy!r}")
    rdtype = real_dtype(v0.dtype)
    group = getattr(op, "group", None)
    m_max = min(cfg.max_iteration, max(cfg.matrix_size, 1))
    precise = bool(cfg.precise_reductions)

    v0 = _prepare_init_vector(v0, defl, defl_mask, group)
    cap = min(max(cfg.initial_buffer_size, 2), m_max)
    st = _Build(v0, cap, int(nroot), precise)
    while True:
        _run_stage(
            op, st, defl, defl_mask, eps=float(cfg.eps), offset=float(cfg.eigenvalue_offset),
            nroot=int(nroot), find_maximum=bool(cfg.find_maximum),
            check_every=max(int(cfg.convergence_check_interval), 1), passes=int(cfg.reorth_passes),
            selective=cfg.reorth_policy == "selective", k_lim=cap,
        )
        if st.stop or cap >= m_max:
            break
        cap = min(4 * cap, m_max)  # staged growth, as the JAX engine (lanczos_fused.py:542-551)
        st.grow(cap)

    m = st.done
    converged = st.stop or m >= cfg.matrix_size  # a full-space basis is exact
    _add_reorth(sum(st.triggers[:m]))
    if precise:
        wide = st.wide[:, :m].cpu().numpy()
        alphas = wide[0]
        betas = np.sqrt(np.maximum(wide[1], 0.0))[: m - 1]
    else:
        alphas = st.alpha[:m].cpu().numpy().astype(np.float64)
        betas = st.beta[: m - 1].cpu().numpy().astype(np.float64)

    # Host float64 recombination, once per restart.
    tri_vals, tri_vecs = tridiagonal.eigh_tridiagonal_host(alphas, betas, backend=cfg.tridiag_backend)
    num_out = min(nroot, m)
    sel = [m - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    q = torch.as_tensor(tri_vecs[sel], device=v0.device).to(rdtype)
    # Only the m live rows: rows queued after a breakdown may hold non-finite
    # values, which a zero coefficient would not cancel.
    eigvecs = _ritz_combine(q, st.u[:m], group)
    eigenvalues = [float(tri_vals[s]) - cfg.eigenvalue_offset for s in sel]
    return eigenvalues, eigvecs, m, converged
