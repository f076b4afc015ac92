"""Lanczos eigensolver engine (port of ``lanczos_tpu.solvers.lanczos``;
reference include/lambda_lanczos/lambda_lanczos.hpp).

Two execution modes share the numerics:

* **hybrid** (:func:`lanczos_iteration`): one device step per Lanczos
  iteration, then a host float64 tridiagonal solve every iteration — the
  reference semantics (lambda_lanczos.hpp:267-277).
* **fused** (:mod:`lanczos_tpu_torch.solvers.lanczos_fused`): the host
  syncs once per convergence-check interval.

Algorithmic contract mirrored from the reference ``run_iteration``
(lambda_lanczos.hpp:216-322): init vector orthogonalized against accepted
eigenvectors (:231-234), matvec + eigenvalue-offset shift (:242-246),
alpha = Re<u, Au> (:248), three-term recurrence (:251-257), full
reorthogonalization against deflated eigenvectors then all previous Lanczos
vectors (:259-260), beta = ||w|| (:262), relative-change convergence over
all requested roots (:290-309), breakdown exit when beta < machine_eps*10
(:279-283), Ritz recombination (:316) and eigenvalue un-shift (:317-319).

The deflation driver and :class:`EigenPairManager`
(eigenpair_manager.hpp:21-80) are plain Python shared by every engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core import linalg, tridiagonal
from ..core.types import is_complex_dtype, machine_eps, real_dtype, to_torch_dtype

__all__ = [
    "EigenPairManager",
    "LanczosConfig",
    "LanczosResult",
    "lanczos_iteration",
    "deflation_driver",
    "run_restarted",
]


class EigenPairManager:
    """Keeps only the best ``num_eigs`` eigenpairs; insertion order follows
    the reference multimap exactly (eigenpair_manager.hpp:52-71), including
    the ``nothing_added`` fixed-point signal that ends the deflation loop."""

    def __init__(self, find_maximum: bool, num_eigs: int):
        self.find_maximum = bool(find_maximum)
        self.num_eigs = int(num_eigs)
        self.pairs: list[tuple[float, torch.Tensor]] = []  # sorted, best first

    def __len__(self) -> int:
        return len(self.pairs)

    def _before(self, a: float, b: float) -> bool:
        return a > b if self.find_maximum else a < b

    def _upper_bound(self, val: float) -> int:
        lo, hi = 0, len(self.pairs)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._before(val, self.pairs[mid][0]):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def insert(self, eigenvalues, eigenvectors) -> bool:
        """Insert candidate pairs; True iff *nothing* was kept
        (eigenpair_manager.hpp:55-70)."""
        nothing_added = True
        for val, vec in zip(eigenvalues, eigenvectors):
            val = float(val)
            pos = self._upper_bound(val)  # multimap emplace: after equal keys
            self.pairs.insert(pos, (val, vec))
            if len(self.pairs) > self.num_eigs:
                if pos != len(self.pairs) - 1:
                    nothing_added = False
                self.pairs.pop()
            else:
                nothing_added = False
        return nothing_added

    def eigenvalues(self) -> list[float]:
        return [p[0] for p in self.pairs]

    def eigenvectors(self) -> list[torch.Tensor]:
        return [p[1] for p in self.pairs]


@dataclasses.dataclass
class LanczosConfig:
    """Tunables; names and defaults match ``lanczos_tpu``'s LanczosConfig
    (and through it the reference's public fields,
    lambda_lanczos.hpp:126-181), so a JAX configuration carries over with
    :func:`lanczos_tpu_torch.convert.config_from_dict`."""

    matrix_size: int
    find_maximum: bool = False
    num_eigs: int = 1
    max_iteration: int | None = None  # defaults to matrix_size (:206)
    eps: float | None = None  # defaults to machine_eps*1e3 (:150)
    eigenvalue_offset: float = 0.0  # (:165)
    num_eigs_per_iteration: int = 5  # (:173)
    initial_buffer_size: int = 64  # initial Krylov-buffer capacity (analogue of :181)
    tridiag_backend: str | None = None  # 'auto' | 'lapack' | 'numpy'
    # float64 alpha/||w||^2 for the host solve; default on for 32-bit dtypes.
    precise_reductions: bool | None = None
    # Double-float Krylov vectors: not ported (ROADMAP.md, precise paths).
    precise_vectors: bool = False
    # Reorthogonalization passes per CGS application (None -> 1, one
    # classical pass, as the JAX package resolves it since its round 3).
    reorth_passes: int | None = None
    # Fused engine: 'full' reorthogonalizes every iteration; 'selective'
    # follows Simon's omega recurrence and reorthogonalizes only when the
    # estimated drift crosses sqrt(machine_eps).
    reorth_policy: str = "full"
    # 'warm' restarts from the best Ritz vector(s); 'thick' keeps Ritz
    # vectors with their exact couplings (TRLan; solvers/thick_restart.py,
    # solvers/block_thick.py).
    restart_policy: str = "warm"
    max_restarts: int = 16
    # Thick restart: Ritz vectors kept across a restart (None -> the engine
    # default: scalar nroot+2, block nroot+max(2, b)).
    thick_keep: int | None = None
    stop_when_full: bool = False
    stop_when_count: int | None = None
    # Fused engine: run the convergence solve every K iterations (None -> 4).
    convergence_check_interval: int | None = None

    def resolve_thick_keep(self, default: int, cap: int) -> int:
        """Ritz vectors kept across a thick restart, shared by the scalar and
        block thick engines."""
        req = default if self.thick_keep is None else int(self.thick_keep)
        if req < 1:
            raise ValueError("thick_keep must be >= 1 (None selects the engine default)")
        return max(min(req, cap), 1)

    def resolved(self, dtype):
        cfg = dataclasses.replace(self)
        if cfg.max_iteration is None:
            cfg.max_iteration = cfg.matrix_size
        if cfg.eps is None:
            cfg.eps = machine_eps(dtype) * 1e3
        if cfg.precise_reductions is None:
            cfg.precise_reductions = real_dtype(dtype) == torch.float32
        if cfg.convergence_check_interval is None:
            cfg.convergence_check_interval = 8 if cfg.precise_vectors else 4
        if cfg.reorth_passes is None:
            cfg.reorth_passes = 2 if cfg.precise_vectors else 1
        return cfg


@dataclasses.dataclass
class LanczosResult:
    eigenvalues: np.ndarray
    eigenvectors: torch.Tensor  # (num_found, n), one row per eigenvector
    iteration_counts: list[int]
    # Deflation rounds that exhausted their budget with the Ritz values
    # still moving (check api.residuals); 0 means every round settled.
    unconverged_rounds: int = 0


def _prepare_init_vector(v0, defl, defl_mask):
    """Orthogonalize the start vector against accepted eigenpairs and
    normalize (lambda_lanczos.hpp:231-234)."""
    return linalg.normalize(linalg.orthogonalize_cgs2(v0, defl, defl_mask))


def _unit_rows(vecs):
    """Each row divided by its Euclidean norm."""
    return vecs / torch.sqrt(torch.sum(vecs.abs() ** 2, dim=1, keepdim=True))


def _ritz_combine(q, u):
    """Ritz recombination eigvecs = normalize(Q @ U) (lambda_lanczos.hpp:51-58).

    q: (nroot, m) tridiagonal eigenvectors; u: (m, n) live Krylov rows.
    """
    return _unit_rows(q.to(u.dtype) @ u)


def _host_dtype(dtype):
    """The host dtype of projected matrices and coefficients: complex128 for
    complex operators, float64 otherwise."""
    return np.complex128 if is_complex_dtype(dtype) else np.float64


def _rotate(q, rows):
    """Rows ``q @ rows[:m]`` for (r, m) host coefficients ``q`` (the real
    part for real ``rows``): a Ritz recombination that reads only the m live
    rows of a buffer."""
    if not rows.is_complex():
        q = q.real
    return torch.as_tensor(np.ascontiguousarray(q), device=rows.device).to(rows.dtype) @ rows[: q.shape[1]]


def _lanczos_step(op, u_buf, defl, defl_mask, k: int, beta_prev, offset: float, precise: bool, reorth_passes: int):
    """One Lanczos iteration on the operator's device; writes u_{k} into
    ``u_buf[k]`` and returns (alpha_k, beta_k, host_scalars) where
    host_scalars are the float64 alpha and ||w||^2 under ``precise``."""
    rdtype = real_dtype(u_buf.dtype)
    u_prev = u_buf[k - 1]
    au = op.matvec(u_prev)
    if offset != 0.0:
        au = au + offset * u_prev  # eigenvalue shift (:244-246)
    alpha = linalg.inner_prod(u_prev, au).real.to(rdtype)
    w = au - alpha * u_prev
    if k >= 2:
        w = w - beta_prev * u_buf[k - 2]  # three-term recurrence (:251-257)
    w = linalg.orthogonalize_cgs2(w, defl, defl_mask, passes=reorth_passes)
    w = linalg.orthogonalize_bcgs_dyn(w, u_buf, k, passes=reorth_passes)
    beta = linalg.norm(w).to(rdtype)
    if precise:
        wide = torch.stack([linalg.inner_prod_f64(u_prev, au).real, linalg.inner_prod_f64(w, w).real])
    else:
        wide = torch.stack([alpha, beta]).to(torch.float64)
    u_buf[k] = w / beta.clamp_min(torch.finfo(rdtype).tiny)
    return alpha, beta, wide


def lanczos_iteration(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """Hybrid engine: one Krylov build; returns (eigenvalues list,
    eigenvectors (r, n), iteration count, converged).

    ``defl`` holds the accepted eigenvectors, one per row, with
    ``defl_mask`` marking valid rows.
    """
    dtype = v0.dtype
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    max_iter = min(cfg.max_iteration, max(n, 1))
    precise = bool(cfg.precise_reductions)

    v0 = _prepare_init_vector(v0, defl, defl_mask)
    cap = min(max(cfg.initial_buffer_size, 2), max_iter + 1)
    u_buf = torch.zeros((cap, n), dtype=dtype, device=v0.device)
    u_buf[0] = v0

    alphas: list[float] = []
    betas: list[float] = []
    evs: np.ndarray | None = None
    pevs: np.ndarray | None = None
    # Breakdown threshold machine_eps * 10 (:279), in the solver precision
    # when float64 reductions are on.
    breakdown_eps = machine_eps(torch.float64 if precise else rdtype) * 10.0

    itern = max_iter
    converged = False
    beta_prev = None
    for k in range(1, max_iter + 1):
        if k >= u_buf.shape[0]:
            grown = torch.zeros((min(2 * u_buf.shape[0], max_iter + 1), n), dtype=dtype, device=v0.device)
            grown[: u_buf.shape[0]] = u_buf
            u_buf = grown
        _alpha, beta_prev, wide = _lanczos_step(
            op, u_buf, defl, defl_mask, k, beta_prev, cfg.eigenvalue_offset, precise, int(cfg.reorth_passes)
        )
        a_k, b_k = wide.tolist()  # the one host sync of the iteration
        alphas.append(a_k)
        betas.append(float(np.sqrt(max(b_k, 0.0))) if precise else b_k)

        # Convergence test on the k x k tridiagonal (:264-277).
        evs = tridiagonal.extremal_eigvals_host(
            np.asarray(alphas), np.asarray(betas[:-1]), nroot, cfg.find_maximum, backend=cfg.tridiag_backend
        )
        if betas[-1] < breakdown_eps:  # beta breakdown (:279-283)
            itern = k
            converged = True
            break
        # Relative-change test over all requested roots (:290-309).
        if pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            if np.all(np.abs(evs - pevs) < np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps):
                itern = k
                converged = True
                break
        pevs = evs

    m = len(alphas)
    num_out = min(nroot, m)
    _vals, tri_vecs = tridiagonal.eigh_tridiagonal_host(
        np.asarray(alphas), np.asarray(betas[:-1]), backend=cfg.tridiag_backend
    )
    sel = [m - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    q = torch.as_tensor(tri_vecs[sel], device=v0.device).to(rdtype)
    eigvecs = _ritz_combine(q, u_buf[:m])
    eigenvalues = [float(v) - cfg.eigenvalue_offset for v in (evs.tolist() if evs is not None else [])]
    # A basis spanning the whole space is exact by construction.
    return eigenvalues, eigvecs, itern, converged or m >= n


def run_restarted(iterate_one, v0, cfg: LanczosConfig, warm_rows: int = 1):
    """Warm-restart loop around one deflated Krylov build.

    ``iterate_one(v0) -> (vals, vecs, itern, converged)``.  When
    ``max_iteration`` caps the basis below convergence, restart from the
    best ``warm_rows`` Ritz vectors (a block start for the block engine,
    padded with copies of the best one) until the build converges or the
    Ritz values stop moving between restarts.  Returns
    ``(vals, vecs, total_iters, settled)``.
    """
    pevs = None
    total = 0
    vals, vecs = [], None
    settled = False
    for _ in range(max(cfg.max_restarts, 1)):
        vals, vecs, itern, converged = iterate_one(v0)
        total += itern
        if converged:
            settled = True
            break
        evs = np.asarray(vals)
        if pevs is not None and evs.shape == pevs.shape:
            if np.all(np.abs(evs - pevs) < np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps):
                settled = True
                break
        pevs = evs
        if warm_rows == 1:
            v0 = vecs[0]
        else:
            k = min(warm_rows, vecs.shape[0])
            v0 = torch.cat([vecs[:k], vecs[:1].expand(warm_rows - k, -1)])
    return vals, vecs, total, settled


def deflation_driver(
    iterate_one,
    cfg: LanczosConfig,
    init_vector: Callable[[int], object],
    dtype,
    *,
    device=None,
    v0_rows: int = 1,
    use_warm_restarts: bool = True,
    manager: EigenPairManager | None = None,
    iter_counts: list[int] | None = None,
    after_round=None,
) -> LanczosResult:
    """THE deflation loop (reference run(), lambda_lanczos.hpp:330-366):
    repeated restarts orthogonal to accepted pairs until the eigenpair set
    reaches the ``nothing_added`` fixed point.

    ``iterate_one(v0, nroot, defl, defl_mask) -> (vals, vecs, itern,
    converged)``.  ``init_vector(n)`` returns an array or tensor; it is moved
    to ``device`` in ``dtype``.  ``v0_rows`` > 1 stacks that many init
    vectors into a block start (block engines).  ``use_warm_restarts=False``
    for engines that restart internally (thick).  ``manager``/``iter_counts``
    resume a run; ``after_round(manager, iter_counts, finished)`` runs after
    each round.
    """
    dtype = to_torch_dtype(dtype)
    cfg = cfg.resolved(dtype)
    n = cfg.matrix_size
    manager = manager if manager is not None else EigenPairManager(cfg.find_maximum, cfg.num_eigs)
    iter_counts = iter_counts if iter_counts is not None else []
    unconverged_rounds = 0
    rdtype = real_dtype(dtype)

    while True:
        nroot = min(max(cfg.num_eigs_per_iteration, v0_rows), n - len(manager))
        if nroot <= 0:
            break
        # Only the accepted rows: the JAX package pads to a static capacity
        # for jit and masks; zero rows would only add exact zeros here.
        nd = len(manager)
        if nd:
            defl = torch.stack(manager.eigenvectors())
        else:
            defl = torch.zeros((0, n), dtype=dtype, device=device)
        defl_mask = torch.ones(nd, dtype=rdtype, device=device)
        if v0_rows == 1:
            v0 = torch.as_tensor(init_vector(n), device=device).to(dtype)
        else:
            v0 = torch.stack([torch.as_tensor(init_vector(n), device=device).to(dtype) for _ in range(v0_rows)])

        if use_warm_restarts:
            vals, vecs, itern, settled = run_restarted(
                lambda w: iterate_one(w, nroot, defl, defl_mask), v0, cfg, warm_rows=v0_rows
            )
        else:
            vals, vecs, itern, settled = iterate_one(v0, nroot, defl, defl_mask)
        iter_counts.append(itern)
        if not settled:
            unconverged_rounds += 1

        was_full = len(manager) == cfg.num_eigs
        before_vals = np.asarray(manager.eigenvalues()) if was_full else None
        nothing_added = manager.insert(vals, [vecs[i] for i in range(len(vals))])
        if not nothing_added and was_full:
            # Noise-robust fixed point (as in the JAX package): once the
            # manager is full, a round that only reshuffles the kept values
            # within the relative tolerance has confirmed the spectrum edge.
            after_vals = np.asarray(manager.eigenvalues())
            tol = np.maximum(np.abs(after_vals), np.abs(before_vals)) * cfg.eps
            if np.all(np.abs(after_vals - before_vals) <= tol):
                nothing_added = True
        stop_count = cfg.num_eigs if cfg.stop_when_count is None else cfg.stop_when_count
        finished = bool(nothing_added or cfg.num_eigs == 1 or (cfg.stop_when_full and len(manager) >= stop_count))
        if after_round is not None:
            after_round(manager, iter_counts, finished)
        if finished:  # (:346-353)
            break

    eigenvalues = np.asarray(manager.eigenvalues())
    if manager.pairs:
        eigenvectors = torch.stack(manager.eigenvectors())
    else:  # pragma: no cover
        eigenvectors = torch.zeros((0, n), dtype=dtype, device=device)
    return LanczosResult(eigenvalues, eigenvectors, iter_counts, unconverged_rounds)
