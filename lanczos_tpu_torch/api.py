"""User-facing API (port of ``lanczos_tpu.api``, ``LambdaLanczos``).

``LambdaLanczos`` <-> the reference class of the same name
(include/lambda_lanczos/lambda_lanczos.hpp:109-415): constructor
``(mv_mul, matrix_size, find_maximum, num_eigs)``, mutable config fields
(:126-181), ``run()`` returning (eigenvalues, eigenvectors) (:330-386),
``run_one`` (:394-407) and ``iteration_counts`` (:412-414).

The matvec is any :class:`~lanczos_tpu_torch.ops.operators.LinearOperator`
(dense, BSR, DIA, matrix-free), a square array, or a callable on tensors;
the solve runs on the operator's device.  An array or callable becomes an
operator on ``device``, by default the CUDA card (``device="cpu"`` for the
CPU).  ``mode='auto'`` picks the fused engine on a CUDA device and the
hybrid engine on the CPU; ``restart_policy='thick'`` and ``block_size > 1``
select the thick, block and block-thick engines as the JAX package does
(its api.py:152-219).

A row-partitioned operator (:mod:`lanczos_tpu_torch.parallel.sharded`) is
solved by every rank of its process group together, in the hybrid or the
fused engine: each rank runs the same solve on its slab, ``matrix_size``
is the global n, and the eigenvectors come back gathered to length n on
every rank.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .core import linalg
from .core.tridiagonal import unconverged_total
from .core.types import default_lanczos_eps, machine_eps, to_torch_dtype
from .diagnostics import BudgetExhaustedWarning
from .ops.operators import LinearOperator, as_operator
from .parallel.sharded import ShardedOperator, refuse_sharded
from .solvers import block_lanczos, block_thick, lanczos_fused, thick_restart
from .solvers import lanczos as _lanczos
from .solvers.lanczos_fused import _PV_ITEM
from .utils.random import random_initializer
from .utils.stats import RunStats, trace_span

__all__ = ["LambdaLanczos"]

def _coerce_operator(mv_mul, matrix_size, dtype, device):
    """Operator/size/dtype resolution: a LinearOperator as it is (on its own
    device), a callable as a matrix-free operator (needs ``matrix_size`` and
    ``dtype``), anything else as a dense matrix; both on ``device`` (default:
    the CUDA card)."""
    if isinstance(mv_mul, LinearOperator):
        op = mv_mul
    elif callable(mv_mul):
        if matrix_size is None or dtype is None:
            raise ValueError("matrix-free usage needs matrix_size and dtype")
        op = as_operator(mv_mul, matrix_size, dtype, device=device)
    else:
        op = as_operator(mv_mul, device=device)
    n = int(matrix_size if matrix_size is not None else op.n)
    dt = to_torch_dtype(dtype if dtype is not None else op.dtype)
    return op, n, dt


class LambdaLanczos:
    """Extremal-eigenpair Lanczos engine with deflated restarts."""

    def __init__(self, mv_mul, matrix_size=None, find_maximum: bool = False, num_eigs: int = 1, *, dtype=None, mode: str = "auto", device=None):
        self.operator, self.matrix_size, self.dtype = _coerce_operator(mv_mul, matrix_size, dtype, device)

        # Public tunables (reference lambda_lanczos.hpp:126-181); the same
        # names and defaults as lanczos_tpu.LambdaLanczos.
        self.find_maximum = bool(find_maximum)
        self.num_eigs = int(num_eigs)
        self.max_iteration: int | None = None  # None -> matrix_size
        self.eps: float = default_lanczos_eps(self.dtype)
        self.eigenvalue_offset: float = 0.0
        self.num_eigs_per_iteration: int = 5
        self.init_vector = None  # callable(n) -> vector, a vector, or None (random)
        self.tridiag_backend: str | None = None
        self.precise_reductions: bool | None = None
        self.precise_vectors: bool = False  # not ported
        self.convergence_check_interval: int | None = None
        self.reorth_passes: int | None = None
        self.reorth_policy: str = "full"  # fused: 'full' | 'selective'
        self.initial_buffer_size: int = 64
        self.block_size: int = 1  # > 1: block engines (multiplicity <= b per round)
        self.max_restarts: int = 16
        self.restart_policy: str = "warm"  # 'warm' | 'thick' (TRLan)
        self.stop_when_full: bool = False
        self.thick_keep: int | None = None
        self.mode = mode

        self._iteration_counts: list[int] = []
        self._stats: RunStats | None = None

    def _config(self) -> _lanczos.LanczosConfig:
        return _lanczos.LanczosConfig(
            matrix_size=self.matrix_size,
            find_maximum=self.find_maximum,
            num_eigs=self.num_eigs,
            max_iteration=self.max_iteration,
            eps=self.eps,
            eigenvalue_offset=self.eigenvalue_offset,
            num_eigs_per_iteration=self.num_eigs_per_iteration,
            tridiag_backend=self.tridiag_backend,
            precise_reductions=self.precise_reductions,
            precise_vectors=self.precise_vectors,
            convergence_check_interval=self.convergence_check_interval,
            reorth_passes=self.reorth_passes,
            reorth_policy=self.reorth_policy,
            initial_buffer_size=self.initial_buffer_size,
            max_restarts=self.max_restarts,
            restart_policy=self.restart_policy,
            thick_keep=self.thick_keep,
            stop_when_full=self.stop_when_full,
        )

    def _init_fn(self):
        iv = self.init_vector
        if iv is None:
            return random_initializer(self.dtype)
        if callable(iv):
            return iv
        return lambda n: iv

    def _resolve_mode(self) -> str:
        """'auto' -> fused on a CUDA device (host waits are the bottleneck
        there), hybrid on the CPU.  ``precise_vectors`` forces fused, as in
        the JAX package."""
        if self.mode not in ("auto", "fused", "hybrid"):
            raise ValueError(f"mode must be 'auto', 'fused' or 'hybrid', got {self.mode!r}")
        if self.precise_vectors:
            if self.mode not in ("auto", "fused"):
                raise ValueError("precise_vectors is implemented by the fused engine; use mode='fused' or 'auto'")
            return "fused"
        if self.mode != "auto":
            return self.mode
        return "fused" if self.operator.device.type == "cuda" else "hybrid"

    def _iterate_factory(self, cfg):
        """``(iterate_one, v0_rows, use_warm_restarts)`` for the configured
        engine, the single dispatch point (JAX package api.py:152-219).
        ``iterate_one(v0, nroot, defl, defl_mask) -> (vals, vecs, itern,
        converged)``."""
        op = self.operator
        if self.precise_vectors and (self.block_size > 1 or self.restart_policy == "thick"):
            raise NotImplementedError(f"precise_vectors with the block or thick engines is not ported; see {_PV_ITEM}")
        if self.block_size > 1:
            refuse_sharded(op, "block_size > 1")
            b = int(self.block_size)
            if self.restart_policy == "thick":
                return (
                    lambda v0, nroot, defl, mask: block_thick.block_thick_iteration_fused(op, v0, nroot, defl, mask, cfg, b),
                    b,
                    False,
                )
            return (
                lambda v0, nroot, defl, mask: block_lanczos.block_lanczos_iteration(op, v0, nroot, defl, mask, cfg, b),
                b,
                True,
            )
        fused = self._resolve_mode() == "fused"
        if self.restart_policy == "thick":
            refuse_sharded(op, "restart_policy='thick'")
            engine = thick_restart.thick_lanczos_iteration_fused if fused else thick_restart.thick_lanczos_iteration
            return lambda v0, nroot, defl, mask: engine(op, v0, nroot, defl, mask, cfg), 1, False
        engine = lanczos_fused.lanczos_iteration_fused if fused else _lanczos.lanczos_iteration
        return lambda v0, nroot, defl, mask: engine(op, v0, nroot, defl, mask, cfg), 1, True

    def _budget_message(self, result, cfg) -> str:
        """The BudgetExhaustedWarning text, with the block-economics hint of
        the JAX package (api.py:266-298): thick-restart convergence depth per
        cycle is rows/block_size, so when the best Ritz values come out
        distinct a block run pays block_size x the row budget for the depth
        a scalar run gets, and block_size=1 is the better tool."""
        msg = (
            f"{result.unconverged_rounds} deflation round(s) exhausted the "
            "max_restarts/max_iteration budget with the Ritz values still "
            "moving — results may be budget-limited, not eps-converged; "
            "check residuals() or raise the budgets"
        )
        if self.block_size > 1 and len(result.eigenvalues) > 1:
            ev = np.sort(np.asarray(result.eigenvalues, np.float64))
            gaps = np.diff(ev)
            # Values closer than max(eps, machine_eps*1e3) of the spectral
            # scale are effectively degenerate at the achievable accuracy.
            floor = machine_eps(self.dtype) * 1e3
            scale = float(np.max(np.abs(ev)))
            tol = max(cfg.eps, floor) * scale
            if scale > 0.0 and np.all(gaps > tol):
                msg += (
                    ". The best Ritz values came out DISTINCT "
                    f"(min gap {gaps.min():.1e}): if your targets are "
                    "clustered-but-distinct, block_size=1 converges faster — "
                    "block thick restart needs block_size x the iteration "
                    "budget for equal convergence depth and wins only on "
                    "exact degeneracy (then keep block_size and raise the budgets)"
                )
        return msg

    def run(self):
        """Full deflation-driven solve; returns (eigenvalues, eigenvectors)
        with ``eigenvectors[k]`` the k-th eigenvector, a tensor on the
        operator's device (reference run(), lambda_lanczos.hpp:330-386)."""
        t0 = time.perf_counter()
        unconv0 = unconverged_total()
        reorth0 = lanczos_fused.reorth_total()
        with trace_span("lanczos_tpu_torch.run"):
            cfg = self._config().resolved(self.dtype)
            iterate_one, v0_rows, use_warm = self._iterate_factory(cfg)
            result = _lanczos.deflation_driver(
                iterate_one, cfg, self._init_fn(), self.dtype, device=self.operator.device,
                v0_rows=v0_rows, use_warm_restarts=use_warm,
                sharded=self.operator if isinstance(self.operator, ShardedOperator) else None,
            )
        self._iteration_counts = result.iteration_counts
        unconv = unconverged_total() - unconv0
        if result.unconverged_rounds:
            warnings.warn(self._budget_message(result, cfg), BudgetExhaustedWarning, stacklevel=2)
        self._stats = RunStats(
            list(result.iteration_counts), time.perf_counter() - t0, tridiag_unconverged=unconv,
            reorth_count=lanczos_fused.reorth_total() - reorth0,
            unconverged_rounds=result.unconverged_rounds,
        )
        return result.eigenvalues, result.eigenvectors

    def run_one(self):
        """Single best eigenpair regardless of ``num_eigs``
        (reference lambda_lanczos.hpp:394-407)."""
        saved = self.num_eigs
        self.num_eigs = 1
        try:
            vals, vecs = self.run()
        finally:
            self.num_eigs = saved
        return float(vals[0]), vecs[0]

    @property
    def iteration_counts(self) -> list[int]:
        """Per-restart Lanczos iteration counts of the latest run
        (reference getIterationCounts, lambda_lanczos.hpp:412-414)."""
        return self._iteration_counts

    @property
    def stats(self) -> RunStats | None:
        """:class:`~lanczos_tpu_torch.utils.stats.RunStats` of the latest run;
        None before the first run."""
        return self._stats

    def residuals(self, eigenvalues, eigenvectors) -> list[float]:
        """||A v_k - lambda_k v_k|| for each returned pair (one matvec per
        pair); accepts the outputs of :meth:`run`.  For a sharded operator
        every rank calls it: the matvec and the norm run over the slabs."""
        op = self.operator
        sharded = isinstance(op, ShardedOperator)
        out = []
        for k in range(len(eigenvalues)):
            v = torch.as_tensor(eigenvectors[k], device=op.device).to(self.dtype)
            if sharded:
                v = op.scatter(v)
            r = op.matvec(v) - float(np.asarray(eigenvalues[k])) * v
            out.append(float(linalg.norm(r, op.group if sharded else None)))
        return out
