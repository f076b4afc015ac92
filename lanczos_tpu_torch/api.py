"""User-facing API (port of ``lanczos_tpu.api``, ``LambdaLanczos``).

``LambdaLanczos`` <-> the reference class of the same name
(include/lambda_lanczos/lambda_lanczos.hpp:109-415): constructor
``(mv_mul, matrix_size, find_maximum, num_eigs)``, mutable config fields
(:126-181), ``run()`` returning (eigenvalues, eigenvectors) (:330-386),
``run_one`` (:394-407) and ``iteration_counts`` (:412-414).

The matvec is any :class:`~lanczos_tpu_torch.ops.operators.LinearOperator`
(dense, BSR, matrix-free), a square array, or a callable on tensors; the
solve runs on the operator's device.  ``mode='auto'`` picks the fused
engine on a CUDA device and the hybrid engine on the CPU.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .core.tridiagonal import unconverged_total
from .core.types import default_lanczos_eps, to_torch_dtype
from .diagnostics import BudgetExhaustedWarning
from .ops.operators import LinearOperator, as_operator
from .solvers import lanczos as _lanczos
from .solvers import lanczos_fused
from .utils.random import random_initializer
from .utils.stats import RunStats, trace_span

__all__ = ["LambdaLanczos"]

_BLOCK_ITEM = "ROADMAP.md, 'Modules to port': thick, block and block-thick engines"


def _coerce_operator(mv_mul, matrix_size, dtype):
    """Operator/size/dtype resolution: a LinearOperator as it is (on its own
    device), a callable as a matrix-free operator on the CPU (needs
    ``matrix_size`` and ``dtype``), anything else as a dense matrix where
    ``torch.as_tensor`` puts it."""
    if isinstance(mv_mul, LinearOperator):
        op = mv_mul
    elif callable(mv_mul):
        if matrix_size is None or dtype is None:
            raise ValueError("matrix-free usage needs matrix_size and dtype")
        op = as_operator(mv_mul, matrix_size, dtype)
    else:
        op = as_operator(mv_mul)
    n = int(matrix_size if matrix_size is not None else op.n)
    dt = to_torch_dtype(dtype if dtype is not None else op.dtype)
    return op, n, dt


class LambdaLanczos:
    """Extremal-eigenpair Lanczos engine with deflated restarts."""

    def __init__(self, mv_mul, matrix_size=None, find_maximum: bool = False, num_eigs: int = 1, *, dtype=None, mode: str = "auto"):
        self.operator, self.matrix_size, self.dtype = _coerce_operator(mv_mul, matrix_size, dtype)

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
        self.block_size: int = 1  # > 1 not ported
        self.max_restarts: int = 16
        self.restart_policy: str = "warm"  # 'thick' not ported
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
        """``iterate_one(v0, nroot, defl, defl_mask) -> (vals, vecs, itern,
        converged)`` for the configured engine: the single dispatch point."""
        op = self.operator
        if self.block_size > 1:
            raise NotImplementedError(f"block_size > 1 is not ported; see {_BLOCK_ITEM}")
        if self.restart_policy == "thick":
            raise NotImplementedError(f"restart_policy='thick' is not ported; see {_BLOCK_ITEM}")
        if self._resolve_mode() == "fused":
            return lambda v0, nroot, defl, mask: lanczos_fused.lanczos_iteration_fused(op, v0, nroot, defl, mask, cfg)
        return lambda v0, nroot, defl, mask: _lanczos.lanczos_iteration(op, v0, nroot, defl, mask, cfg)

    def run(self):
        """Full deflation-driven solve; returns (eigenvalues, eigenvectors)
        with ``eigenvectors[k]`` the k-th eigenvector, a tensor on the
        operator's device (reference run(), lambda_lanczos.hpp:330-386)."""
        t0 = time.perf_counter()
        unconv0 = unconverged_total()
        reorth0 = lanczos_fused.reorth_total()
        with trace_span("lanczos_tpu_torch.run"):
            cfg = self._config().resolved(self.dtype)
            iterate_one = self._iterate_factory(cfg)
            result = _lanczos.deflation_driver(
                iterate_one, cfg, self._init_fn(), self.dtype, device=self.operator.device,
            )
        self._iteration_counts = result.iteration_counts
        unconv = unconverged_total() - unconv0
        if result.unconverged_rounds:
            warnings.warn(
                f"{result.unconverged_rounds} deflation round(s) exhausted the "
                "max_restarts/max_iteration budget with the Ritz values still "
                "moving — results may be budget-limited, not eps-converged; "
                "check residuals() or raise the budgets",
                BudgetExhaustedWarning,
                stacklevel=2,
            )
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
        pair); accepts the outputs of :meth:`run`."""
        out = []
        for k in range(len(eigenvalues)):
            v = torch.as_tensor(eigenvectors[k], device=self.operator.device).to(self.dtype)
            r = self.operator.matvec(v) - float(np.asarray(eigenvalues[k])) * v
            out.append(float(torch.linalg.vector_norm(r)))
        return out
