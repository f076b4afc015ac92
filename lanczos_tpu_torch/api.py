"""User-facing API (port of ``lanczos_tpu.api``: ``LambdaLanczos`` and
``Exponentiator``).

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
solved by every rank of its process group together, in every engine
(hybrid, fused, thick, block, block-thick, precise or not): each rank runs
the same solve on its slab, ``matrix_size`` is the global n, and the
eigenvectors come back gathered to length n on every rank.

``Exponentiator`` <-> the reference class of the same name
(include/lambda_lanczos/exponentiator.hpp): ``run(a, v)`` returns
(exp(a*A) v, iteration_count), with the grid, split-complex, multi-step,
Chebyshev and Taylor forms of the JAX package (its api.py:346-607).  ``a``
and the outputs are native complex where the JAX package takes split
words; a complex input to a real operator goes through ``run_split``.  A
complex Hermitian operator (complex entries, or a ``HermitianSplitOperator``
of real and imaginary parts) takes and returns complex n-states in every
method, as the JAX package's methods do on its real embedding; here the
builds run natively on the complex operator.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .core import linalg
from .core.tridiagonal import unconverged_total
from .core.types import default_exponentiator_eps, default_lanczos_eps, machine_eps, to_torch_dtype
from .diagnostics import BudgetExhaustedWarning
from .ops.hermitian_split import HermitianSplitOperator
from .ops.operators import LinearOperator, as_operator
from .parallel.sharded import ShardedOperator, draw_group
from .solvers import block_lanczos, block_thick, cheby_expm, lanczos_fused, thick_restart
from .solvers import exponentiator as _expm
from .solvers import exponentiator_fused as _expm_fused
from .solvers import lanczos as _lanczos
from .utils.random import random_initializer
from .utils.stats import RunStats, trace_span

__all__ = ["LambdaLanczos", "Exponentiator"]

def _coerce_operator(mv_mul, matrix_size, dtype, device):
    """Operator/size/dtype resolution: a LinearOperator as it is (on its own
    device), a callable as a matrix-free operator (needs ``matrix_size`` and
    ``dtype``), anything else as a dense matrix; both on ``device`` (default:
    the CUDA card).  The vectors' dtype is ``dtype``, else the operator's; a
    bfloat16 one raises."""
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
    if dt == torch.bfloat16:
        # A storage dtype (bfloat16 BSR tiles): the JAX package raises too
        # ("data type bfloat16 not inexact"); no engine builds a bfloat16 basis.
        raise ValueError("bfloat16 is a storage dtype only: pass dtype=torch.float32 (or float64) for the vectors")
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
        self.precise_vectors: bool = False  # float64 basis and matvec_f64 (forces the fused engine)
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
            return random_initializer(self.dtype, draw_group(self.operator))
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
        if self.precise_vectors and self.block_size > 1 and self.restart_policy != "thick":
            raise ValueError(
                "precise_vectors with block_size > 1 requires restart_policy='thick' (the plain block engine "
                "has no precise path)"
            )
        if self.block_size > 1:
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


class Exponentiator:
    """Krylov exponentiation engine: output = exp(a*A) @ input.

    ``mv_mul`` is taken as by :class:`LambdaLanczos`: an operator on its own
    device, or an array or callable put on ``device`` (default: the CUDA
    card).  Vectors may be tensors on any device or numpy arrays; they are
    moved to the operator's device and dtype, and results are tensors
    there.  A row-partitioned operator is run by every rank of its group
    together: each method takes global states, runs on this rank's slabs
    (every reduction through the group) and returns global results on
    every rank.
    """

    def __init__(self, mv_mul, matrix_size=None, *, dtype=None, mode: str = "hybrid", device=None):
        self.operator, self.matrix_size, self.dtype = _coerce_operator(mv_mul, matrix_size, dtype, device)
        self._sharded = self.operator if isinstance(self.operator, ShardedOperator) else None

        # Public tunables (reference exponentiator.hpp:41-71), the names and
        # defaults of lanczos_tpu.Exponentiator.
        self.max_iteration: int | None = None
        self.eps: float = default_exponentiator_eps(self.dtype)
        self.full_orthogonalize: bool = False
        self.tridiag_backend: str | None = None
        self.initial_buffer_size: int = 16  # Krylov buffer start capacity
        self.mode = mode  # 'hybrid' (a host solve every iteration) | 'fused' (a host read per stage)

    def _config(self, matrix_size=None) -> _expm.ExponentiatorConfig:
        return _expm.ExponentiatorConfig(
            matrix_size=self.matrix_size if matrix_size is None else matrix_size,
            max_iteration=self.max_iteration,
            eps=self.eps,
            full_orthogonalize=self.full_orthogonalize,
            tridiag_backend=self.tridiag_backend,
            initial_buffer_size=self.initial_buffer_size,
        )

    def _herm(self):
        """The native complex operator when the operator is complex
        Hermitian (complex entries, or a ``HermitianSplitOperator``'s
        ``complex_operator``), else None."""
        op = self.operator
        if isinstance(op, HermitianSplitOperator):
            return op.complex_operator()
        return op if self.dtype.is_complex else None

    def _slab(self, x):
        """A global state (or (B, n) batch) as this rank's slab(s) for a
        row-partitioned operator; as it is otherwise.  Host arrays become
        tensors on the operator's device in their own dtype."""
        if self._sharded is None:
            return x
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return linalg.slab(t.to(self.operator.device), self._sharded.n_local, self._sharded.group)

    def _typed(self, x, what: str):
        """``x`` in the operator's dtype on its device; a complex ``x`` for a
        real operator raises (its imaginary part would be dropped)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.is_complex() and not self.dtype.is_complex:
            raise TypeError(
                f"{what}: complex input to a real {self.dtype} operator; pass the real and imaginary "
                "parts to run_split, evolve or run_chebyshev"
            )
        return t.to(device=self.operator.device, dtype=self.dtype)

    def _vector(self, x, what: str):
        """:meth:`_typed`, as this rank's slab for a row-partitioned
        operator."""
        return self._slab(self._typed(x, what))

    def _real_parts(self, v_re, v_im, what: str):
        """The real and imaginary words of a state for a real operator; a
        missing ``v_im`` is zero."""
        v_re = self._vector(v_re, what)
        return v_re, torch.zeros_like(v_re) if v_im is None else self._vector(v_im, what)

    def _precise(self, v):
        """A real state word in float64 at full precision, as a slab for a
        row-partitioned operator."""
        return self._slab(_expm.precise_state(v, self.operator.device))

    def run(self, a, input_vector):
        """``(output, iteration_count)`` = exp(a*A) @ input
        (exponentiator.hpp:87-173).  ``mode='fused'`` queues the Krylov
        build a stage at a time and replays the stop test on the host (one
        host read per stage instead of one per iteration), with the hybrid
        build's iteration count."""
        if self.mode not in ("hybrid", "fused"):
            raise ValueError(f"mode must be 'hybrid' or 'fused', got {self.mode!r}")
        op, cop = self.operator, self._herm()
        if cop is not None:
            op, v, cfg = cop, self._slab(_expm.complex_state(cop, input_vector)), self._config(cop.n)
        else:
            v, cfg = self._vector(input_vector, "run"), self._config()
        if self.mode == "fused":
            out, itern = _expm_fused.krylov_expm_apply_fused(op, a, v, cfg)
        else:
            out, itern = _expm.krylov_expm_apply(op, a, v, cfg)
        return linalg.gather_rows(out, self.operator), itern

    def run_grid(self, a_list, input_vector):
        """exp(a_i*A) @ input for a grid of scalars from ONE Krylov build
        (time enters only through the host coefficients); returns
        ``(outputs (num, n), iteration_count)``."""
        cop = self._herm()
        if cop is not None:
            outs, itern = _expm.krylov_expm_apply_grid(cop, list(a_list),
                                                       self._slab(_expm.complex_state(cop, input_vector)),
                                                       self._config(cop.n))
        else:
            v = self._vector(input_vector, "run_grid")
            outs, itern = _expm.krylov_expm_apply_grid(self.operator, list(a_list), v, self._config())
        return linalg.gather_rows(outs, self.operator), itern

    def run_split(self, a, v_re, v_im):
        """exp(a*A) (v_re + i v_im) for a REAL operator: one real Krylov
        build per part, complex coefficients on the host.  Returns
        ``((out_re, out_im), (iters_re, iters_im))``; each count is what
        :meth:`run` takes on that part alone.  A complex Hermitian operator
        takes the complex n-state ``v_re + i v_im`` in one complex build and
        returns ``((out_re, out_im), iteration_count)``, as the JAX
        package's one embedded build does."""
        cop = self._herm()
        if cop is not None:
            out, itern = _expm.krylov_expm_apply(cop, a, self._slab(_expm.complex_state(cop, v_re, v_im)),
                                                 self._config(cop.n))
            out = linalg.gather_rows(out, self.operator)
            return (out.real, out.imag), itern
        v_re, v_im = self._real_parts(v_re, v_im, "run_split")
        (out_re, out_im), iters = _expm.krylov_expm_apply_split(self.operator, a, v_re, v_im, self._config())
        return tuple(linalg.gather_rows(t, self.operator) for t in (out_re, out_im)), iters

    def evolve(self, a, v_re, v_im, steps, krylov_dim: int = 12, renormalize: bool = False, precise: bool = False):
        """``steps`` applications of exp(a*A) to (v_re + i v_im) with no host
        wait between steps: a fixed ``krylov_dim`` build per part with full
        reorthogonalization (K3 on CUDA) and the small exponential on the
        device.  ``renormalize`` cancels norm drift in
        unitary evolution.  Returns ``(re, im)``.  ``precise=True`` carries
        the state, the build (over ``matvec_f64``) and the small exponential
        in float64 and returns host float64 ``(re, im)`` arrays, as the JAX
        package does; a float64 host state enters at full precision.  A
        complex Hermitian operator evolves the complex n-state ``v_re + i
        v_im`` with one complex build per step (``krylov_dim`` at least 16
        when precise, as in the JAX package)."""
        cop = self._herm()
        if cop is not None:
            if precise:
                return _expm.evolve_hermitian_split_precise(cop, self._precise(v_re), self._precise(v_im), a,
                                                            int(steps), max(int(krylov_dim), 16),
                                                            renormalize=renormalize)
            re, im = _expm.evolve_hermitian_split(cop, self._slab(v_re), self._slab(v_im), a, int(steps),
                                                  int(krylov_dim), renormalize=renormalize)
            return tuple(linalg.gather_rows(t, self.operator) for t in (re, im))
        if precise:
            re, im = _expm.evolve_split_precise(self.operator, self._precise(v_re), self._precise(v_im), a,
                                                int(steps), int(krylov_dim), renormalize=renormalize)
            return tuple(linalg.gather_rows(t, self.operator).cpu().numpy() for t in (re, im))
        v_re, v_im = self._real_parts(v_re, v_im, "evolve")
        re, im = _expm.evolve_split(self.operator, v_re, v_im, a, int(steps), int(krylov_dim), full_orth=True,
                                    renormalize=renormalize)
        return tuple(linalg.gather_rows(t, self.operator) for t in (re, im))

    def run_chebyshev(self, a, v_re, v_im=None, *, lo=None, hi=None, tol: float = 1e-16, precise: bool = False):
        """exp(a*A) (v_re + i v_im) by the Chebyshev propagator: ONE matvec
        chain of ~|a|*e terms for the whole evolution, no Krylov basis.
        ``lo``/``hi`` default to +-Gershgorin and MUST
        enclose the spectrum.  Returns ``((out_re, out_im), n_terms)``.
        ``precise=True`` runs the chain in float64 over ``matvec_f64``
        (host float64 in and out, as in the JAX package).  A complex
        Hermitian operator takes the complex chain on the complex n-state."""
        if self._herm() is not None:
            state = self._precise if precise else self._slab
            (out_re, out_im), terms = cheby_expm.chebyshev_expm_apply_hermitian(
                self.operator, a, state(v_re), state(np.zeros(len(v_re)) if v_im is None else v_im), lo=lo, hi=hi,
                tol=tol, precise=precise)
            if not precise:
                out_re, out_im = (linalg.gather_rows(t, self.operator) for t in (out_re, out_im))
            return (out_re, out_im), terms
        if precise:
            return cheby_expm.chebyshev_expm_apply_split_precise(
                self.operator, a, self._precise(v_re), None if v_im is None else self._precise(v_im), lo=lo, hi=hi,
                tol=tol)
        v_re, v_im = self._real_parts(v_re, v_im, "run_chebyshev")
        (out_re, out_im), terms = cheby_expm.chebyshev_expm_apply_split(self.operator, a, v_re, v_im, lo=lo, hi=hi,
                                                                        tol=tol)
        return tuple(linalg.gather_rows(t, self.operator) for t in (out_re, out_im)), terms

    def run_chebyshev_grid(self, a_list, v_re, v_im=None, *, lo=None, hi=None, tol: float = 1e-16):
        """exp(a_j*A) (v_re + i v_im) for every a_j from ONE Chebyshev chain;
        returns ``((out_re (num, n), out_im (num, n)), n_terms)``; complex
        n-states for a complex Hermitian operator."""
        if self._herm() is not None:
            (out_re, out_im), terms = cheby_expm.chebyshev_expm_grid_hermitian(
                self.operator, list(a_list), self._slab(v_re), self._slab(np.zeros(len(v_re)) if v_im is None else v_im),
                lo=lo, hi=hi, tol=tol)
        else:
            v_re, v_im = self._real_parts(v_re, v_im, "run_chebyshev_grid")
            (out_re, out_im), terms = cheby_expm.chebyshev_expm_grid_split(self.operator, list(a_list), v_re, v_im,
                                                                           lo=lo, hi=hi, tol=tol)
        return tuple(linalg.gather_rows(t, self.operator) for t in (out_re, out_im)), terms

    def run_batch(self, a, input_batch):
        """exp(a*A) applied to each row of a (B, n) batch: the row norms in
        one host read, then the device-resident build of ``mode='fused'``
        on each row, so each row's iteration count and output are those of
        ``run`` on it.  A zero row returns zeros with 1 iteration.  Returns
        ``(outputs (B, n), iterations (B,))``; complex (B, n) rows for a
        complex Hermitian operator."""
        op, cop = self.operator, self._herm()
        if cop is not None:
            op, v, cfg = cop, _expm.complex_state(cop, input_batch), self._config(cop.n)
        else:
            v, cfg = self._typed(input_batch, "run_batch"), self._config()
        if v.dim() != 2 or v.shape[1] != cfg.matrix_size:
            raise ValueError(f"run_batch takes a (B, {cfg.matrix_size}) batch, got shape {tuple(v.shape)}")
        outs, iters = _expm_fused.krylov_expm_apply_batch(op, a, self._slab(v), cfg)
        return linalg.gather_rows(outs, self.operator), iters

    def taylor_run(self, a, input_vector):
        """``(output, term_count)``: the Taylor-series fallback
        (exponentiator.hpp:175-210); complex n-states for a complex
        Hermitian operator."""
        cop = self._herm()
        if cop is not None:
            out, terms = _expm.taylor_expm_apply(cop, a, self._slab(_expm.complex_state(cop, input_vector)),
                                                 self._config(cop.n))
        else:
            out, terms = _expm.taylor_expm_apply(self.operator, a, self._vector(input_vector, "taylor_run"),
                                                 self._config())
        return linalg.gather_rows(out, self.operator), terms
