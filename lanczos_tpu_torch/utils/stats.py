"""Observability: iteration stats and profiler hooks (port of
``lanczos_tpu.utils.stats``).

The reference's only built-in observability is per-restart iteration counts
(``getIterationCounts``, lambda_lanczos.hpp:412-414).  The port keeps that,
adds wall-clock timing, and names its hot regions for ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["RunStats", "trace_span"]


@dataclasses.dataclass
class RunStats:
    iteration_counts: list[int] = dataclasses.field(default_factory=list)
    wall_time_s: float = 0.0
    # Small tridiagonal blocks whose native QL sweep hit its iteration cap
    # (reference tridiagonal_impl.hpp:290-343).  The port's host backends
    # (LAPACK, numpy) report no such count, so this stays 0 until the native
    # backend is ported.
    tridiag_unconverged: int = 0
    # Fused-engine iterations that ran a basis reorthogonalization: equal to
    # the total under reorth_policy='full'; under 'selective' the ratio to
    # the total is the omega-trigger rate.
    reorth_count: int = 0
    # Deflation rounds that exhausted their restart/iteration budget with
    # the Ritz values still moving (check api.residuals).
    unconverged_rounds: int = 0

    @property
    def total_iterations(self) -> int:
        return int(sum(self.iteration_counts))


@contextlib.contextmanager
def trace_span(name: str):
    """Name a region for ``torch.profiler`` (a no-op when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield
