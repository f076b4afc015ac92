"""Structured warning categories (port of ``lanczos_tpu.diagnostics``).

Every warning the port raises carries one of these classes, so
``warnings.filterwarnings("ignore", category=...)`` selects by class and not
by message text.  The names match the JAX package's one for one.
"""

from __future__ import annotations

__all__ = [
    "LanczosWarning",
    "BudgetExhaustedWarning",
    "BandCoverageWarning",
    "MissedCopyWarning",
    "AccuracyWarning",
    "OverflowGuardWarning",
]


class LanczosWarning(UserWarning):
    """Base class for every warning raised by lanczos_tpu_torch."""


class BudgetExhaustedWarning(LanczosWarning):
    """A deflation round used its whole max_restarts/max_iteration budget
    with the Ritz values still moving — results may be budget-limited."""


class BandCoverageWarning(LanczosWarning):
    """Filtered solve: some wanted eigenvalues likely lie outside the
    amplified mu-band."""


class MissedCopyWarning(LanczosWarning):
    """Filtered solve: a band state is missing from the returned set."""


class AccuracyWarning(LanczosWarning):
    """Results may be less accurate than requested."""


class OverflowGuardWarning(LanczosWarning):
    """A parameter was clipped to keep the arithmetic finite."""
