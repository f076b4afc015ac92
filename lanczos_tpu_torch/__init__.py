"""lanczos_tpu_torch: the PyTorch and CUDA port of lanczos_tpu.

Extremal eigenpairs of symmetric operators by Lanczos with full
reorthogonalization and deflated restarts, on an NVIDIA Hopper GPU (or the
CPU).  The module tree and names mirror ``lanczos_tpu``; the two kernels of
the main path — the BSR sparse matvec (K1) and the classical Gram-Schmidt
pass (K3) — are hand-written CUDA in ``csrc/``, built with ``nvcc`` at first
use on the card.  This package imports PyTorch and never JAX.
"""

from .api import LambdaLanczos
from .diagnostics import (
    AccuracyWarning,
    BandCoverageWarning,
    BudgetExhaustedWarning,
    LanczosWarning,
    MissedCopyWarning,
    OverflowGuardWarning,
)
from .ops.operators import BSROperator, DenseOperator, FunctionOperator, LinearOperator, as_operator
from .solvers.lanczos import EigenPairManager, LanczosConfig, LanczosResult
from .utils.random import fixed_seed_initializer, random_initializer
from .utils.stats import RunStats

__all__ = [
    "LambdaLanczos",
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "BSROperator",
    "as_operator",
    "EigenPairManager",
    "LanczosConfig",
    "LanczosResult",
    "RunStats",
    "random_initializer",
    "fixed_seed_initializer",
    "LanczosWarning",
    "BudgetExhaustedWarning",
    "BandCoverageWarning",
    "MissedCopyWarning",
    "AccuracyWarning",
    "OverflowGuardWarning",
]
