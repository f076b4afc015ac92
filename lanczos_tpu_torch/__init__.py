"""lanczos_tpu_torch: the PyTorch and CUDA port of lanczos_tpu.

Extremal eigenpairs of symmetric operators by Lanczos with full
reorthogonalization and deflated restarts, on an NVIDIA Hopper GPU (or the
CPU, when asked with ``device="cpu"``).  The module tree and names mirror
``lanczos_tpu``; the kernels — the BSR sparse matvec (K1), the classical
Gram-Schmidt pass (K3), its block form (K4) and the Chebyshev filter's
recurrence chain (K5) — are hand-written CUDA in ``csrc/``, built with
``nvcc`` at first use on the card.  ``filtered_lanczos`` is the
Chebyshev-filtered solve.  This package
imports PyTorch and never JAX.
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
from .ops.filters import ChebyshevFilterOperator
from .ops.operators import (
    BSROperator,
    DenseOperator,
    DIAOperator,
    FunctionOperator,
    LinearOperator,
    ShiftSquaredOperator,
    as_operator,
)
from .solvers.filtered import filtered_lanczos
from .solvers.lanczos import EigenPairManager, LanczosConfig, LanczosResult
from .utils.random import fixed_seed_initializer, random_initializer
from .utils.stats import RunStats

__all__ = [
    "LambdaLanczos",
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "BSROperator",
    "DIAOperator",
    "ShiftSquaredOperator",
    "ChebyshevFilterOperator",
    "as_operator",
    "EigenPairManager",
    "LanczosConfig",
    "LanczosResult",
    "filtered_lanczos",
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
