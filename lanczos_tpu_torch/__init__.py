"""lanczos_tpu_torch: the PyTorch and CUDA port of lanczos_tpu.

Extremal eigenpairs of symmetric operators by Lanczos with full
reorthogonalization and deflated restarts, and exp(a*A) v by Krylov,
Taylor and Chebyshev expansions, on an NVIDIA Hopper GPU (or the CPU, when
asked with ``device="cpu"``).  The module tree and names mirror
``lanczos_tpu``; the kernels — the BSR sparse matvec (K1), its canonical
rsmk layout for the sharded operators (K2), the classical Gram-Schmidt pass
(K3), its block form (K4), the Chebyshev filter's recurrence chain (K5) and
the fused engine's convergence check (K6), and K1x, the BSR matvec of
float32 tiles against a float64 vector for the precise paths — are hand-written CUDA in
``csrc/``, built with ``nvcc`` at first use on the card.  Complex Hermitian
operators run natively (K1, K1x and K3 have complex64 and complex128
instances), and ``eigsh``, ``expm_multiply`` and ``minres`` are the
scipy-style facade.  ``filtered_lanczos`` is the Chebyshev-filtered solve and
``Exponentiator`` the exponentiation engine;
``lanczos_tpu_torch.parallel`` holds the row-partitioned operators over
``torch.distributed`` and its 2-D grids (``mesh``, exported here as in the
JAX package), and ``lanczos_tpu_torch.experiments`` the kernel
studies (three Gram-Schmidt pass variants, E2a-c, an in-place row write,
E3, and three BSR SpMV variants, E1, in ``csrc/``).  This package imports
PyTorch and never JAX.
"""

from .api import Exponentiator, LambdaLanczos
from .diagnostics import (
    AccuracyWarning,
    BandCoverageWarning,
    BudgetExhaustedWarning,
    LanczosWarning,
    MissedCopyWarning,
    OverflowGuardWarning,
)
from .ops.filters import ChebyshevFilterOperator
from .ops.hermitian_split import HermitianSplitOperator
from .ops.operators import (
    BSROperator,
    COOOperator,
    CSROperator,
    DenseDFOperator,
    DenseOperator,
    DIAOperator,
    FunctionOperator,
    LinearOperator,
    ScaledOperator,
    ShiftInvertOperator,
    ShiftSquaredOperator,
    SumOperator,
    as_operator,
)
from .parallel import mesh
from .scipy_compat import eigsh, expm_multiply
from .solvers.exponentiator import ExponentiatorConfig
from .solvers.filtered import filtered_lanczos
from .solvers.lanczos import EigenPairManager, LanczosConfig, LanczosResult
from .solvers.minres import minres
from .utils.random import fixed_seed_initializer, random_initializer
from .utils.stats import RunStats

__all__ = [
    "LambdaLanczos",
    "Exponentiator",
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "DenseDFOperator",
    "COOOperator",
    "CSROperator",
    "BSROperator",
    "DIAOperator",
    "SumOperator",
    "ScaledOperator",
    "ShiftSquaredOperator",
    "ShiftInvertOperator",
    "HermitianSplitOperator",
    "ChebyshevFilterOperator",
    "as_operator",
    "EigenPairManager",
    "LanczosConfig",
    "LanczosResult",
    "ExponentiatorConfig",
    "minres",
    "filtered_lanczos",
    "mesh",
    "eigsh",
    "expm_multiply",
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
