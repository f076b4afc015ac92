"""Matrix-free sample (reference: src/samples/sample3_dynamic.cpp; port of
samples/sample3_dynamic.py).

The matrix is never materialized: the operator is a function of torch
tensors computing the 1D hopping stencil  (A x)_i = -x_{i-1} - x_{i+1}.
Minimum eigenvalue of the n-site chain is -2 cos(pi/(n+1)).

Run: ``python -m lanczos_tpu_torch.samples.sample3_dynamic``.
"""

import numpy as np
import torch

from lanczos_tpu_torch import LambdaLanczos
from lanczos_tpu_torch.samples import sample_device

n = 100


def mv_mul(x):
    left = torch.cat([x[1:], x.new_zeros(1)])
    right = torch.cat([x.new_zeros(1), x[:-1]])
    return -left - right


engine = LambdaLanczos(mv_mul, n, find_maximum=False, dtype=torch.float64, device=sample_device())
engine.eigenvalue_offset = -4.0  # Gershgorin bound of the stencil, negated
eigenvalue, eigenvector = engine.run_one()

exact = -2 * np.cos(np.pi / (n + 1))
print(f"Eigenvalue: {eigenvalue:.16g}")
print(f"Exact:      {exact:.16g}")
print(f"error eigenvalue: {abs(eigenvalue - exact):.3e}")
