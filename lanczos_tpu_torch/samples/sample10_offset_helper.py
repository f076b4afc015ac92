"""Eigenvalue-offset helpers (reference: the determine_eigenvalue_offset
demo; port of samples/sample10_offset_helper.py): the Gershgorin bound of a
structured operator, the power-iteration bound of a matrix-free one, and
what the offset saves.

Run: ``python -m lanczos_tpu_torch.samples.sample10_offset_helper``.
"""

import numpy as np

from lanczos_tpu_torch import DIAOperator, FunctionOperator, LambdaLanczos
from lanczos_tpu_torch.samples import sample_device
from lanczos_tpu_torch.utils.estimate import gershgorin_bound, power_bound, suggest_eigenvalue_offset

device = sample_device()

# --- 1. structured operator: exact Gershgorin bound (the reference demo) ---
n = 1000
op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, device=device)
r = gershgorin_bound(op)
print(f"Gershgorin bound (max row sum of |a_ij|): {r}")  # chain: 2.0

off = suggest_eigenvalue_offset(op, find_maximum=False)
print(f"suggested offset for the MINIMUM end: {off}")  # -2.0ish

eng = LambdaLanczos(op, find_maximum=False)
eng.eigenvalue_offset = off
eng.eps = 1e-12
val, vec = eng.run_one()
exact = -2 * np.cos(np.pi / (n + 1))
print(f"min eigenvalue: {val:.12f}  (exact {exact:.12f}, "
      f"{eng.iteration_counts[0]} iterations)")
print(f"error min eigenvalue: {abs(val - exact):.3e}")
assert abs(val - exact) < 1e-9


# --- 2. matrix-free operator: power-iteration bound --------------------------
def matmul(x):
    y = x.new_zeros(x.shape)
    y[:-1] -= x[1:]
    y[1:] -= x[:-1]
    return y


fop = FunctionOperator(matmul, n, np.float64, device=device)
rho = power_bound(fop, iters=30, seed=7)
print(f"matrix-free power bound on the spectral radius: {rho:.6f}")
assert rho >= 1.9  # true radius ~2

# Without an offset the same solve needs many more iterations:
eng0 = LambdaLanczos(op, find_maximum=False)
eng0.eps = 1e-12
val0, _ = eng0.run_one()
print(f"no offset: {eng0.iteration_counts[0]} iterations "
      f"(vs {eng.iteration_counts[0]} with the suggested offset)")
print(f"error no offset: {abs(val0 - exact):.3e}")
