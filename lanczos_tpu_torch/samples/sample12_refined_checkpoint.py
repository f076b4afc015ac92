"""Reference-grade eigenpairs from float32 storage, resume-safe (port of
samples/sample12_refined_checkpoint.py): the precise filtered solve with
refined vectors under a checkpoint, then a complex Hermitian matrix at the
same accuracy.

Run: ``python -m lanczos_tpu_torch.samples.sample12_refined_checkpoint``.
"""

import os
import tempfile

import numpy as np

from lanczos_tpu_torch import DenseOperator, DIAOperator, filtered_lanczos
from lanczos_tpu_torch.ops.hermitian_split import solve_hermitian
from lanczos_tpu_torch.samples import sample_device

device = sample_device()

# --- float64-grade eigenpairs (values AND vectors) from f32 storage ---------
n = 2000
op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=device)
with tempfile.TemporaryDirectory() as tmp:
    vals, vecs, info = filtered_lanczos(
        op, num_eigs=3, lo=-2.0, hi=2.0, precise=True,
        checkpoint_path=os.path.join(tmp, "solve_state"),  # resume-safe
    )
exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
print("eigenvalue errors:", [f"{abs(float(vals[i]) - exact[i]):.2e}" for i in range(3)])
print("vector residuals: ", [f"{r:.2e}" for r in info["residuals"]],
      f"({info['refine_sweeps']} refinement sweeps)")
for i in range(3):
    print(f"error eigenvalue: {abs(float(vals[i]) - exact[i]):.3e}")
for r in info["residuals"]:
    print(f"error vector residual: {r:.3e}")
assert max(abs(float(vals[i]) - exact[i]) for i in range(3)) < 1e-12
assert max(info["residuals"]) < 1e-10  # reference's eigenvector bar, f32 storage

# --- complex Hermitian at the same accuracy --------------------------------
rng = np.random.default_rng(0)
m = 80
H = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
H = (H + H.conj().T) / 2
Hr = np.real(H).astype(np.float32)
Hi = np.imag(H).astype(np.float32)
H64 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
H64 = (H64 + H64.conj().T) / 2
hvals, hvecs = solve_hermitian(
    DenseOperator(Hr, device=device), DenseOperator(Hi, device=device),
    num_eigs=2, method="filtered", precise=True)
w_true = np.linalg.eigvalsh(H64)
print("hermitian value errors:", [f"{abs(np.sort(hvals)[i] - w_true[i]):.2e}" for i in range(2)])
hres = [float(np.linalg.norm(H64 @ hvecs[i] - hvals[i] * hvecs[i])) for i in range(2)]
print("hermitian residuals:   ", [f"{r:.2e}" for r in hres])
for i in range(2):
    print(f"error hermitian value: {abs(np.sort(hvals)[i] - w_true[i]):.3e}")
for r in hres:
    print(f"error hermitian residual: {r:.3e}")
assert max(abs(np.sort(hvals)[i] - w_true[i]) for i in range(2)) < 1e-10
assert max(hres) < 1e-10
print("sample12 OK")
