"""Multiple-eigenpair sample (reference: src/samples/sample5_multiroot.cpp;
port of samples/sample5_multiroot.py).

Find the 2 largest eigenpairs of an 8x8 matrix with deflated restarts.

Run: ``python -m lanczos_tpu_torch.samples.sample5_multiroot``.
"""

import numpy as np

from lanczos_tpu_torch import LambdaLanczos
from lanczos_tpu_torch.samples import sample_device

n = 8
rng = np.random.default_rng(42)
a = rng.standard_normal((n, n))
a = (a + a.T) / 2

engine = LambdaLanczos(a, find_maximum=True, num_eigs=2, device=sample_device())
eigenvalues, eigenvectors = engine.run()

check = np.linalg.eigvalsh(a)[::-1][:2]
print("Eigenvalues:", " ".join(f"{v:.12g}" for v in eigenvalues))
print("numpy check:", " ".join(f"{v:.12g}" for v in check))
vecs = eigenvectors.cpu().numpy()
for k in range(len(eigenvalues)):
    r = np.linalg.norm(a @ vecs[k] - eigenvalues[k] * vecs[k])
    print(f"residual[{k}] = {r:.3e}")
    print(f"error residual: {r:.3e}")
print(f"error eigenvalues: {np.abs(np.asarray(eigenvalues) - check).max():.3e}")
