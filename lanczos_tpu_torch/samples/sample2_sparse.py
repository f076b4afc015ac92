"""Sparse (COO triplet) minimum-eigenvalue sample
(reference: src/samples/sample2_sparse.cpp; port of samples/sample2_sparse.py).

The 3x3 antisymmetric-pattern matrix
    0  1  1
    1  0 -1
    1 -1  0
has eigenvalues {1, 1, -2}; find the minimum.  ``eigenvalue_offset`` shifts
the spectrum so the wanted end has the largest magnitude — the Gershgorin
bound from :func:`lanczos_tpu_torch.utils.estimate.suggest_eigenvalue_offset`
is a safe choice (reference: src/determine_eigenvalue_offset).

Run: ``python -m lanczos_tpu_torch.samples.sample2_sparse``.
"""

import numpy as np

from lanczos_tpu_torch import COOOperator, LambdaLanczos
from lanczos_tpu_torch.samples import sample_device
from lanczos_tpu_torch.utils.estimate import suggest_eigenvalue_offset

rows = [0, 0, 1, 1, 2, 2]
cols = [1, 2, 0, 2, 0, 1]
vals = [1.0, 1.0, 1.0, -1.0, 1.0, -1.0]

op = COOOperator.from_arrays(rows, cols, np.asarray(vals), 3, device=sample_device())

engine = LambdaLanczos(op, find_maximum=False)
engine.eigenvalue_offset = suggest_eigenvalue_offset(op, find_maximum=False)  # -2.0
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.16g}")  # expect -2
print("Eigenvector:", " ".join(f"{float(x):.16g}" for x in eigenvector))
dense = np.zeros((3, 3))
dense[rows, cols] = vals
v = eigenvector.cpu().numpy()
print(f"error eigenvalue: {abs(eigenvalue + 2.0):.3e}")
print(f"error residual: {np.linalg.norm(dense @ v - eigenvalue * v):.3e}")
