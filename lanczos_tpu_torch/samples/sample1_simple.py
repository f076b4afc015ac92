"""Dense maximum-eigenpair sample (reference: src/samples/sample1_simple.cpp;
port of samples/sample1_simple.py).

Find the largest eigenvalue of
    [[2, 1, 1],
     [1, 2, 1],
     [1, 1, 2]]   ->  lambda = 4, v = (1,1,1)/sqrt(3).

Run: ``python -m lanczos_tpu_torch.samples.sample1_simple`` (on the card;
``LT_SAMPLE_DEVICE=cpu`` for the CPU).
"""

import numpy as np

from lanczos_tpu_torch import LambdaLanczos
from lanczos_tpu_torch.samples import sample_device

matrix = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])

engine = LambdaLanczos(matrix, find_maximum=True, device=sample_device())
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.16g}")
print("Eigenvector:", " ".join(f"{float(x):.16g}" for x in eigenvector))
v = eigenvector.cpu().numpy()
exact = np.ones(3) / np.sqrt(3.0)
print(f"error eigenvalue: {abs(eigenvalue - 4.0):.3e}")
print(f"error eigenvector: {min(np.linalg.norm(v - exact), np.linalg.norm(v + exact)):.3e}")
