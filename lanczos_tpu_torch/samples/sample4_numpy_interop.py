"""Foreign-array interop sample (reference:
src/samples/sample4_use_Eigen_library.cpp; port of
samples/sample4_numpy_interop.py).

The reference shows Eigen::Map interop; the analogue here is interop with
numpy and torch: pass the array straight in, or wrap an existing matmul
routine as the matvec.

Run: ``python -m lanczos_tpu_torch.samples.sample4_numpy_interop``.
"""

import numpy as np
import torch

from lanczos_tpu_torch import LambdaLanczos
from lanczos_tpu_torch.samples import sample_device

device = sample_device()
matrix = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])

# a) numpy array directly (converted to a DenseOperator)
val_a, _ = LambdaLanczos(matrix, find_maximum=True, device=device).run_one()

# b) an existing "library" matvec wrapped as a matrix-free operator
a_dev = torch.from_numpy(matrix).to(device)
val_b, _ = LambdaLanczos(lambda x: a_dev @ x, 3, find_maximum=True, dtype=a_dev.dtype, device=device).run_one()

print(f"Eigenvalue (array): {val_a:.16g}")
print(f"Eigenvalue (matvec): {val_b:.16g}")
print(f"error eigenvalue (array): {abs(val_a - 4.0):.3e}")
print(f"error eigenvalue (matvec): {abs(val_b - 4.0):.3e}")
