"""Block, thick-restart and precise engines (port of
samples/sample8_advanced_engines.py): block Lanczos on a triple-degenerate
top eigenvalue, thick restart under a 30-vector memory cap, block + thick on
a cluster, and precise_vectors + thick (float32 storage, float64 basis).

Run: ``python -m lanczos_tpu_torch.samples.sample8_advanced_engines``.
"""

import numpy as np

from lanczos_tpu_torch import LambdaLanczos
from lanczos_tpu_torch.samples import sample_device

device = sample_device()
rng = np.random.default_rng(7)

# --- block Lanczos on a triple-degenerate top eigenvalue --------------------
n = 60
q, _ = np.linalg.qr(rng.standard_normal((n, n)))
w = np.concatenate([[9.0, 9.0, 9.0], rng.uniform(-2, 2, n - 3)])
a = (q * w) @ q.T

eng = LambdaLanczos(a, find_maximum=True, num_eigs=3, device=device)
eng.block_size = 3
vals, vecs = eng.run()
print("block Lanczos, triple eigenvalue 9:", " ".join(f"{v:.12g}" for v in vals),
      f"({len(eng.iteration_counts)} restart(s))")
print(f"error block Lanczos: {np.abs(np.asarray(vals) - 9.0).max():.3e}")

# --- thick restart under a memory cap ---------------------------------------
n = 400
chain = np.zeros((n, n))
i = np.arange(n - 1)
chain[i, i + 1] = chain[i + 1, i] = -1.0

eng = LambdaLanczos(chain, find_maximum=False, device=device)
eng.eigenvalue_offset = -4.0
eng.max_iteration = 30          # hard cap: 30-vector basis for an n=400 problem
eng.max_restarts = 64
eng.restart_policy = "thick"
val, vec = eng.run_one()
print(f"thick restart: eigenvalue {val:.14g} (exact {-2*np.cos(np.pi/(n+1)):.14g}, "
      f"{eng.iteration_counts[0]} total iterations in a 30-vector basis)")
print(f"error thick restart: {abs(val + 2 * np.cos(np.pi / (n + 1))):.3e}")

# --- block + thick: a degenerate cluster under the same memory cap -----------
# Width-3 block cycles with thick restarts: the three lowest chain
# eigenvalues converge together, every reorthogonalization pass shared by
# the block.
eng = LambdaLanczos(chain, find_maximum=False, num_eigs=3, device=device)
eng.eigenvalue_offset = -4.0
eng.max_iteration = 48          # basis ROWS (16 width-3 blocks)
eng.max_restarts = 64
eng.restart_policy = "thick"
eng.block_size = 3
vals, vecs = eng.run()
exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
print("block+thick:", " ".join(f"{v:.12g}" for v in sorted(vals)),
      f"(exact {' '.join(f'{e:.12g}' for e in exact)}, "
      f"{len(eng.iteration_counts)} deflation round(s))")
print(f"error block+thick: {np.abs(np.sort(vals) - exact).max():.3e}")

# --- precise_vectors + thick: reference-grade accuracy, bounded memory -------
# A float64 Krylov basis over float32 storage, carried across thick-restart
# cycles: the reference's float64 tolerance regime with a fixed 40-row basis.
eng = LambdaLanczos(chain.astype(np.float32), find_maximum=False, num_eigs=2, dtype=np.float32, mode="fused",
                    device=device)
eng.precise_vectors = True
eng.restart_policy = "thick"
eng.max_iteration = 40
eng.max_restarts = 64
eng.eps = 1e-12
eng.eigenvalue_offset = -4.0
vals, vecs = eng.run()
exact2 = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
err = max(abs(v - e) for v, e in zip(sorted(vals), exact2))
print(f"precise_vectors+thick (f32 storage, 40-row basis): "
      f"{' '.join(f'{v:.14g}' for v in sorted(vals))} — max err {err:.2e}")
print(f"error precise_vectors+thick: {err:.3e}")
