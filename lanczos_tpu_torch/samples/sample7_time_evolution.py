"""Krylov time evolution sample (reference:
src/samples/sample_exponentiator.cpp; port of
samples/sample7_time_evolution.py).

A particle on a 200-site chain, started on the middle site, evolved by
exp(-i H dt) for 5 steps of dt = 0.5: the Krylov exponentiator step by
step, the device-resident ``evolve`` (all steps with no host wait between
them), its precise form (float32 storage, float64 arithmetic) and the
Chebyshev propagator, each held to ``scipy.linalg.expm``.

Run: ``python -m lanczos_tpu_torch.samples.sample7_time_evolution``.
"""

import numpy as np
import scipy.linalg
import torch

from lanczos_tpu_torch import DIAOperator, Exponentiator
from lanczos_tpu_torch.samples import sample_device

device = sample_device()
n = 200
h = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, device=device)
dense = np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)

psi = np.zeros(n, dtype=complex)
psi[n // 2] = 1.0  # localized start
psi0 = psi.copy()
dt = 0.5
truth = [scipy.linalg.expm(-1j * dt * (s + 1) * dense) @ psi0 for s in range(5)]

expo = Exponentiator(h, dtype=torch.complex128)
psi = torch.from_numpy(psi).to(device)
for step in range(5):
    psi, iters = expo.run(-1j * dt, psi)
    norm = float(torch.linalg.vector_norm(psi))
    spread = float(torch.sum(psi.abs() ** 2 * (torch.arange(n, device=device) - n // 2) ** 2) ** 0.5)
    print(f"t={dt * (step + 1):4.1f}  norm={norm:.15f}  spread={spread:7.3f}  krylov_iters={iters}")
    # the reference's measure: the overlap error 1 - |<truth, psi>|
    print(f"error step-by-step overlap vs expm: {1.0 - abs(np.vdot(truth[step], psi.cpu().numpy())):.3e}")
psi = psi.cpu().numpy()

# The same evolution device-resident: all steps with no host wait between
# them (a fixed krylov_dim build a step, the small exponential on the device).
expo_r = Exponentiator(h, dtype=torch.float64)
start = np.zeros(n)
start[n // 2] = 1.0
out_re, out_im = expo_r.evolve(-1j * dt, start, np.zeros(n), steps=5, krylov_dim=14)
out = out_re.cpu().numpy() + 1j * out_im.cpu().numpy()
norm = float(np.linalg.norm(out))
overlap = abs(np.vdot(psi, out))
print(f"device-resident evolve: norm={norm:.12f}, overlap with step-by-step={overlap:.12f}")
print(f"error evolve vs expm: {np.linalg.norm(out - truth[-1]):.3e}")

# Precise evolution: float64 arithmetic on float32 storage, returned as host
# float64 arrays.
h32 = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32)], n,
                                 device=device)
expo_p = Exponentiator(h32, dtype=torch.float32)
pre_re, pre_im = expo_p.evolve(-1j * dt, start, np.zeros(n), steps=5, krylov_dim=14, precise=True)
overlap_p = abs(np.vdot(psi, pre_re + 1j * pre_im))
print(f"precise evolve:         dtype={pre_re.dtype}, overlap with f64 step-by-step={overlap_p:.12f}")
print(f"error precise evolve vs expm: {np.linalg.norm(pre_re + 1j * pre_im - truth[-1]):.3e}")

# Chebyshev propagator: the whole evolution as one ~|t*e|-term matvec chain
# (no per-step Krylov builds, O(1) extra memory), and a grid of times from
# one chain.
(ch_re, ch_im), n_terms = expo_p.run_chebyshev(-1j * dt * 5, start, lo=-2.0, hi=2.0)
ch = ch_re.double().cpu().numpy() + 1j * ch_im.double().cpu().numpy()
overlap_c = abs(np.vdot(psi, ch))
print(f"chebyshev chain:        {n_terms} terms, overlap with step-by-step={overlap_c:.12f}")
print(f"error chebyshev chain vs expm: {np.linalg.norm(ch - truth[-1]):.3e}")
(traj_re, traj_im), _ = expo_p.run_chebyshev_grid([-1j * dt * (s + 1) for s in range(5)], start, lo=-2.0, hi=2.0)
print(f"chebyshev trajectory:   {traj_re.shape[0]} snapshots from one chain")
traj = traj_re.double().cpu().numpy() + 1j * traj_im.double().cpu().numpy()
for s in range(5):
    print(f"error chebyshev trajectory vs expm: {np.linalg.norm(traj[s] - truth[s]):.3e}")
