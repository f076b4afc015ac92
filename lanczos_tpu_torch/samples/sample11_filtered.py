"""The Chebyshev-filtered solve (port of samples/sample11_filtered.py): the
three lowest eigenvalues of a 2**14-site chain from a basis of at most 48
rows, at the filter's mu-grade accuracy and with ``precise=True`` at the
reference's.

Run: ``python -m lanczos_tpu_torch.samples.sample11_filtered``.
"""

import numpy as np

from lanczos_tpu_torch import DIAOperator, filtered_lanczos
from lanczos_tpu_torch.samples import sample_device

# 1D chain (free-particle hopping): analytic spectrum -2 cos(k pi / (n+1)),
# the flagship problem's shape.  At n in the millions the plain engines
# spend ~100x the matvec cost on reorthogonalization per iteration; the
# filtered solve keeps a <=48-row basis instead.
n = 1 << 14
op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=sample_device())
exact = sorted(-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(n))[:3]

vals, vecs, info = filtered_lanczos(
    op,
    num_eigs=3,
    degree=200,        # filter polynomial degree: p matvecs per iteration
    mu=1e-4,           # amplified band width = eigenvalue-error budget
    lo=-2.0, hi=2.0,   # chain spectrum known analytically; omit to estimate
)

print("3 lowest eigenvalues:", [f"{v:.8f}" for v in vals])
print("errors vs analytic:  ", [f"{abs(v - e):.2e}" for v, e in zip(vals, exact)])
print("B-space iterations:  ", info["iteration_counts"], "(basis <= 48 rows)")
print("total stencil matvecs:", info["matvecs"])
print("residual norms:      ", [f"{r:.2e}" for r in info["residuals"]])
for v, e in zip(vals, exact):
    print(f"error filtered vs analytic: {abs(v - e):.3e}")
assert all(abs(v - e) < 2e-4 for v, e in zip(vals, exact))

# --- precise=True: the spectral inverse-map refinement ---------------------
# The same problem at reference-grade accuracy from float32 storage: the
# B-space solve runs on float64 vectors and its Ritz values map back through
# the analytic inverse of the filter polynomial, whose steepness attenuates
# the B-space error on the way back.
pvals, pvecs, pinfo = filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, precise=True)
print("precise eigenvalues: ", [f"{v:.15f}" for v in pvals])
print("errors vs analytic:  ", [f"{abs(v - e):.2e}" for v, e in zip(pvals, exact)])
for v, e in zip(pvals, exact):
    print(f"error precise vs analytic: {abs(v - e):.3e}")
assert all(abs(v - e) < 1e-11 for v, e in zip(pvals, exact))
