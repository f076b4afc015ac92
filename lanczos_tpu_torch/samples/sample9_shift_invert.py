"""Interior eigenvalues by shift-invert and the filtered interior mode (port
of samples/sample9_shift_invert.py): the scipy-style ``eigsh(sigma=)`` and
``minres`` facade.

Run: ``python -m lanczos_tpu_torch.samples.sample9_shift_invert``.
"""

import numpy as np

from lanczos_tpu_torch.samples import sample_device
from lanczos_tpu_torch.scipy_compat import eigsh, minres

device = sample_device()

# A hopping chain with a linear potential: a dense interior spectrum.
n = 500
main = np.linspace(0.0, 5.0, n)
a = np.diag(main) + np.diag(-np.ones(n - 1), 1) + np.diag(-np.ones(n - 1), -1)

sigma = 2.5  # target: eigenvalues nearest the middle of the spectrum
w, v = eigsh(a, k=4, sigma=sigma, which="LM", tol=1e-10, device=device)
w, v = np.asarray(w), np.asarray(v)
res = [float(np.linalg.norm(a @ v[:, i] - w[i] * v[:, i])) for i in range(4)]
print(f"4 eigenvalues nearest sigma={sigma}:", " ".join(f"{x:.10g}" for x in w))
print("residuals:", " ".join(f"{r:.1e}" for r in res))
for r in res:
    print(f"error residual: {r:.3e}")

exact = np.linalg.eigvalsh(a)
nearest = np.sort(exact[np.argsort(np.abs(exact - sigma))[:4]])
print("max |err| vs dense eigensolver:", f"{np.abs(np.sort(w) - nearest).max():.2e}")
print(f"error shift-invert vs dense: {np.abs(np.sort(w) - nearest).max():.3e}")

# The underlying solver is scipy-compatible MINRES (indefinite-safe):
b = np.random.default_rng(0).normal(size=n)
x, info = minres(a, b, shift=sigma, rtol=1e-10, maxiter=4 * n, device=device)
x = np.asarray(x)
true_res = np.linalg.norm((a - sigma * np.eye(n)) @ x - b)
print(f"minres solve: info={info}, true residual {true_res:.1e}")
print(f"error minres residual: {true_res:.3e}")

# The filtered interior mode (no linear solves): eigsh(method='filtered')
# routes sigma through the squared spectral transform instead of
# shift-invert, so sigma exactly on an eigenvalue is its best-conditioned
# case, with precise (inverse-map) values at tight tol.
wf, vf = eigsh(a, k=4, sigma=sigma, which="LM", method="filtered", device=device)
wf = np.asarray(wf)
print("filtered interior:", " ".join(f"{x:.10g}" for x in wf))
print("max |err| vs dense eigensolver:", f"{np.abs(np.sort(wf) - nearest).max():.2e}")
print(f"error filtered vs dense: {np.abs(np.sort(wf) - nearest).max():.3e}")
