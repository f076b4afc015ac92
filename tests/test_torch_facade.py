"""The PyTorch port's scipy-style facade (``eigsh``, ``expm_multiply``,
``minres``, ``ShiftInvertOperator``) against the JAX package's on the CPU,
and the JAX facade's known faults held to numpy and scipy.

Real operands go through both packages from the same numpy arrays in
float64: eigenvalues agree to 1e-12 relative to the spectral radius and
eigenvectors to an |overlap| of 1 - 1e-10; ``minres`` gives the same ``x``
to 1e-12 relative, the same iteration count and the same ``info``; the
exponentials agree to 1e-12 relative.  The faults of the JAX facade (R1-R4
in ROADMAP.md) are held to numpy/scipy, not to the JAX package:

* R1: complex ``eigsh`` at the default tolerance, k = 2 smallest of an
  n = 24 random Hermitian, within 1e-12 of ``eigvalsh`` (the JAX package
  returns -2.48 where -7.55 is right);
* R2: ``eigsh(method='filtered')`` where the filtered solve misses the
  second value, within 1e-10 of ``eigvalsh`` with an ``AccuracyWarning``;
* R3: complex ``expm_multiply`` against ``scipy.sparse.linalg.
  expm_multiply`` at the reference's 2.2e-14 overlap bar (the JAX tests
  accept 1e-4 and 1e-6 relative);
* R4: complex ``eigsh(sigma=)`` within 1e-10 of dense ``eigh``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import scipy_compat  # noqa: E402

EPS_REF = np.finfo(np.float64).eps * 1e2  # the reference's overlap bar, exponentiator.hpp:58
VALUES = 1e-12
VECTORS = 1e-10
N = 40


def _overlap_err(truth, out):
    t = np.asarray(truth, np.complex128).ravel()
    o = np.asarray(out, np.complex128).ravel()
    return abs(1.0 - abs(np.vdot(t, o)) / (np.linalg.norm(t) * np.linalg.norm(o)))


def _symmetric(n, seed, deep=True):
    """The n-site chain with a random potential and, with ``deep``, three
    deep sites: well-separated extremal eigenvalues."""
    rng = np.random.default_rng(seed)
    a = np.diag(rng.uniform(-1.0, 1.0, n)) - np.eye(n, k=1) - np.eye(n, k=-1)
    if deep:
        a[[3, n // 2, n - 5], [3, n // 2, n - 5]] = [-4.0, -3.2, 3.6]
    return a


def _pairs_agree(w_jax, v_jax, w_t, v_t, scale):
    assert np.max(np.abs(np.asarray(w_t) - np.asarray(w_jax))) <= VALUES * scale
    for j in range(v_t.shape[1]):
        assert 1 - abs(np.vdot(v_jax[:, j], v_t[:, j])) <= VECTORS, j


def test_eigsh_matches_jax_on_real_operands():
    """``eigsh`` on a real symmetric matrix: each ``which``, the
    shift-invert senses (the nearest-sigma one at the default tolerance
    goes to the filtered interior mode in both packages) and
    ``method='filtered'`` at both ends of a chain the JAX filtered solve
    gets right.  On the matrix with deep sites the JAX filtered solve
    misses the second and third values (R2), and the port's are held to
    ``eigvalsh``."""
    import lanczos_tpu as lj

    a = _symmetric(N, 31)
    w = np.linalg.eigvalsh(a)
    scale = np.abs(w).max()
    sigma = 0.5 * (w[N // 2] + w[N // 2 + 1]) + 0.1 * (w[N // 2 + 1] - w[N // 2])
    chain = _symmetric(N, 31, deep=False)
    cases = [(a, dict(which=which)) for which in ("LM", "LA", "SA", "BE")]
    cases += [(a, dict(which="SM", tol=1e-10))]
    cases += [(a, dict(sigma=sigma, which=which, tol=1e-10)) for which in ("LM", "LA", "SA")]
    cases += [(chain, dict(which=which, method="filtered")) for which in ("SA", "LA")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX facade's MINRES floor warning for float64 too
        for mat, kw in cases:
            wj, vj = lj.eigsh(mat, k=3, **kw)
            wt, vt = tl.eigsh(mat, k=3, device="cpu", **kw)
            assert vt.shape == (N, 3) and wt.dtype == np.float64, kw
            _pairs_agree(wj, vj, wt, vt, scale)
            if "sigma" not in kw and kw["which"] != "SM":
                assert np.linalg.norm(mat @ vt - vt * wt, axis=0).max() <= 1e-6, kw
        wj = lj.eigsh(a, k=3, which="SA", method="filtered", return_eigenvectors=False)
    assert np.max(np.abs(wj - w[:3])) > 0.1  # R2 in the JAX facade
    with pytest.warns(tl.AccuracyWarning, match="solved again"):
        wt = tl.eigsh(a, k=3, which="SA", method="filtered", device="cpu", return_eigenvectors=False)
    assert np.max(np.abs(wt - w[:3])) <= VALUES * scale
    np.testing.assert_array_equal(tl.eigsh(a, k=2, which="SA", device="cpu", return_eigenvectors=False).shape, (2,))
    with pytest.raises(TypeError, match="unknown engine option"):
        tl.eigsh(a, k=2, device="cpu", no_such_option=1)
    with pytest.raises(ValueError, match="which must be"):
        tl.eigsh(a, k=2, which="XX", device="cpu")


def test_minres_shift_invert_and_expm_multiply_match_jax():
    """``minres`` (the solver and the scipy-style call, converged and cut
    by maxiter), ``ShiftInvertOperator.matvec``, and ``expm_multiply`` at a
    point, on a time grid and on a block."""
    import jax.numpy as jnp
    import lanczos_tpu as lj
    from lanczos_tpu.scipy_compat import minres as jax_scipy_minres

    a = _symmetric(N, 32)
    w = np.linalg.eigvalsh(a)
    # An indefinite system, the shift in the gap below the top eigenvalue:
    # MINRES converges in 27 iterations, before its Lanczos vectors lose
    # orthogonality (past ~n iterations the two packages' roundings part).
    shift = 0.5 * (w[-2] + w[-1])
    b = np.random.default_rng(33).standard_normal(N)
    jop, top = lj.DenseOperator(jnp.asarray(a)), tl.DenseOperator(a, device="cpu")
    for tol, maxiter in ((1e-10, 400), (1e-10, 7)):
        xj, rj, kj = lj.minres(jop, jnp.asarray(b), shift=shift, tol=tol, maxiter=maxiter)
        xt, rt, kt = tl.minres(top, torch.from_numpy(b), shift=shift, tol=tol, maxiter=maxiter)
        assert kt == int(kj) and (maxiter > 7 or kt == maxiter)
        assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-12 * np.linalg.norm(np.asarray(xj))
        assert abs(float(rt) - float(rj)) <= 1e-6 * max(float(rj), 1e-300)
        xs, info_t = scipy_compat.minres(a, b, shift=shift, rtol=tol, maxiter=maxiter, device="cpu")
        _xs, info_j = jax_scipy_minres(a, b, shift=shift, rtol=tol, maxiter=maxiter)
        assert info_t == info_j == (0 if maxiter > 7 else 7)
    assert np.linalg.norm((a - shift * np.eye(N)) @ xs - b) <= 1e-9 * np.linalg.norm(b) or info_t
    jsi = lj.ShiftInvertOperator(jop, jnp.asarray(shift), 1e-12, 400)
    tsi = tl.ShiftInvertOperator(top, shift, 1e-12, 400)
    assert (tsi.n, tsi.dtype) == (N, torch.float64)
    yj, yt = np.asarray(jsi.matvec(jnp.asarray(b))), tsi.matvec(torch.from_numpy(b)).numpy()
    assert np.linalg.norm(yt - yj) <= 1e-12 * np.linalg.norm(yj)

    v = np.random.default_rng(34).standard_normal((N, 3))
    # An imaginary t (both packages' stop tests agree there); the grid's
    # real times with eps = 1e-28, where the JAX build runs to n (R7) and
    # the port's stops once the coefficients settle to ~1e-14.
    for kw, bb in ((dict(t=-0.5j), v[:, 0]), (dict(t=-0.5j), v),
                   (dict(start=0.0, stop=0.8, num=4, eps=1e-28), v[:, 0]),
                   (dict(start=0.0, stop=0.8, num=3, endpoint=False, eps=1e-28), v[:, :2]),
                   (dict(t=-0.5j, method="chebyshev"), v[:, 0]), (dict(start=0.0, stop=0.8, num=4,
                                                                        method="chebyshev"), v[:, 0])):
        oj = np.asarray(lj.expm_multiply(a, bb, **kw))
        ot = tl.expm_multiply(a, bb, device="cpu", **kw)
        assert ot.shape == oj.shape, kw
        assert np.linalg.norm(ot - oj) <= 1e-12 * np.linalg.norm(oj), kw


def test_reference_faults_are_repaired():
    """R1, R2, R3, R4 and R9 (ROADMAP.md queue 3) against numpy and scipy."""
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla

    # R1: complex Hermitian input at the default tolerance.
    rng = np.random.default_rng(7)
    c = rng.standard_normal((24, 24)) + 1j * rng.standard_normal((24, 24))
    h = (c + c.conj().T) / 2
    wh = np.linalg.eigvalsh(h)
    w, v = tl.eigsh(h, k=2, which="SA", device="cpu")
    assert np.max(np.abs(w - wh[:2])) <= VALUES * np.abs(wh).max() and abs(w[1] - (-7.548447740)) < 1e-8
    assert np.linalg.norm(h @ v - v * w, axis=0).max() <= 1e-8
    w32 = tl.eigsh(h.astype(np.complex64), k=2, which="SA", device="cpu", return_eigenvectors=False)
    assert np.max(np.abs(w32 - np.linalg.eigvalsh(h.astype(np.complex64).astype(np.complex128))[:2])) <= 1e-12 * 10

    # R2: the filtered solve misses the second value (a BandCoverageWarning);
    # eigsh solves that end again through the plain engines.
    a = np.random.default_rng(1).standard_normal((24, 24))
    a = (a + a.T) / 2
    wa = np.linalg.eigvalsh(a)
    with pytest.warns(tl.AccuracyWarning, match="solved again through the plain Lanczos engines"):
        w = tl.eigsh(a, k=2, which="SA", method="filtered", device="cpu", return_eigenvectors=False)
    assert np.max(np.abs(w - wa[:2])) <= 1e-10

    # R3: complex expm_multiply against scipy at the reference's bar.
    psi = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    for t in (-0.7j, 0.4 - 0.3j):
        want = spla.expm_multiply(t * h, psi)
        for method in ("auto", "chebyshev"):
            got = tl.expm_multiply(h, psi, t=t, method=method, device="cpu")
            assert _overlap_err(want, got) <= EPS_REF, (t, method, _overlap_err(want, got))
        tight = tl.expm_multiply(h, psi, t=t, device="cpu", eps=1e-28)
        assert np.linalg.norm(tight - want) <= 1e-12 * np.linalg.norm(want)
    grid = tl.expm_multiply(h, psi, start=0.0, stop=1.0, num=3, device="cpu")
    assert np.linalg.norm(grid[2] - sla.expm(h) @ psi) <= 1e-7 * np.linalg.norm(grid[2])

    # R9: a real operator and a complex b on the Krylov route, at a point
    # and on a grid (the JAX facade casts b to the operator's real dtype).
    for t in (-0.7, 0.5j):
        want = spla.expm_multiply(t * a, psi)
        got = tl.expm_multiply(a, psi, t=t, method="auto", device="cpu", eps=1e-28)
        assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want), t
        assert _overlap_err(want, tl.expm_multiply(a, psi, t=t, device="cpu")) <= EPS_REF, t
    want = spla.expm_multiply(a, psi, start=0.0, stop=1.0, num=3)
    grid = tl.expm_multiply(a, psi, start=0.0, stop=1.0, num=3, device="cpu", eps=1e-28)
    assert np.linalg.norm(grid - want) <= 1e-9 * np.linalg.norm(want)

    # R4: complex shift-invert, each sense.
    sigma = 0.5 * (wh[11] + wh[12]) + 0.05
    for which, want in (("LM", np.sort(wh[np.argsort(np.abs(wh - sigma))[:2]])), ("LA", wh[12:14]),
                        ("SA", wh[10:12])):
        w, v = tl.eigsh(h, k=2, sigma=sigma, which=which, device="cpu")
        assert np.max(np.abs(w - want)) <= 1e-10, which
        assert np.linalg.norm(h @ v - v * w, axis=0).max() <= 1e-8, which
