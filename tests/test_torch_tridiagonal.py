"""Tridiagonal layer of the PyTorch port against the JAX package: the Sturm
multisection of the fused engine's convergence test and the host solvers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from lanczos_tpu_torch.core import tridiagonal as ttri  # noqa: E402


def _tridiagonal(cap, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(cap) * 2.0, rng.uniform(0.1, 1.5, cap)


@pytest.mark.parametrize("find_maximum", [False, True])
@pytest.mark.parametrize("cap,size,nroot", [(16, 16, 3), (64, 40, 5), (96, 3, 5), (33, 1, 2)])
def test_sturm_multisection_matches_jax(cap, size, nroot, find_maximum):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = _tridiagonal(cap, seed=cap + size)
    want = np.asarray(jtri.extremal_eigenvalues_device(jnp.asarray(alpha), jnp.asarray(beta), size, nroot, find_maximum))
    got = ttri.extremal_eigenvalues_device(torch.from_numpy(alpha), torch.from_numpy(beta), size, nroot, find_maximum).numpy()
    limit = np.abs(alpha[:size]).sum() + 2.0 * np.abs(beta[: size - 1]).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float64).eps * limit)
    # and both are the true extremal eigenvalues of the leading block
    exact = np.linalg.eigvalsh(np.diag(alpha[:size]) + np.diag(beta[: size - 1], 1) + np.diag(beta[: size - 1], -1))
    k = min(nroot, size)
    exact = exact[::-1][:k] if find_maximum else exact[:k]
    np.testing.assert_allclose(got[:k], exact, rtol=0, atol=1e-12 * limit)


def test_sturm_multisection_float32_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = (x.astype(np.float32) for x in _tridiagonal(48, seed=4))
    want = np.asarray(jtri.extremal_eigenvalues_device(jnp.asarray(alpha), jnp.asarray(beta), 40, 5, False))
    got = ttri.extremal_eigenvalues_device(torch.from_numpy(alpha), torch.from_numpy(beta), 40, 5, False).numpy()
    assert got.dtype == np.float32
    limit = np.abs(alpha[:40]).sum() + 2.0 * np.abs(beta[:39]).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps * limit)


def test_sturm_counts_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = _tridiagonal(50, seed=9)
    cs = np.linspace(-6.0, 6.0, 37)
    want = np.asarray(jtri._sturm_counts(jnp.asarray(cs), jnp.asarray(alpha), jnp.asarray(beta**2), 45))
    got = ttri._sturm_counts(torch.from_numpy(cs), torch.from_numpy(alpha), torch.from_numpy(beta**2), 45).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["lapack", "numpy", "native", "bisect"])
def test_host_solvers_match_jax(backend):
    """The host backends against the JAX package's.  ``native`` and
    ``bisect`` compile the same source with the same flags in both
    packages, so they agree bit for bit, and the unconverged-block total
    moves by the same count in both (a NaN coupling never deflates, so
    every block of the QL sweep hits its cap)."""
    pytest.importorskip("jax")
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = _tridiagonal(30, seed=2)
    w_j, z_j = jtri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    w_t, z_t = ttri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    ext_j, ext_t = (
        [mod.extremal_eigvals_host(alpha, beta, 4, fm, backend=backend) for fm in (False, True)] for mod in (jtri, ttri)
    )
    if backend in ("native", "bisect"):
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_array_equal(z_t, z_j)
        np.testing.assert_array_equal(ext_t, ext_j)
    else:
        np.testing.assert_allclose(w_t, w_j, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(np.abs(np.sum(z_t * z_j, axis=1)), 1.0, atol=1e-12)
        np.testing.assert_allclose(ext_t, ext_j, rtol=1e-13, atol=1e-13)
    exact = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta[:29], 1) + np.diag(beta[:29], -1))
    np.testing.assert_allclose(w_t, exact, rtol=0, atol=1e-12 * np.abs(exact).max())
    if backend == "bisect":
        # the plain version: numpy eigenvalues, the backward recurrence and
        # two inverse iterations
        w_p, z_p = ttri._eigh_bisect_np(alpha, beta[:29])
        np.testing.assert_allclose(w_t, w_p, rtol=0, atol=1e-12 * np.abs(exact).max())
        np.testing.assert_allclose(np.abs(np.sum(z_t * z_p, axis=1)), 1.0, atol=1e-12)
    if backend == "native":
        bad = beta[:29].copy()
        bad[3] = np.nan
        before = (jtri.unconverged_total(), ttri.unconverged_total())
        jtri.eigh_tridiagonal_host(alpha, bad, eigvals_only=True, backend="native")
        ttri.eigh_tridiagonal_host(alpha, bad, eigvals_only=True, backend="native")
        moved = (jtri.unconverged_total() - before[0], ttri.unconverged_total() - before[1])
        assert moved[0] == moved[1] > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eigenvectors_backward_device_matches_jax(dtype):
    """The device backward recurrence against the JAX package's on the same
    (cap, size, lams): a strongly coupled tridiagonal, where the pure
    recurrence is accurate (the JAX package's own case), and size 1."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import tridiagonal as jtri

    rng = np.random.default_rng(13)
    m, cap = 19, 32
    alpha = np.zeros(cap, dtype)
    beta = np.zeros(cap, dtype)
    alpha[:m] = 0.3 * rng.standard_normal(m)
    beta[: m - 1] = -1.0
    t = np.diag(alpha[:m].astype(np.float64)) + np.diag(beta[: m - 1].astype(np.float64), 1)
    t += np.diag(beta[: m - 1].astype(np.float64), -1)
    lams = np.linalg.eigvalsh(t)[[0, 1, m - 1]].astype(dtype)
    want = np.asarray(jtri.eigenvectors_backward_device(jnp.asarray(alpha), jnp.asarray(beta), m, lams))
    for size in (m, torch.tensor(m)):  # a Python int or a 0-d tensor
        got = ttri.eigenvectors_backward_device(torch.from_numpy(alpha), torch.from_numpy(beta), size,
                                                torch.from_numpy(lams)).numpy()
        assert got.shape == (3, cap) and got.dtype == dtype and np.all(got[:, m:] == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == np.float64 else 2e-5)
        for v, lam in zip(got, lams):
            np.testing.assert_allclose(t @ v[:m], lam * v[:m], atol=1e-8 if dtype == np.float64 else 2e-3)
    one = ttri.eigenvectors_backward_device(torch.zeros(8, dtype=torch.float64).index_fill(0, torch.tensor([0]), 3.0),
                                            torch.zeros(8, dtype=torch.float64), 1, [3.0])
    np.testing.assert_allclose(one.numpy()[0], np.eye(8)[0], atol=1e-14)


def test_host_backend_resolution(monkeypatch, tmp_path):
    """``auto`` resolves as in the JAX package: ``native`` when the port's
    own library builds, which it does here (g++), into
    ``lanczos_tpu_torch/build/``; else ``lapack``.  A failed build raises
    with the compiler's message wherever ``native`` or ``bisect`` is asked
    for by name."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.native import build, host_kernels

    assert ttri._resolve_backend(None) == "native"
    assert ttri._resolve_backend("auto") == "native"
    assert ttri._resolve_backend("bisect") == "bisect"
    with pytest.raises(ValueError):
        ttri._resolve_backend("qr")
    with pytest.raises(ValueError):
        ttri.set_default_host_backend("qr")
    path = build.shared_object_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert not list(build.SOURCE.parent.glob("*.so"))  # nothing beside the source
    assert build.gxx_command("s.cpp", "o.so")[1:6] == ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=default"]
    try:
        ttri.set_default_host_backend("lapack")
        assert ttri._resolve_backend(None) == "lapack"
    finally:
        ttri.set_default_host_backend("auto")
    (w,) = ttri.eigh_tridiagonal_host([3.0], [], eigvals_only=True)
    assert w.tolist() == [3.0]

    bad = tmp_path / "host_kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build.shared_object_path()
    assert "error" in str(err.value)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(host_kernels, "_load", lambda: (None, str(err.value)))
    assert ttri._resolve_backend("auto") == "lapack"
    for backend in ("native", "bisect"):
        with pytest.raises(RuntimeError, match="not C\\+\\+"):
            ttri.eigh_tridiagonal_host([1.0, 2.0], [0.5], backend=backend)
