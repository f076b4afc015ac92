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


@pytest.mark.parametrize("backend", ["lapack", "numpy"])
def test_host_solvers_match_jax(backend):
    pytest.importorskip("jax")
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = _tridiagonal(30, seed=2)
    w_j, z_j = jtri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    w_t, z_t = ttri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.abs(np.sum(z_t * z_j, axis=1)), 1.0, atol=1e-12)
    for find_maximum in (False, True):
        np.testing.assert_allclose(
            ttri.extremal_eigvals_host(alpha, beta, 4, find_maximum, backend=backend),
            jtri.extremal_eigvals_host(alpha, beta, 4, find_maximum, backend=backend),
            rtol=1e-13, atol=1e-13,
        )


def test_host_backend_resolution():
    assert ttri._resolve_backend(None) == "lapack"
    assert ttri._resolve_backend("auto") == "lapack"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttri._resolve_backend("native")
    with pytest.raises(ValueError):
        ttri._resolve_backend("qr")
    assert ttri.unconverged_total() == 0
    (w,) = ttri.eigh_tridiagonal_host([3.0], [], eigvals_only=True)
    assert w.tolist() == [3.0]
