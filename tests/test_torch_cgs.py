"""Kernels K3 (classical Gram-Schmidt pass) and K4 (its block form) of the
PyTorch port: their plain versions against the JAX package's Pallas passes
(interpret mode) and CPU paths, and — on a CUDA device — the hand-written
kernels against their plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from lanczos_tpu_torch.core import linalg as tlinalg  # noqa: E402
from lanczos_tpu_torch.ops import cgs  # noqa: E402

KS = [0, 1, 63, 64, 100, 128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _problem(k, cap, n, dtype, seed):
    """Orthonormal live rows [0, k) of a (cap, n) buffer, zero dead rows, and
    a vector with large components in the live span."""
    rng = np.random.default_rng(seed)
    basis = np.zeros((cap, n), dtype)
    if k:
        basis[:k] = np.linalg.qr(rng.standard_normal((n, k)))[0].T
    v = rng.standard_normal(n).astype(dtype)
    if k:
        v = v + 10.0 * basis[: min(k, 4)].sum(axis=0)
    return basis, v


@pytest.mark.parametrize("k", KS)
def test_plain_matches_pallas_interpret_float32(k):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.ops import pallas_cgs

    basis, v = _problem(k, 129, 256, np.float32, seed=k + 3)
    want = np.asarray(pallas_cgs.cgs_pass(jnp.asarray(v), jnp.asarray(basis), k, interpret=True))
    got = cgs.cgs_pass_reference(torch.from_numpy(v), torch.from_numpy(basis), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(np.abs(v).max(), 1))


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("k", KS)
def test_plain_matches_jax_cpu_path_float64(k, passes):
    # The Pallas pass is float32-only; in float64 the JAX package's CPU path
    # (masked classical GS) is the oracle.
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import linalg as jlinalg

    basis, v = _problem(k, 129, 256, np.float64, seed=k + 5)
    want = np.asarray(jlinalg.orthogonalize_bcgs_dyn(jnp.asarray(v), jnp.asarray(basis), k, passes=passes))
    got = tlinalg.orthogonalize_bcgs_dyn(torch.from_numpy(v), torch.from_numpy(basis), k, passes=passes).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(np.abs(v).max(), 1))


def test_deflation_projection_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import linalg as jlinalg

    basis, v = _problem(5, 8, 64, np.float64, seed=11)
    mask = (np.arange(8) < 5).astype(np.float64)
    want = np.asarray(jlinalg.orthogonalize_cgs2(jnp.asarray(v), jnp.asarray(basis), jnp.asarray(mask)))
    got = tlinalg.orthogonalize_cgs2(torch.from_numpy(v), torch.from_numpy(basis), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(v).max())


def test_cpu_pass_launches_nothing():
    basis, v = _problem(3, 4, 32, np.float64, seed=1)
    before = cgs.cgs_pass.launches
    out = cgs.cgs_pass(torch.from_numpy(v), torch.from_numpy(basis), 3)
    assert cgs.cgs_pass.launches == before
    assert np.abs(basis[:3] @ out.numpy()).max() < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", KS + [129])
@pytest.mark.parametrize("n", [256, 4099, 70000])
def test_kernel_matches_plain_on_cuda(cuda, dtype, k, n):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    basis, v = _problem(k, 129, n, np_dtype, seed=k + n)
    want = cgs.cgs_pass_reference(torch.from_numpy(v), torch.from_numpy(basis), k)
    before = cgs.cgs_pass.launches
    vd = torch.from_numpy(v).to(cuda)
    got = cgs.cgs_pass(vd, torch.from_numpy(basis).to(cuda), k)
    torch.cuda.synchronize()
    assert cgs.cgs_pass.launches == before + (1 if k else 0)
    assert got.data_ptr() == vd.data_ptr()  # in place, like the aliased Pallas output
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol * max(float(np.abs(v).max()), 1.0))


BLOCK_KS = [0, 1, 64, 100]


def _block_problem(k, b, cap, n, dtype, seed):
    """The vector problem of :func:`_problem` with a (b, n) block."""
    basis, _ = _problem(k, cap, n, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    v = rng.standard_normal((b, n)).astype(dtype)
    if k:
        v = v + 10.0 * rng.standard_normal((b, min(k, 4))).astype(dtype) @ basis[: min(k, 4)]
    return basis, v


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", BLOCK_KS)
def test_block_plain_matches_pallas_interpret_float32(k, b):
    # The Pallas block kernel is float32: rtol 1e-5 of the block's scale
    # covers the two summation orders.
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.ops import pallas_cgs

    basis, v = _block_problem(k, b, 129, 256, np.float32, seed=k + 7 * b)
    want = np.asarray(pallas_cgs.cgs_pass_block(jnp.asarray(v), jnp.asarray(basis), k, interpret=True))
    got = cgs.cgs_pass_block_reference(torch.from_numpy(v), torch.from_numpy(basis), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(v).max(), 1))


@pytest.mark.parametrize("passes", [1, 2])
def test_block_pass_matches_jax_cpu_path_float64(passes):
    # The JAX block engine's CPU path masks the whole buffer; the port's plain
    # pass reads the live rows only.  Same result up to summation order.
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.solvers import block_thick as jbt

    from lanczos_tpu_torch.solvers import block_thick as tbt

    basis, v = _block_problem(100, 3, 129, 256, np.float64, seed=13)
    want = np.asarray(jbt._bcgs_block(jnp.asarray(v), jnp.asarray(basis), 100, passes=passes))
    got = tbt._bcgs_block(torch.from_numpy(v), torch.from_numpy(basis), 100, passes=passes).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(v).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("k", BLOCK_KS + [129])
@pytest.mark.parametrize("n", [256, 4099, 70001])
def test_block_kernel_matches_plain_on_cuda(cuda, dtype, b, k, n):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    basis, v = _block_problem(min(k, 129), b, 129, n, np_dtype, seed=k + n + b)
    want = cgs.cgs_pass_block_reference(torch.from_numpy(v), torch.from_numpy(basis), k)
    before = cgs.cgs_pass_block.launches
    vd = torch.from_numpy(v).to(cuda)
    got = cgs.cgs_pass_block(vd, torch.from_numpy(basis).to(cuda), k)
    torch.cuda.synchronize()
    assert cgs.cgs_pass_block.launches == before + (1 if k else 0)
    assert got.data_ptr() == vd.data_ptr()  # in place, like the aliased Pallas output
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol * max(float(np.abs(v).max()), 1.0))


@pytest.mark.gpu
def test_block_kernel_refuses_unsupported_on_cuda(cuda):
    basis = torch.zeros((4, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgs.cgs_pass_block(torch.zeros((2, 8), dtype=torch.complex64, device=cuda), basis, 1)
    with pytest.raises(ValueError):
        cgs.cgs_pass_block(torch.zeros((17, 8), device=cuda), torch.zeros((4, 8), device=cuda), 1)
