"""The PyTorch port's scalar thick-restart engines (hybrid and fused)
against the JAX package on CPU in float64, and against analytic spectra.

The parity case caps the basis below the unrestarted iteration count, so
thick restarts happen; each JAX solve runs once per module.  The port's
eigenvalues agree with the JAX package's to 1e-12 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch.ops import cgs, spmv  # noqa: E402

MODES = ["hybrid", "fused"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    return torch.device("cuda")


def _chain(n):
    a = np.zeros((n, n))
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = -1.0
    return a


def _chain_exact(n, k):
    return np.array([-2 * np.cos((j + 1) * np.pi / (n + 1)) for j in range(k)])


def _thick(eng, **settings):
    eng.restart_policy = "thick"
    for name, value in settings.items():
        setattr(eng, name, value)
    rng = np.random.default_rng(2024)
    eng.init_vector = lambda n: rng.uniform(-1.0, 1.0, n)
    return eng


# n=150 chain, two lowest pairs, offset -4: a 24-row basis restarts about
# ten times per round.
PARITY_N = 150
PARITY = {"num_eigs": 2, "max_iteration": 24, "eps": 1e-10, "eigenvalue_offset": -4.0}


@pytest.fixture(scope="module")
def jax_thick():
    pytest.importorskip("jax")
    from lanczos_tpu import LambdaLanczos

    cache = {}

    def solve(mode):
        if mode not in cache:
            settings = dict(PARITY)
            eng = _thick(LambdaLanczos(_chain(PARITY_N), num_eigs=settings.pop("num_eigs"), mode=mode), **settings)
            vals, _ = eng.run()
            cache[mode] = (np.asarray(vals), list(eng.iteration_counts))
        return cache[mode]

    return solve


@pytest.mark.parametrize("mode", MODES)
def test_thick_matches_jax_float64(jax_thick, mode):
    settings = dict(PARITY)
    eng = _thick(tl.LambdaLanczos(_chain(PARITY_N), num_eigs=settings.pop("num_eigs"), mode=mode, device="cpu"), **settings)
    vals, vecs = eng.run()
    vj, counts_j = jax_thick(mode)
    np.testing.assert_allclose(vals, vj, rtol=1e-12, atol=0)
    np.testing.assert_allclose(vals, _chain_exact(PARITY_N, 2), rtol=1e-9)
    assert max(eng.residuals(vals, vecs)) < 1e-4
    # thick restarts happened: each round ran past one basis' worth
    assert min(eng.iteration_counts) > PARITY["max_iteration"]
    assert min(counts_j) > PARITY["max_iteration"]


def test_thick_gapless_chain_bounded_memory():
    # The README's case: the n=400 gap-less chain under a 30-vector cap
    # reaches ~1e-14, where warm restarts stall near 1e-9.
    n = 400
    eng = _thick(tl.LambdaLanczos(_chain(n), device="cpu"), max_iteration=30, eps=1e-13, max_restarts=64, eigenvalue_offset=-4.0)
    val, vec = eng.run_one()
    assert abs(val - _chain_exact(n, 1)[0]) < 1e-12
    assert eng.iteration_counts[0] > 30


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_thick_fused_policies_f32_dia(policy):
    # float32 operator: float64 alpha/||w||^2 carry the host's arrowhead.
    n = 400
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device="cpu")
    eng = _thick(tl.LambdaLanczos(op, num_eigs=2, mode="fused"), max_iteration=32, eps=1e-6, eigenvalue_offset=-4.0,
                 reorth_policy=policy, max_restarts=64)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, _chain_exact(n, 2), atol=2e-6)
    assert vecs.dtype == torch.float32
    assert min(eng.iteration_counts) > 32  # restarted
    if policy == "full":
        assert eng.stats.reorth_count == sum(eng.iteration_counts)
    else:
        assert eng.stats.reorth_count < sum(eng.iteration_counts)


def test_thick_complex_hermitian_find_maximum():
    rng = np.random.default_rng(42)
    n = 40
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h = (h + h.conj().T) / 2
    exact = np.sort(np.linalg.eigvalsh(h))[::-1][:3]
    for mode in MODES:
        eng = _thick(tl.LambdaLanczos(h, num_eigs=3, find_maximum=True, mode=mode, device="cpu"), max_iteration=16, eps=1e-12)
        eng.init_vector = lambda n_: rng.uniform(-1, 1, n_) + 1j * rng.uniform(-1, 1, n_)
        vals, vecs = eng.run()
        np.testing.assert_allclose(np.sort(vals)[::-1], exact, atol=1e-9)
        assert max(eng.residuals(vals, vecs)) < 1e-7


def test_thick_keep_validation():
    eng = _thick(tl.LambdaLanczos(_chain(40), device="cpu"), max_iteration=12, thick_keep=0)
    with pytest.raises(ValueError, match="thick_keep"):
        eng.run()


@pytest.mark.gpu
def test_thick_fused_on_cuda_runs_the_kernels(cuda):
    n = 1000
    i = np.arange(n - 1)
    op = tl.BSROperator.from_coo(np.r_[i, i + 1], np.r_[i + 1, i], -np.ones(2 * n - 2), n, bm=64, bk=64,
                                 dtype=torch.float64, device=cuda)
    eng = _thick(tl.LambdaLanczos(op, num_eigs=2), max_iteration=96, eps=1e-10, eigenvalue_offset=-4.0, max_restarts=64)
    k1, k3 = spmv.bsr_matvec.launches, cgs.cgs_pass.launches
    vals, _ = eng.run()
    assert spmv.bsr_matvec.launches > k1 and cgs.cgs_pass.launches > k3
    np.testing.assert_allclose(vals, _chain_exact(n, 2), rtol=1e-8)
