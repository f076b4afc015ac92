"""The PyTorch port's block engines — block Lanczos with warm restarts and
the fused block thick-restart engine — and its DIA operator, against the
JAX package on CPU in float64.

Both packages get the same matrix and the same start vectors (a seeded
numpy generator that advances per call).  Each JAX solve runs once per
module (the ``jax_solve`` fixture caches it).  The port's eigenvalues agree
with the JAX package's to 1e-11 absolute and its residuals meet the JAX
tests' bars; where a JAX test pins the number of deflation rounds, the port
meets the same pin.  Cases that reach a rank repair draw fresh random
directions, which differ between the packages, so they are held to numpy.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.ops import cgs  # noqa: E402
from lanczos_tpu_torch.solvers import block_thick as tbt  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    return torch.device("cuda")


def _ring(n=50):
    a = np.zeros((n, n))
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = 1.0
    a[0, n - 1] = a[n - 1, 0] = 1.0
    return a


def _exact_triple():
    n = 64
    dvals = np.concatenate([[1.0, 1.0, 1.0], np.linspace(2, 10, n - 3)])
    q, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(n, n)))
    return (q * dvals) @ q.T


def _separated():
    a = np.random.default_rng(3).normal(size=(200, 200))
    return (a + a.T) / 2


def _diag6():
    return np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])


def _simple3():
    return np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])


def _degenerate_pair():
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((20, 20)))
    w = np.concatenate([[5.0, 5.0], rng.uniform(-1, 1, 18)])
    return (q * w) @ q.T


# name -> (matrix, num_eigs, block_size, restart_policy, find_maximum,
#          settings, residual bar, most deflation rounds or None).
# The settings, bars and pins are those of tests/test_block_thick.py:48-130
# and tests/test_block_lanczos.py:18-66.
CASES = {
    "ring50_thick": (_ring, 5, 3, "thick", False, {"max_iteration": 24, "eps": 1e-12}, 1e-6, None),
    "exact_triple_thick": (_exact_triple, 3, 3, "thick", False, {"max_iteration": 20, "eps": 1e-12}, 1e-8, 2),
    "separated_thick": (_separated, 4, 2, "thick", False, {"max_iteration": 48, "eps": 1e-11}, 1e-7, None),
    "scalar_tail_thick": (_diag6, 6, 2, "thick", False, {"eps": 1e-13}, 1e-10, None),
    "simple3_block": (_simple3, 1, 2, "warm", True, {}, 1e-10, None),
    "degenerate_pair_block": (_degenerate_pair, 2, 2, "warm", True, {}, 1e-8, 2),
}


def _configure(eng, block, policy, settings):
    eng.block_size = block
    eng.restart_policy = policy
    for name, value in settings.items():
        setattr(eng, name, value)
    rng = np.random.default_rng(2024)
    eng.init_vector = lambda n: rng.uniform(-1.0, 1.0, n)
    return eng


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX package's (eigenvalues, iteration_counts) of a case, solved
    once per module."""
    pytest.importorskip("jax")
    from lanczos_tpu import LambdaLanczos

    cache = {}

    def solve(name):
        if name not in cache:
            build, k, block, policy, find_maximum, settings, _, _ = CASES[name]
            eng = _configure(LambdaLanczos(build(), find_maximum=find_maximum, num_eigs=k), block, policy, settings)
            vals, _ = eng.run()
            cache[name] = (np.asarray(vals), list(eng.iteration_counts))
        return cache[name]

    return solve


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_float64(jax_solve, name):
    build, k, block, policy, find_maximum, settings, res_bar, max_rounds = CASES[name]
    a = build()
    eng = _configure(tl.LambdaLanczos(a, find_maximum=find_maximum, num_eigs=k, device="cpu"), block, policy, settings)
    vals, vecs = eng.run()
    vj, counts_j = jax_solve(name)
    vals = np.asarray(vals)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-11)
    exact = np.sort(np.linalg.eigvalsh(a))
    exact = exact[::-1][:k] if find_maximum else exact[:k]
    np.testing.assert_allclose(np.sort(vals), np.sort(exact), rtol=0, atol=1e-9)
    assert max(eng.residuals(vals, vecs)) < res_bar
    if max_rounds is not None:
        assert len(eng.iteration_counts) <= max_rounds and len(counts_j) <= max_rounds
    if name == "exact_triple_thick":  # the three vectors span the eigenspace
        g = vecs.numpy() @ vecs.numpy().T
        np.testing.assert_allclose(g, np.eye(3), atol=1e-8)


def _dia_pair(offsets, n, seed, dtype=np.float64):
    """The same DIA operator in both packages; the stored diagonals carry
    junk where they run off the matrix (both packages ignore it)."""
    import jax.numpy as jnp
    from lanczos_tpu.ops.operators import DIAOperator

    data = np.random.default_rng(seed).standard_normal((len(offsets), n)).astype(dtype)
    jop = DIAOperator.from_diagonals(offsets, [jnp.asarray(d) for d in data], n)
    return jop, convert.dia_operator_from_arrays(jop.offsets, np.asarray(jop.data), n, device="cpu")


@pytest.mark.parametrize("rows", [None, 3])
def test_dia_matvec_matches_jax(rows):
    # One vector and a (b, n) block; the products and their order are the
    # JAX package's, so float64 agrees to the last bits.
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    n = 37
    jop, top = _dia_pair([-3, -1, 0, 2], n, seed=4)
    shape = (n,) if rows is None else (rows, n)
    x = np.random.default_rng(5).standard_normal(shape)
    want = np.asarray(jop.matvec(jnp.asarray(x)) if rows is None else jax.vmap(jop.matvec)(jnp.asarray(x)))
    got = top.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(got, (np.asarray(jop.to_dense()) @ x.T).T, rtol=1e-13, atol=1e-13)
    if rows is not None:
        np.testing.assert_array_equal(top.matvec_rows(torch.from_numpy(x)).numpy(), got)


def test_dia_from_coo_matches_jax():
    pytest.importorskip("jax")
    from lanczos_tpu.ops.operators import DIAOperator

    n = 30
    rng = np.random.default_rng(8)
    rows = rng.integers(0, n, 60)
    cols = np.clip(rows + rng.integers(-2, 3, 60), 0, n - 1)
    vals = rng.standard_normal(60)  # duplicates are summed by both
    jop = DIAOperator.from_coo(rows, cols, vals, n)
    top = tl.DIAOperator.from_coo(rows, cols, vals, n, device="cpu")
    assert top.offsets == jop.offsets
    np.testing.assert_allclose(top.data.numpy(), np.asarray(jop.data), rtol=1e-15, atol=1e-15)


def test_mgs_block_matches_jax_and_marks_dead_rows():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.solvers.block_thick import _mgs_block

    rng = np.random.default_rng(0)
    v = rng.normal(size=16)
    w = np.stack([v, 2.0 * v, rng.normal(size=16)])
    uj, rj, _, livej = _mgs_block(jnp.asarray(w), 1e-12)
    u, r, r64, live = tbt._mgs_block(torch.from_numpy(w), 1e-12)
    assert r64 is None
    assert live.tolist() == np.asarray(livej).tolist() == [True, False, True]
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-14)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=1e-13)
    assert r[1, 1] == 0.0 and torch.all(u[1] == 0)
    np.testing.assert_allclose(r.numpy().T @ u.numpy(), w, atol=1e-10)  # W = R^T U


def test_mgs_block_precise_r_entries():
    # float32 block, float64 dots: R matches the float64 Gram-Schmidt of the
    # rounded inputs to ~1e-7 relative where float32 reductions drift ~n eps.
    n = 1 << 16
    w64 = np.random.default_rng(5).normal(size=(2, n))
    w32 = torch.from_numpy(w64.astype(np.float32))
    _, r, r64, live = tbt._mgs_block(w32, 1e-12, precise=True)
    assert bool(live.all()) and r.dtype == torch.float32 and r64.dtype == torch.float64
    x = w32.double().numpy()
    r00 = np.linalg.norm(x[0])
    r01 = np.dot(x[0] / r00, x[1])
    r11 = np.linalg.norm(x[1] - r01 * x[0] / r00)
    np.testing.assert_allclose(r64.numpy(), [[r00, r01], [0.0, r11]], rtol=1e-6)


def _thick_engine(a, k, b, **settings):
    eng = tl.LambdaLanczos(a, num_eigs=k, find_maximum=settings.pop("find_maximum", False), device="cpu")
    return _configure(eng, b, "thick", settings)


def test_f32_dia_chain_cluster_precise():
    # float32 + DIA (the flagship's shape at n=1024): the float64 block dots
    # keep the cluster under the float32 dot floor (the JAX test's 2e-6).
    n = 1024
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device="cpu")
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _thick_engine(op, 3, 3, max_iteration=128, eps=1e-7, max_restarts=12, eigenvalue_offset=-4.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tl.BudgetExhaustedWarning)
        vals, vecs = eng.run()
    assert vecs.dtype == torch.float32
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 2e-6


def test_partial_collapse_repair_fires_and_recovers(monkeypatch):
    # A start row inside an exactly invariant coordinate pair of a diagonal
    # matrix dies with space left; the repair must fire and the solve reach
    # the eigenvalues outside.  Complex dtype covers the complex fresh draw.
    n = 48
    a = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    eng = _thick_engine(a, 2, 2, find_maximum=True, max_iteration=24, eps=1e-10)
    calls = {"k": 0}
    rng = np.random.default_rng(6)

    def init(n_):
        calls["k"] += 1
        v = rng.uniform(-1, 1, n_) + 1j * rng.uniform(-1, 1, n_)
        if calls["k"] == 1:
            v[2:] = 0.0
        return v

    eng.init_vector = init
    hits = {"n": 0}
    orig = tbt._repair_candidates

    def spy(*args, **kw):
        hits["n"] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(tbt, "_repair_candidates", spy)
    vals, vecs = eng.run()
    assert hits["n"] >= 1, "partial-collapse repair path never fired"
    np.testing.assert_allclose(np.sort(vals)[::-1], [48.0, 47.0], atol=1e-8)
    assert max(eng.residuals(vals, vecs)) < 1e-7


def test_repair_candidates_revives_dead_rows():
    # Basis block [0, 2), candidate block [2, 4) with row 2 live and row 3
    # dead (zero), one deflated vector: the dead row is replaced by a fresh
    # direction orthonormal to all of them; the live row is untouched.
    n, b = 24, 2
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(n, 4)))
    u_buf = torch.zeros((8, n), dtype=torch.float64)
    u_buf[:3] = torch.from_numpy(q[:, :3].T)
    defl = torch.from_numpy(q[:, 3][None].copy())
    fresh = torch.from_numpy(rng.uniform(-1, 1, (b, n)))
    block, revived = tbt._repair_candidates(u_buf, defl, torch.ones(1, dtype=torch.float64), fresh, np.array([False, True]), 4)
    assert revived.tolist() == [False, True]
    blk = block.numpy()
    np.testing.assert_array_equal(blk[0], q[:, 2])
    assert abs(np.linalg.norm(blk[1]) - 1.0) < 1e-12
    np.testing.assert_allclose(q.T @ blk[1], 0.0, atol=1e-12)


@pytest.mark.parametrize("n", [120, 100])
def test_space_exhaustion_includes_candidate_rows(n):
    # cap = n: the build exhausts the space; the candidate block's live rows
    # (all of them at n=120, one at n=100) join the final Rayleigh-Ritz.
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, device="cpu")
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _thick_engine(op, 3, 3, max_iteration=n, eps=1e-12, eigenvalue_offset=-4.0)
    vals, vecs = eng.run()
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 1e-11
    assert max(eng.residuals(vals, vecs)) < 1e-9


def test_fixed_seed_identical_rows_repaired():
    n = 30
    eng = _thick_engine(np.diag(np.linspace(1, 4, n)), 2, 2, max_iteration=16, eps=1e-12)
    v = np.random.default_rng(11).normal(size=n)
    eng.init_vector = lambda n_: v  # both block rows identical
    vals, _ = eng.run()
    np.testing.assert_allclose(np.sort(vals), np.linspace(1, 4, n)[:2], atol=1e-9)


def test_budget_stall_distinct_targets_hint():
    n = 96
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, device="cpu")
    eng = _thick_engine(op, 3, 3, max_iteration=12, max_restarts=2, eps=1e-14, eigenvalue_offset=-4.0)
    with pytest.warns(tl.BudgetExhaustedWarning, match="block_size=1"):
        eng.run()


@pytest.mark.parametrize("block_size", [2, 4])
def test_block_lanczos_multiroot(block_size):
    a = np.random.default_rng(7).standard_normal((24, 24))
    a = (a + a.T) / 2
    eng = tl.LambdaLanczos(a, num_eigs=4, device="cpu")
    eng.block_size = block_size
    eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=3)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(a)[:4], atol=1e-9)
    assert max(eng.residuals(vals, vecs)) < 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_thick_on_cuda_runs_k4(cuda, dtype):
    # Three decoupled 100-site chains: every eigenvalue is an exact triple,
    # which the width-3 block captures in one round.
    m = 100
    n = 3 * m
    lower = np.full(n, -1.0)
    lower[[m, 2 * m]] = 0.0  # A[i, i-1]
    upper = np.full(n, -1.0)
    upper[[m - 1, 2 * m - 1]] = 0.0  # A[i, i+1]
    op = tl.DIAOperator.from_diagonals([-1, 1], [lower, upper], n, dtype=dtype, device=cuda)
    eng = tl.LambdaLanczos(op, num_eigs=3)
    eng.block_size = 3
    eng.restart_policy = "thick"
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 60
    eng.max_restarts = 48
    eng.eps = 1e-6 if dtype == torch.float32 else 1e-11
    rng = np.random.default_rng(2024)
    eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_)
    before = cgs.cgs_pass_block.launches
    vals, vecs = eng.run()
    assert cgs.cgs_pass_block.launches > before
    exact = np.full(3, -2 * np.cos(np.pi / (m + 1)))
    tol = 2e-6 if dtype == torch.float32 else 1e-9
    np.testing.assert_allclose(np.sort(vals), exact, rtol=0, atol=tol)
    assert vecs.device.type == "cuda"
