"""The PyTorch port's main path — ``LambdaLanczos`` over the hybrid and
fused engines — against the JAX package on the reference test zoo.

Both packages get the same operator (built with ``lanczos_tpu_torch.convert``
or from the same numpy arrays), the same start vector and the same host
tridiagonal backend.  In float64 the eigenvalues agree to 1e-12 relative,
each eigenvector lies in the JAX package's eigenspace of its eigenvalue to
1e-10, and the per-round iteration counts are equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.ops import cgs, spmv  # noqa: E402

MODES = ["hybrid", "fused"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    return torch.device("cuda")


def _chain_coo(n, potential=None):
    i = np.arange(n - 1)
    rows, cols, vals = np.concatenate([i, i + 1]), np.concatenate([i + 1, i]), -np.ones(2 * (n - 1))
    if potential is not None:
        d = np.arange(n)
        rows, cols, vals = np.concatenate([rows, d]), np.concatenate([cols, d]), np.concatenate([vals, potential])
    return rows, cols, vals


def _dense_case(a):
    import jax.numpy as jnp
    from lanczos_tpu import DenseOperator

    return DenseOperator(jnp.asarray(a)), convert.dense_operator_from_array(a, device="cpu")


def _simple3():
    return _dense_case(np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]]))


def _single():
    return _dense_case(np.array([[2.0]]))


def _random_symmetric():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 40))
    return _dense_case((a + a.T) / 2)


def _chain_function(n=64):
    import jax.numpy as jnp
    from lanczos_tpu import FunctionOperator

    def jax_mv(x):
        return -jnp.concatenate([x[1:], jnp.zeros(1, x.dtype)]) - jnp.concatenate([jnp.zeros(1, x.dtype), x[:-1]])

    def torch_mv(x):
        y = torch.zeros_like(x)
        y[:-1] -= x[1:]
        y[1:] -= x[:-1]
        return y

    return FunctionOperator(jax_mv, n, np.float64), tl.FunctionOperator(torch_mv, n, torch.float64, device="cpu")


def _ring_function(n=50):
    import jax.numpy as jnp
    from lanczos_tpu import FunctionOperator

    def jax_mv(x):
        return -jnp.roll(x, 1) - jnp.roll(x, -1)

    def torch_mv(x):
        return -torch.roll(x, 1) - torch.roll(x, -1)

    return FunctionOperator(jax_mv, n, np.float64), tl.FunctionOperator(torch_mv, n, torch.float64, device="cpu")


def _bsr_chain(n=300, dtype=np.float64):
    from lanczos_tpu import BSROperator

    pot = np.random.default_rng(3).uniform(0.0, 1.0, n)
    op = BSROperator.from_coo(*_chain_coo(n, pot), n, bm=16, bk=16, dtype=dtype)
    return op, convert.bsr_operator_from_arrays(np.asarray(op.blocks), np.asarray(op.col_blocks), n, op.layout, device="cpu")


# (case, find_maximum, num_eigs, eps, offset).  A breakdown (beta below
# 10 machine eps) is decided at the rounding level, so on exhausted or
# degenerate Krylov spaces the two packages' counts can differ by one
# iteration for some start vectors (the 3x3 with offset 6, the ring with
# num_eigs >= 4 in hybrid mode); these cases and seeds do not sit on that
# edge.
ZOO = {
    "simple3": (_simple3, True, 1, None, 0.0),
    "chain64_offset": (_chain_function, False, 1, 1e-14, -4.0),
    "bsr_chain300": (_bsr_chain, False, 2, None, 0.0),
    "random40_3": (_random_symmetric, False, 3, None, 0.0),
    "ring50": (_ring_function, False, 3, None, 0.0),
    "single": (_single, True, 1, None, 0.0),
}


def _solve_both(jax_op, torch_op, mode, find_maximum, num_eigs, eps, offset, dtype=np.float64, seed=1):
    from lanczos_tpu import LambdaLanczos

    v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, jax_op.n).astype(dtype)
    engines = [
        LambdaLanczos(jax_op, find_maximum=find_maximum, num_eigs=num_eigs, mode=mode),
        tl.LambdaLanczos(torch_op, find_maximum=find_maximum, num_eigs=num_eigs, mode=mode),
    ]
    out = []
    for eng in engines:
        eng.init_vector = lambda n: v0
        eng.tridiag_backend = "lapack"
        eng.eigenvalue_offset = offset
        if eps is not None:
            eng.eps = eps
        vals, vecs = eng.run()
        out.append((np.asarray(vals), np.asarray(vecs), eng))
    return out


def _assert_same_eigenpairs(vj, Vj, vt, Vt, rtol=1e-12, vec_tol=1e-10):
    assert vt.shape == vj.shape
    np.testing.assert_allclose(vt, vj, rtol=rtol, atol=rtol * np.abs(vj).max())
    # Each port vector lies in the JAX eigenspace of its eigenvalue (a
    # degenerate eigenvalue has no unique eigenvector).
    for i in range(len(vt)):
        near = np.abs(vj - vt[i]) <= 1e-8 * max(np.abs(vj).max(), 1.0)
        proj = Vj[near] @ Vt[i]
        assert np.linalg.norm(proj) >= 1.0 - vec_tol, (i, np.linalg.norm(proj))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ZOO))
def test_zoo_matches_jax_float64(case, mode):
    pytest.importorskip("jax")
    build, find_maximum, num_eigs, eps, offset = ZOO[case]
    jax_op, torch_op = build()
    (vj, Vj, ej), (vt, Vt, et) = _solve_both(jax_op, torch_op, mode, find_maximum, num_eigs, eps, offset)
    assert et.iteration_counts == ej.iteration_counts
    _assert_same_eigenpairs(vj, Vj, vt, Vt)
    assert et.stats.iteration_counts == et.iteration_counts
    if mode == "fused":
        assert et.stats.reorth_count == ej.stats.reorth_count


@pytest.mark.parametrize("engine", ["lanczos_run", "lanczos_run_fused"])
def test_engine_runs_match_jax(engine):
    # The JAX package's engine-under-the-deflation-driver entry points
    # (solvers/lanczos.py:557, solvers/lanczos_fused.py:615) and
    # core.tridiagonal.machine_eps_value.
    from lanczos_tpu.core import tridiagonal as jtri
    from lanczos_tpu.solvers import lanczos as jlz, lanczos_fused as jlf

    from lanczos_tpu_torch.core import tridiagonal as ttri
    from lanczos_tpu_torch.solvers import lanczos as tlz, lanczos_fused as tlf

    for dtype in (np.float32, np.float64, np.complex64, np.complex128):
        assert ttri.machine_eps_value(dtype) == jtri.machine_eps_value(dtype)
    jax_op, torch_op = _random_symmetric()
    v0 = np.random.default_rng(1).uniform(-1.0, 1.0, jax_op.n)
    module = {"lanczos_run": (jlz, tlz), "lanczos_run_fused": (jlf, tlf)}[engine]
    results = [
        getattr(mod, engine)(op, cfg_type(matrix_size=op.n, num_eigs=3, tridiag_backend="lapack"), lambda n: v0,
                             np.float64)
        for mod, op, cfg_type in ((module[0], jax_op, jlz.LanczosConfig), (module[1], torch_op, tlz.LanczosConfig))
    ]
    (rj, rt) = results
    assert list(rt.iteration_counts) == list(rj.iteration_counts)
    np.testing.assert_allclose(np.asarray(rt.eigenvalues), np.asarray(rj.eigenvalues), rtol=0, atol=1e-12)
    _assert_same_eigenpairs(np.asarray(rj.eigenvalues), np.asarray(rj.eigenvectors), np.asarray(rt.eigenvalues),
                            np.asarray(rt.eigenvectors))


def test_fused_float32_matches_jax():
    pytest.importorskip("jax")
    jax_op, torch_op = _bsr_chain(200, np.float32)
    assert jax_op.layout == "rmsk"
    (vj, _, _), (vt, Vt, et) = _solve_both(jax_op, torch_op, "fused", False, 2, 1e-6, 0.0, dtype=np.float32)
    np.testing.assert_allclose(vt, vj, rtol=1e-4)
    assert Vt.dtype == np.float32
    assert max(et.residuals(vt, Vt)) < 1e-3


def test_fused_selective_matches_jax():
    pytest.importorskip("jax")
    from lanczos_tpu import LambdaLanczos

    n = 200
    a = np.zeros((n, n))
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = -1.0
    v0 = np.random.default_rng(21).uniform(-1.0, 1.0, n)
    out = []
    for eng in (LambdaLanczos(a, mode="fused"), tl.LambdaLanczos(a, mode="fused", device="cpu")):
        eng.eigenvalue_offset = -4.0
        eng.eps = 1e-13
        eng.reorth_policy = "selective"
        eng.tridiag_backend = "lapack"
        eng.init_vector = lambda n: v0
        val, vec = eng.run_one()
        out.append((val, np.asarray(vec), eng))
    (vj, xj, ej), (vt, xt, et) = out
    assert abs(vt - vj) <= 1e-12 * abs(vj)
    assert abs(xj @ xt) >= 1.0 - 1e-10
    assert et.iteration_counts == ej.iteration_counts
    assert 0 < et.stats.reorth_count < sum(et.iteration_counts)
    assert et.stats.reorth_count == ej.stats.reorth_count


def test_warm_restarts_match_jax():
    # max_iteration caps the basis below convergence: warm restarts reach
    # the same eigenvalue.
    pytest.importorskip("jax")
    from lanczos_tpu import LambdaLanczos

    rng = np.random.default_rng(2)
    a = rng.standard_normal((120, 120))
    jax_op, torch_op = _dense_case((a + a.T) / 2)
    for mode in MODES:
        engines = []
        for eng in (
            LambdaLanczos(jax_op, find_maximum=True, mode=mode),
            tl.LambdaLanczos(torch_op, find_maximum=True, mode=mode),
        ):
            eng.max_iteration = 20
            eng.eps = 1e-12
            eng.tridiag_backend = "lapack"
            v0 = np.random.default_rng(13).uniform(-1.0, 1.0, 120)
            eng.init_vector = lambda n, v0=v0: v0
            engines.append((eng.run_one(), eng))
        ((vj, _), ej), ((vt, _), et) = engines
        # The restart count is not compared: the Ritz values settle at the
        # rounding level here, so it follows the last bits of each package.
        assert et.iteration_counts[0] > 20 and ej.iteration_counts[0] > 20
        assert abs(vt - vj) <= 1e-11 * abs(vj)


def test_config_carries_over_from_jax():
    pytest.importorskip("jax")
    from lanczos_tpu.solvers.lanczos import LanczosConfig

    jcfg = LanczosConfig(matrix_size=10, num_eigs=3, eps=1e-9, reorth_policy="selective", convergence_check_interval=3)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.resolved(torch.float32)) == dataclasses.asdict(jcfg.resolved(np.float32))


def test_default_init_and_auto_mode_on_cpu():
    a = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    eng = tl.LambdaLanczos(a, find_maximum=True, device="cpu")
    assert eng._resolve_mode() == "hybrid"
    val, vec = eng.run_one()
    assert abs(val - 4.0) < 4.0 * eng.eps
    assert abs(abs(float(vec.sum())) - np.sqrt(3.0)) < 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_on_cuda_runs_the_kernels(cuda, dtype):
    n = 1000
    pot = np.random.default_rng(0).uniform(0.0, 1.0, n)
    rows, cols, vals = _chain_coo(n, pot)
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=32, bk=32, dtype=dtype, device=cuda)
    eng = tl.LambdaLanczos(op, num_eigs=2)
    assert eng._resolve_mode() == "fused"
    eng.eps = 1e-6 if dtype == torch.float32 else 1e-12
    k1, k3 = spmv.bsr_matvec.launches, cgs.cgs_pass.launches
    vals_, vecs = eng.run()
    assert spmv.bsr_matvec.launches > k1 and cgs.cgs_pass.launches > k3
    a = np.zeros((n, n))
    a[rows, cols] += vals
    exact = np.linalg.eigvalsh(a)[:2]
    np.testing.assert_allclose(vals_, exact, rtol=1e-5 if dtype == torch.float32 else 1e-11)
    assert max(eng.residuals(vals_, vecs)) < (1e-3 if dtype == torch.float32 else 1e-8)
    # The same chain with a gauge phase on every hop (U H U^H, the same
    # spectrum) as a complex operator: K1 and K3 complex, K6 on real alpha
    # and beta, a complex start vector.
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    phase = np.exp(1j * np.random.default_rng(1).uniform(0.0, 2 * np.pi, n - 1))
    cvals = vals.astype(np.complex128)
    cvals[: n - 1] *= phase
    cvals[n - 1 : 2 * (n - 1)] *= phase.conj()
    cop = tl.BSROperator.from_coo(rows, cols, cvals, n, bm=32, bk=32, dtype=ctype, device=cuda)
    eng = tl.LambdaLanczos(cop, num_eigs=2)
    eng.eps = 1e-6 if dtype == torch.float32 else 1e-12
    k1, k3 = spmv.bsr_matvec.launches_by_dtype[ctype], cgs.cgs_pass.launches_by_dtype[ctype]
    cv, cvecs = eng.run()
    assert spmv.bsr_matvec.launches_by_dtype[ctype] > k1 and cgs.cgs_pass.launches_by_dtype[ctype] > k3
    assert cvecs.dtype == ctype
    np.testing.assert_allclose(cv, exact, rtol=1e-5 if dtype == torch.float32 else 1e-11)
    assert max(eng.residuals(cv, cvecs)) < (1e-3 if dtype == torch.float32 else 1e-8)
