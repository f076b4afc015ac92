"""The PyTorch port's Chebyshev-filtered path against the JAX package on the
CPU: the plain version of kernel K5 (the filter's recurrence chain), the
filter operator, the spectral bounds, ``ShiftSquaredOperator`` and
``filtered_lanczos`` (its ``checkpoint_path`` among them); and the
checkpoint module the filtered solve saves through, whose files both
packages read, with ``CheckpointedRun``.

Inputs are drawn from numpy seeds and handed to both packages; each JAX
reference runs once per module.  The Pallas chain runs in interpret mode,
as the JAX package's own tests run it on the CPU.  Tolerances: 1e-5
relative for float32 chains (the two sum the same terms in the same order;
the kernel and XLA may contract products into FMAs), 1e-12 for float64.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.ops import cheby  # noqa: E402
from lanczos_tpu_torch.ops.filters import ChebyshevFilterOperator  # noqa: E402
from lanczos_tpu_torch.utils import estimate  # noqa: E402
from lanczos_tpu_torch.utils.random import fixed_seed_initializer  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    return torch.device("cuda")


def _chain(n, dtype=np.float64, device="cpu"):
    return tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, dtype)] * 2, n, device=device)


def _chain_exact(n, k):
    return np.sort(-2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))[:k]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


# ---- (a) the chain: K5's plain version against the Pallas kernel ----------

CHAIN_N = 2200
CHAIN_OFFSETS = {"with_zero_row": (1, -1, 0), "without_zero_row": (1, -1)}
CHAIN_DEGREES = (1, 2, 8, 9, 37)


def _chain_inputs():
    # The JAX package's own case (tests/test_filtered.py, fused chain test).
    n = CHAIN_N
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n - 1).astype(np.float32) * 0.3
    up = np.r_[v, 0].astype(np.float32)
    dn = np.r_[0, v].astype(np.float32)
    d0 = rng.standard_normal(n).astype(np.float32) * 0.1
    x = rng.standard_normal(n).astype(np.float32)
    return {"with_zero_row": np.stack([up, dn, d0]), "without_zero_row": np.stack([up, dn])}, x


@pytest.fixture(scope="module")
def jax_chain():
    """Per offsets set: (c, e) of the degree-37 filter on [-2, 2], mu 1e-2;
    the interpret-mode Pallas chain at s = 8 in float32 per degree; the
    unfused float64 filter per degree."""
    jnp = pytest.importorskip("jax.numpy")
    from lanczos_tpu import DIAOperator
    from lanczos_tpu.ops.filters import ChebyshevFilterOperator as JaxFilter
    from lanczos_tpu.ops.pallas_cheby import cheby_chain_apply

    datas, x = _chain_inputs()
    out = {}
    for name, offs in CHAIN_OFFSETS.items():
        data = datas[name]
        op = DIAOperator.from_diagonals(offs, list(data), CHAIN_N)
        filt = JaxFilter.from_interval(op, 37, -2.0, 2.0, 1e-2)
        op64 = DIAOperator.from_diagonals(offs, list(data.astype(np.float64)), CHAIN_N)
        c, e = float(filt.c), float(filt.e)
        out[name] = {
            "c": c,
            "e": e,
            "f32": {d: np.asarray(cheby_chain_apply(op.data, op.offsets, jnp.asarray(x), filt.c, filt.e, d, s=8,
                                                    interpret=True)) for d in CHAIN_DEGREES},
            "f64": {d: np.asarray(JaxFilter(op64, jnp.asarray(c), jnp.asarray(e), d).matvec(jnp.asarray(x, np.float64)))
                    for d in CHAIN_DEGREES},
        }
    return out


@pytest.mark.parametrize("degree", CHAIN_DEGREES)
@pytest.mark.parametrize("offsets", list(CHAIN_OFFSETS))
def test_chain_plain_matches_pallas_and_unfused(jax_chain, offsets, degree):
    ref = jax_chain[offsets]
    datas, x = _chain_inputs()
    data = torch.from_numpy(datas[offsets])
    offs = CHAIN_OFFSETS[offsets]
    plain = cheby.cheby_chain_apply_reference(data, offs, torch.from_numpy(x), ref["c"], ref["e"], degree)
    assert plain.dtype == torch.float32
    assert _rel(plain, ref["f32"][degree]) < 1e-5
    # On CPU tensors the wrapper is the plain version, and launches nothing.
    launches = cheby.cheby_chain_apply.launches
    wrapped = cheby.cheby_chain_apply(data, offs, torch.from_numpy(x), ref["c"], ref["e"], degree)
    assert torch.equal(wrapped, plain) and cheby.cheby_chain_apply.launches == launches
    # The prescaled recurrence against the JAX package's unfused filter.
    plain64 = cheby.cheby_chain_apply_reference(data.double(), offs, torch.from_numpy(x).double(), ref["c"], ref["e"],
                                                degree)
    assert _rel(plain64, ref["f64"][degree]) < 1e-12


def test_chain_refuses_degree_zero_and_states_its_plan():
    data = torch.ones((2, 16))
    x = torch.ones(16)
    for fn in (cheby.cheby_chain_apply, cheby.cheby_chain_apply_reference):
        with pytest.raises(ValueError, match="degree must be >= 1"):
            fn(data, (-1, 1), x, 0.0, 1.0, 0)
    # The prescale appends the -2c/e row when there is no 0 offset, in the
    # rows' dtype.
    rows, offs = cheby.prescale(data, (-1, 1), 0.5, 2.0)
    assert offs == (-1, 1, 0) and rows.shape == (3, 16) and rows.dtype == torch.float32
    assert torch.all(rows[:2] == 1.0) and torch.all(rows[2] == -0.5)
    # The CUDA plan: H = s*w halo cells stay near 128; the flagship's chain
    # takes the register route, 256 threads of 16 cells; a wide band takes
    # the shared-memory route, whose window fits the block's shared memory.
    p = cheby.plan(1 << 22, (-1, 1, 0))
    assert p.route == "registers" and (p.steps, p.halo, p.core) == (256, 256, 3584)
    assert p.core % 32 == 0 and p.threads * p.cells == p.core + 2 * p.halo == 4096
    q = cheby.plan(1 << 22, (-8, -3, 0, 5, 8))
    assert q.route == "shared" and (q.steps, q.halo) == (16, 128) and q.core % 32 == 0
    assert (2 * (q.core + 2 * q.halo + 16) + 5 * (q.core + 2 * q.halo)) * 4 <= cheby.SMEM_BYTES
    assert cheby.steps_per_launch(8) == 16 and cheby.plan(100, (-8, -3, 0, 5, 8)).core == 100
    assert all(cheby.cheby_chain_fits(k + 1, w) for w in range(1, 9) for k in range(1, 2 * w + 1))
    assert not cheby.cheby_chain_fits(cheby.MAX_DIAGS + 1, 1)


# ---- (b) the filter operator ---------------------------------------------


def test_from_interval_validation_and_scalar_maps():
    op = tl.DenseOperator(np.eye(3), device="cpu")
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 8, 1.0, -1.0, 0.1)
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 8, -1.0, 1.0, 5.0)
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 1, -1.0, 1.0, 0.1)
    # The float64 chain (ROADMAP item 10): float32 DIA entries against the
    # JAX package's double-float matvec_df, joined in float64, at 1e-13 of
    # max |y|; the word-pair adapter gives the same pair.
    import jax.numpy as jnp

    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu.ops.filters import ChebyshevFilterOperator as JaxFilter

    rng = np.random.default_rng(5)
    m = 300
    data = rng.uniform(-0.4, 0.4, (3, m)).astype(np.float32)
    jf = JaxFilter.from_interval(JaxDIA.from_diagonals((-1, 0, 1), list(data), m), 17, -2.0, 2.0, 0.3)
    f64 = ChebyshevFilterOperator.from_interval(tl.DIAOperator.from_diagonals((-1, 0, 1), data, m, device="cpu"), 17,
                                                -2.0, 2.0, 0.3)
    assert (f64.c, f64.e) == (float(jf.c), float(jf.e))
    x = rng.standard_normal(m)
    x_hi = x.astype(np.float32)
    x_lo = (x - x_hi.astype(np.float64)).astype(np.float32)
    yh, yl = jf.matvec_df(jnp.asarray(x_hi), jnp.asarray(x_lo))
    y_df = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    y = f64.matvec_f64(torch.from_numpy(x_hi.astype(np.float64) + x_lo.astype(np.float64)))
    assert y.dtype == torch.float64 and _rel(y, y_df) <= 1e-13
    th, tl_ = f64.matvec_df(torch.from_numpy(x_hi), torch.from_numpy(x_lo))
    assert _rel(th.double() + tl_.double(), y_df) <= 1e-13

    f = ChebyshevFilterOperator.from_interval(op, 7, -1.0, 1.0, 1e-6)
    xs = np.linspace(-0.999, 0.999, 11)
    np.testing.assert_allclose(f.eval_scalar(xs), np.cos(7 * np.arccos((xs - f.c) / f.e)), rtol=1e-10, atol=1e-12)
    # odd degree maps the bottom band to -cosh, even degree to +cosh
    assert f.eval_scalar(np.array([-1.0 - 1e-3]))[0] < -1.0
    assert ChebyshevFilterOperator.from_interval(op, 8, -1.0, 1.0, 1e-6).eval_scalar(np.array([-1.0 - 1e-3]))[0] > 1.0

    # invert_value is the inverse of eval_scalar on the amplified side, for
    # both orientations; the damped bulk maps to NaN
    n = 512
    lams = -2 * np.cos(np.arange(1, 6) * np.pi / (n + 1))
    chain = _chain(n, np.float32)
    f = ChebyshevFilterOperator.from_interval(chain, 40, -2.0, 2.0, 1e-2)
    np.testing.assert_allclose(f.invert_value(f.eval_scalar(lams)), lams, atol=1e-14)
    top = ChebyshevFilterOperator.from_interval(chain, 40, -2.0, 2.0, 1e-2, find_maximum=True)
    tops = -2 * np.cos((n - np.arange(3)) * np.pi / (n + 1))
    np.testing.assert_allclose(top.invert_value(top.eval_scalar(tops)), tops, atol=1e-14)
    assert np.isnan(f.invert_value(0.5))


def test_eval_scalar_and_invert_value_match_jax():
    from lanczos_tpu import DIAOperator
    from lanczos_tpu.ops.filters import ChebyshevFilterOperator as JaxFilter

    rng = np.random.default_rng(123)
    diags = [np.full(64, -1.0, np.float32)] * 2
    jop = DIAOperator.from_diagonals([-1, 1], diags, 64)
    for _ in range(8):
        lo = float(rng.uniform(-5.0, 0.0))
        hi = float(lo + rng.uniform(0.5, 6.0))
        mu = float(rng.uniform(1e-4, 0.2) * (hi - lo))
        deg = int(rng.integers(2, 40)) * 2
        fmax = bool(rng.integers(0, 2))
        jf = JaxFilter.from_interval(jop, deg, lo, hi, mu, find_maximum=fmax)
        f = ChebyshevFilterOperator.from_interval(_chain(64, np.float32), deg, lo, hi, mu, find_maximum=fmax)
        assert (f.c, f.e) == (float(jf.c), float(jf.e))  # rounded to float32 alike
        lams = np.linspace(lo - 0.1, hi + 0.1, 9)
        np.testing.assert_array_equal(f.eval_scalar(lams), jf.eval_scalar(lams))
        bs = np.abs(f.eval_scalar(lams)) + 1.0
        np.testing.assert_array_equal(f.invert_value(bs), jf.invert_value(bs))


def _dense_spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_filter_matvec_matches_jax_float64(kind):
    import jax.numpy as jnp

    from lanczos_tpu import DenseOperator as JaxDense
    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu.ops.filters import ChebyshevFilterOperator as JaxFilter

    rng = np.random.default_rng(3)
    if kind == "dense":
        a = _dense_spd(40, 3)
        w = np.linalg.eigvalsh(a)
        jf = JaxFilter.from_interval(JaxDense(jnp.asarray(a)), 17, float(w[0]) - 0.1, float(w[-1]) + 0.1, 0.3)
        op = convert.dense_operator_from_array(a, device="cpu")
        f = ChebyshevFilterOperator(op, float(jf.c), float(jf.e), jf.degree, jf.side)
    else:
        n, offs = 300, (-2, -1, 0, 1, 2)
        data = rng.uniform(-0.4, 0.4, (5, n))
        jf = JaxFilter.from_interval(JaxDIA.from_diagonals(offs, list(data), n), 17, -2.0, 2.0, 0.3)
        f = convert.chebyshev_filter_from_arrays(offs, data, n, jf.c, jf.e, jf.degree, jf.side, jf.use_fused,
                                                 device="cpu")
    op = f.op
    x = rng.standard_normal(op.n)
    want = np.asarray(jf.matvec(jnp.asarray(x)))
    got = f.matvec(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got, want) < 1e-12


def test_fused_route_on_cpu_matches_default_route():
    n = 1000
    rng = np.random.default_rng(4)
    diags = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for _ in range(3)]
    op = tl.DIAOperator.from_diagonals([-3, 0, 3], diags, n, device="cpu")
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    f = ChebyshevFilterOperator.from_interval(op, 140, -2.0, 2.0, 1e-2)
    assert not f.use_fused  # off by default on the CPU, as in the JAX package
    default = f.matvec(x)
    f.use_fused = True
    launches = cheby.cheby_chain_apply.launches
    fused = f.matvec(x)
    assert f._prescaled is not None and f._prescaled[1] == (-3, 0, 3)  # kept for the operator's lifetime
    assert cheby.cheby_chain_apply.launches == launches  # plain version on CPU tensors
    assert _rel(fused, default) < 1e-5
    # Blocks, float64 and bandwidths past 8 take the default route.
    assert not f._fused_ok(torch.zeros((2, n)))
    assert not f._fused_ok(torch.zeros(n, dtype=torch.float64))
    wide = ChebyshevFilterOperator.from_interval(
        tl.DIAOperator.from_diagonals([-9, 9], diags[:2], n, device="cpu"), 8, -2.0, 2.0, 1e-2)
    wide.use_fused = True
    assert not wide._fused_ok(x)


# ---- (c) bounds and the squared operator ---------------------------------


def _bsr_pair(a):
    from lanczos_tpu import BSROperator as JaxBSR

    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    n = a.shape[0]
    return (JaxBSR.from_coo(rows, cols, vals, n, bm=8, bk=8, dtype=np.float64),
            tl.BSROperator.from_coo(rows, cols, vals, n, bm=8, bk=8, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("kind", ["dense", "dia", "bsr"])
def test_gershgorin_bound_matches_jax(kind):
    import jax.numpy as jnp

    from lanczos_tpu import DenseOperator as JaxDense
    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu.utils import estimate as jax_estimate

    a = _dense_spd(37, 5)
    a[np.abs(a) < 0.8] = 0.0  # sparse, so BSR packs padding tiles
    if kind == "dense":
        jop, op = JaxDense(jnp.asarray(a)), tl.DenseOperator(a, device="cpu")
    elif kind == "dia":
        a = np.diag(np.diag(a)) + np.diag(np.diag(a, 1), 1) + np.diag(np.diag(a, -1), -1)
        offs = (-1, 0, 1)
        data = np.stack([np.r_[0.0, np.diag(a, -1)], np.diag(a), np.r_[np.diag(a, 1), 0.0]])
        jop, op = JaxDIA.from_diagonals(offs, list(data), 37), tl.DIAOperator.from_diagonals(offs, data, 37, device="cpu")
    else:
        jop, op = _bsr_pair(a)
    got = estimate.gershgorin_bound(op)
    assert got == pytest.approx(jax_estimate.gershgorin_bound(jop), rel=1e-12)
    assert got >= np.max(np.abs(np.linalg.eigvalsh(a)))


def test_power_bound_and_shift_squared_match_jax():
    import jax.numpy as jnp

    from lanczos_tpu.ops.operators import DenseOperator as JaxDense
    from lanczos_tpu.ops.operators import FunctionOperator as JaxFunction
    from lanczos_tpu.ops.operators import ShiftSquaredOperator as JaxSq
    from lanczos_tpu.utils import estimate as jax_estimate

    a = _dense_spd(30, 6)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jfn = JaxFunction(lambda v: aj @ v, 30, np.float64)
    fn = tl.FunctionOperator(lambda v: at @ v, 30, torch.float64, device="cpu")
    for seed in (0, 3):
        assert estimate.power_bound(fn, seed=seed) == pytest.approx(jax_estimate.power_bound(jfn, seed=seed), rel=1e-10)
    with pytest.raises(TypeError):
        estimate.gershgorin_bound(fn)
    assert estimate.suggest_eigenvalue_offset(fn, False) == pytest.approx(-estimate.power_bound(fn))
    assert estimate.suggest_eigenvalue_offset(tl.DenseOperator(a, device="cpu"), True) == pytest.approx(
        jax_estimate.suggest_eigenvalue_offset(JaxDense(aj), True), rel=1e-12)

    sigma = 0.37
    x = np.random.default_rng(7).standard_normal(30)
    sq = tl.ShiftSquaredOperator(tl.DenseOperator(a, device="cpu"), sigma)
    want = np.asarray(JaxSq(JaxDense(aj), sigma).matvec(jnp.asarray(x)))
    assert _rel(sq.matvec(torch.from_numpy(x)), want) < 1e-13
    assert (sq.n, sq.dtype, sq.device.type) == (30, torch.float64, "cpu")
    # the composite bound holds the squared spectrum
    w = np.linalg.eigvalsh(a)
    assert estimate.gershgorin_bound(sq) >= np.max((w - sigma) ** 2)


# ---- (d) filtered_lanczos against the JAX package -------------------------

SOLVE_N = 2048
SOLVE = {"num_eigs": 3, "degree": 120, "mu": 1e-4, "lo": -2.0, "hi": 2.0}
SOLVE_SEED = 5


@pytest.fixture(scope="module")
def jax_solve():
    from lanczos_tpu import DIAOperator, filtered_lanczos
    from lanczos_tpu.utils.random import fixed_seed_initializer as jax_seeded

    def cfg(eng):
        eng.init_vector = jax_seeded(np.float64, seed=SOLVE_SEED)

    op = DIAOperator.from_diagonals([-1, 1], [np.full(SOLVE_N, -1.0)] * 2, SOLVE_N)
    vals, vecs, info = filtered_lanczos(op, configure=cfg, **SOLVE)
    return np.asarray(vals), np.asarray(vecs), info


def test_filtered_lanczos_matches_jax_float64(jax_solve):
    vj, vecj, info_j = jax_solve

    def cfg(eng):
        eng.init_vector = fixed_seed_initializer(torch.float64, seed=SOLVE_SEED)

    vals, vecs, info = tl.filtered_lanczos(_chain(SOLVE_N), configure=cfg, **SOLVE)
    exact = _chain_exact(SOLVE_N, 3)
    assert np.all(np.abs(vals - exact) < 2e-4)
    assert np.all(np.diff(vals) >= 0)
    # Same start vector, same engine (thick hybrid on the CPU), the same
    # float64 arithmetic up to summation order: the values agree far inside
    # the mu budget and the first round takes as many iterations.
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-9)
    assert info["iteration_counts"][0] == info_j["iteration_counts"][0]
    assert set(info) == set(info_j)
    assert (info["filter_degree"], info["mu"], info["interval"]) == (info_j["filter_degree"], info_j["mu"], info_j["interval"])
    assert info["matvecs"] == sum(info["iteration_counts"]) * info["filter_degree"]
    assert max(info["residuals"]) < 2e-2
    v = vecs.numpy()
    np.testing.assert_allclose(v @ v.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(v * vecj, axis=1)), 1.0, atol=1e-6)


# ---- (e) the other configurations -----------------------------------------


@pytest.mark.parametrize("case", ["find_maximum", "guard", "block", "sigma"])
def test_filtered_lanczos_configurations(case):
    n = 1024 if case != "sigma" else 1000
    op = _chain(n)
    allv = np.sort(-2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
    if case == "find_maximum":
        vals, _, _ = tl.filtered_lanczos(op, num_eigs=2, find_maximum=True, degree=120, mu=1e-4)
        assert abs(vals[0] - allv[-1]) < 2e-4 and vals[0] >= vals[1]  # best (largest) first
    elif case == "guard":
        vals, vecs, info = tl.filtered_lanczos(op, num_eigs=3, degree=120, mu=1e-4, lo=-2.0, hi=2.0, guard=2)
        assert len(vals) == 3 and vecs.shape == (3, n) and len(info["residuals"]) == 3
        assert np.all(np.abs(vals - allv[:3]) < 2e-4)
    elif case == "block":
        def cfg(eng):
            eng.block_size = 3

        vals, _, info = tl.filtered_lanczos(op, num_eigs=3, degree=120, mu=1e-4, lo=-2.0, hi=2.0, configure=cfg)
        assert np.all(np.abs(vals - allv[:3]) < 2e-4)
        assert info["matvecs"] == sum(info["iteration_counts"]) * 120 * 3
    else:
        sigma = 0.7321
        near = allv[np.argsort(np.abs(allv - sigma))[:4]]
        vals, vecs, info = tl.filtered_lanczos(op, num_eigs=4, lo=-2.0, hi=2.0, sigma=sigma)
        assert info["sigma"] == sigma and vecs.shape == (4, n)
        assert np.all(np.diff(np.abs(vals - sigma)) >= -1e-12)  # nearest sigma first
        assert np.max(np.abs(np.sort(vals) - np.sort(near))) < 2e-2
        assert info["matvecs"] == 2 * sum(info["iteration_counts"]) * info["filter_degree"]


# ---- (f) warnings and refusals --------------------------------------------


def _check_precise_solve(tmp_path):
    """``precise=True`` with ``refine_vectors`` (ROADMAP item 10) on the JAX
    tests' n = 1000 chain (tests/test_filtered.py::
    test_filtered_precise_reference_grade_values and
    ::test_precise_refined_vectors_meet_reference_bar): the values within
    1e-12 of the analytic ones and 2e-12 of the JAX package's, the refined
    host float64 vectors at its residual and elementwise bars; without
    refinement the vectors stay the engine's; and a checkpointed precise
    solve resumes to the same values."""
    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu import filtered_lanczos as jax_filtered

    n = 1000
    diags = [np.full(n, -1.0, np.float32)] * 2
    exact = _chain_exact(n, 3)
    vals_j, _vj, _ij = jax_filtered(JaxDIA.from_diagonals([-1, 1], diags, n), num_eigs=3, lo=-2.0, hi=2.0,
                                    precise=True)
    op = tl.DIAOperator.from_diagonals([-1, 1], diags, n, device="cpu")
    vals, vecs, info = tl.filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, precise=True)
    assert np.max(np.abs(vals - exact)) < 1e-12 and np.max(np.abs(vals - np.asarray(vals_j))) < 2e-12
    assert {"rr_values", "rr_values_refined", "inverse_map_values", "refine_sweeps"} <= set(info)
    assert isinstance(vecs, np.ndarray) and vecs.dtype == np.float64 and info["refine_sweeps"] >= 1
    a = np.zeros((n, n))
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = -1.0
    for k in range(3):
        assert np.linalg.norm(a @ vecs[k] - vals[k] * vecs[k]) < 1e-10
        exact_vec = np.sin((k + 1) * np.pi * np.arange(1, n + 1) / (n + 1))
        exact_vec /= np.linalg.norm(exact_vec)
        g = np.sign(np.dot(exact_vec, vecs[k]))
        assert np.abs(vecs[k] * g - exact_vec).max() < abs(exact[k]) * 1e-12 * 10  # the reference's bar
    _v0, vecs0, info0 = tl.filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, precise=True, refine_vectors=False)
    assert vecs0.dtype == torch.float32 and "refine_sweeps" not in info0 and "rr_values" in info0
    ckpt = tmp_path / "precise.npz"
    first, _v1, _i1 = tl.filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, mu=info0["mu"], precise=True,
                                          refine_vectors=False, checkpoint_path=ckpt)
    again, _v2, _i2 = tl.filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, mu=info0["mu"], precise=True,
                                          refine_vectors=False, checkpoint_path=ckpt)
    np.testing.assert_array_equal(again, first)
    assert np.max(np.abs(first - exact)) < 1e-12


def test_filtered_lanczos_warnings_and_refusals(tmp_path, monkeypatch):
    a = _dense_spd(300, 11)
    w = np.linalg.eigvalsh(a)
    op = tl.DenseOperator(a, device="cpu")
    # mu far below the w0-w1 spacing: the second target lies outside the
    # band and is flagged (the JAX package's contract: warn, do not fail),
    # with vals[0] still exact.  The start vectors are seeded (the B-space
    # engine's through configure, the edge estimate's fresh draw through the
    # generator it asks for), so the solve is the same on every run.
    seeded = lambda eng: setattr(eng, "init_vector", fixed_seed_initializer(eng.dtype, seed=0))  # noqa: E731
    with warnings.catch_warnings(record=True) as caught, monkeypatch.context() as m:
        warnings.simplefilter("always")
        m.setattr("lanczos_tpu_torch.utils.random._fresh_rng", lambda group=None: np.random.default_rng(0))
        vals, _, info = tl.filtered_lanczos(op, num_eigs=2, degree=80, mu=5e-4 * (w[-1] - w[0]), configure=seeded)
    assert any(issubclass(c.category, tl.BandCoverageWarning) and "OUTSIDE the amplified mu-band" in str(c.message)
               for c in caught)
    assert all(issubclass(c.category, tl.LanczosWarning) for c in caught)  # AccuracyWarning rides along
    # The JAX contract: an O(1) residual for the target outside the band.
    # An in-band pair's residual is ~1e-6 here, and the out-of-band one
    # came out 0.5-0.9 on unseeded starts (the old bar of 1.0 missed them)
    # and 2.2-10 over seeds 0-19 of this start, so 0.25 separates the two
    # kinds by five orders of magnitude on either side.
    assert abs(vals[0] - w[0]) < 1e-6 and info["residuals"][1] > 0.25
    lo, hi = info["interval"]
    assert w[0] - 1e-6 <= lo <= w[0] + 1.0 and hi >= w[-1]  # edge estimate, safe far bound

    chain = _chain(512, np.float32)
    with pytest.warns(tl.OverflowGuardWarning, match="beyond f32 range once squared"):
        vals, _, info = tl.filtered_lanczos(chain, num_eigs=1, degree=2000, mu=0.04, lo=-2.0, hi=2.0)
    assert info["filter_degree"] * np.arccosh(1 + 2 * 0.04 / (4 - 0.04)) <= 41
    assert abs(vals[0] - _chain_exact(512, 1)[0]) < 0.04

    _check_precise_solve(tmp_path)
    # checkpoint_path (ROADMAP item 12, ported): the round state is saved
    # after each deflation round, and a second call resumes from it with
    # the checks after the saved round, running no new round.
    ckpt = tmp_path / "filtered.npz"
    vals, vecs, info = tl.filtered_lanczos(chain, num_eigs=2, degree=64, mu=0.04, lo=-2.0, hi=2.0, checkpoint_path=ckpt)
    with np.load(ckpt) as z:
        assert int(z["format_version"]) == 1 and {"extra_round", "extra_prev_worst", "extra_stop_when_count"} <= set(z.files)
        assert list(z["iteration_counts"]) == info["iteration_counts"]
    again, vecs2, info2 = tl.filtered_lanczos(chain, num_eigs=2, degree=64, mu=0.04, lo=-2.0, hi=2.0,
                                              checkpoint_path=ckpt)
    np.testing.assert_array_equal(again, vals)
    assert info2["iteration_counts"] == info["iteration_counts"] and info2["residuals"] == info["residuals"]
    np.testing.assert_allclose(vals, _chain_exact(512, 2), atol=0.04)
    with pytest.raises(ValueError, match="configuration changed"):
        tl.filtered_lanczos(chain, num_eigs=3, degree=64, mu=0.04, lo=-2.0, hi=2.0, checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="exclusive"):
        tl.filtered_lanczos(chain, num_eigs=1, sigma=0.0, find_maximum=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a clean solve raises no warning
        tl.filtered_lanczos(chain, num_eigs=1, degree=64, mu=0.04, lo=-2.0, hi=2.0)


# ---- (g) checkpoints: the npz format both packages read, CheckpointedRun -----

def _checkpoint_problem():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((90, 90))
    return (a + a.T) / 2, np.random.default_rng(5).uniform(-1.0, 1.0, 90)


def test_checkpoint_files_load_in_both_packages(tmp_path):
    """The npz format is shared: a state written by
    ``lanczos_tpu.utils.checkpoint.save_state`` loads in the port and the
    reverse, with the same pairs, counts, flag and extras; and an engine
    of either package resumes from the other's file (``CheckpointedRun``
    returns a finished run's pairs without a new round)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu import LambdaLanczos as JaxLanczos
    from lanczos_tpu.solvers.lanczos import EigenPairManager as JaxManager
    from lanczos_tpu.utils import checkpoint as jck

    from lanczos_tpu_torch.solvers.lanczos import EigenPairManager
    from lanczos_tpu_torch.utils import checkpoint as tck

    vecs = np.random.default_rng(1).standard_normal((2, 6))
    jm, tm = JaxManager(True, 3), EigenPairManager(True, 3)
    jm.insert([1.5, -0.25], [jnp.asarray(v) for v in vecs])
    tm.insert([1.5, -0.25], [torch.from_numpy(v) for v in vecs])
    jck.save_state(tmp_path / "from_jax", jm, [7, 9], extra={"finished": True, "round": 2})
    tck.save_state(tmp_path / "from_torch", tm, [7, 9], extra={"finished": True, "round": 2})
    with np.load(tmp_path / "from_jax.npz") as zj, np.load(tmp_path / "from_torch.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            np.testing.assert_array_equal(zj[key], zt[key])
            assert zj[key].dtype == zt[key].dtype, key
    for src in ("from_jax", "from_torch"):
        m, counts, finished, extras = tck.load_state(tmp_path / src, torch.float64, device="cpu", with_finished=True,
                                                     with_extras=True)
        assert (m.find_maximum, m.num_eigs, counts, finished, int(extras["round"])) == (True, 3, [7, 9], True, 2)
        assert m.eigenvalues() == [1.5, -0.25]
        np.testing.assert_array_equal(torch.stack(m.eigenvectors()).numpy(), vecs)
        mj, counts_j = jck.load_state(tmp_path / src)
        assert mj.eigenvalues() == [1.5, -0.25] and counts_j == [7, 9]

    # A finished run saved by the JAX package: the port returns its pairs.
    a, v0 = _checkpoint_problem()
    ej = JaxLanczos(a, num_eigs=2)
    ej.eps, ej.tridiag_backend, ej.init_vector = 1e-12, "lapack", lambda n: v0
    vals_j, vecs_j = jck.CheckpointedRun(ej, tmp_path / "run_jax.npz").run()
    et = tl.LambdaLanczos(a, num_eigs=2, device="cpu")
    vals_t, vecs_t = tck.CheckpointedRun(et, tmp_path / "run_jax.npz").run()
    np.testing.assert_array_equal(vals_t, np.asarray(vals_j))
    np.testing.assert_array_equal(vecs_t.numpy(), np.asarray(vecs_j))
    assert et.iteration_counts == ej.iteration_counts


def test_checkpointed_run_resumes_after_one_round(tmp_path):
    """``CheckpointedRun`` stopped right after its first deflated restart
    (the file holds that round) and run again finishes with the
    uninterrupted run's eigenvalues and per-round counts."""
    from lanczos_tpu_torch.solvers import lanczos as tlz
    from lanczos_tpu_torch.utils import checkpoint as tck

    a, v0 = _checkpoint_problem()

    def engine():
        eng = tl.LambdaLanczos(a, num_eigs=3, device="cpu")
        eng.eps, eng.tridiag_backend, eng.init_vector = 1e-12, "lapack", lambda n: v0
        eng.num_eigs_per_iteration = 1  # one pair a round: several rounds
        return eng

    whole = engine()
    vals_whole, vecs_whole = whole.run()

    class Interrupt(Exception):
        pass

    driver = tlz.deflation_driver

    def one_round(*args, after_round, **kwargs):
        def save_then_stop(manager, counts, finished):
            after_round(manager, counts, finished)
            raise Interrupt

        return driver(*args, after_round=save_then_stop, **kwargs)

    path = tmp_path / "state.npz"
    tlz.deflation_driver = one_round
    try:
        with pytest.raises(Interrupt):
            tck.CheckpointedRun(engine(), path).run()
    finally:
        tlz.deflation_driver = driver
    manager, counts = tck.load_state(path, device="cpu")
    assert len(manager) == 1 and counts == whole.iteration_counts[:1]
    resumed = engine()
    vals, vecs = tck.CheckpointedRun(resumed, path).run()
    np.testing.assert_allclose(vals, vals_whole, rtol=1e-12)
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(a)[:3], rtol=1e-11)
    assert resumed.iteration_counts == whole.iteration_counts and len(whole.iteration_counts) > 1
    np.testing.assert_allclose(np.abs(np.sum(vecs.numpy() * vecs_whole.numpy(), axis=1)), 1.0, atol=1e-10)
    _check_checkpointed_pv_thick(tmp_path)


def _check_checkpointed_pv_thick(tmp_path):
    """``CheckpointedRun`` over the precise thick engine (the JAX package's
    tests/test_checkpoint.py::test_checkpointed_run_precise_vectors_thick):
    the n = 256 float32 chain at 1e-10, and a second run from the finished
    file returns the saved values without a restart."""
    from lanczos_tpu_torch.utils import checkpoint as tck

    n = 256

    def engine():
        op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device="cpu")
        eng = tl.LambdaLanczos(op, num_eigs=2, dtype=np.float32, mode="fused")
        eng.precise_vectors, eng.restart_policy, eng.max_iteration = True, "thick", 40
        eng.max_restarts, eng.eps, eng.eigenvalue_offset = 64, 1e-12, -4.0
        return eng

    path = tmp_path / "pv.npz"
    first = engine()
    vals1, _ = tck.CheckpointedRun(first, path).run()
    assert path.exists()
    vals2, _ = tck.CheckpointedRun(engine(), path).run()
    np.testing.assert_allclose(np.sort(np.asarray(vals1)), _chain_exact(n, 2), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.sort(np.asarray(vals2)), np.sort(np.asarray(vals1)), rtol=0, atol=1e-12)


# ---- on the card ------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [70001, 1 << 20])
@pytest.mark.parametrize(
    "offsets, route",
    [((-1, 1), "registers"), ((-1, 0, 1), "registers"), ((1, -1), "registers"), ((0,), "registers"),
     ((1, 1, 0), "shared"),
     ((-2, -1, 0, 1, 2), "shared"), ((2, -1), "shared"), ((-8, -3, 0, 5, 8), "shared"), ((-8, -3, 0, 3, 8), "shared"),
     ((-3, 0, 3), "shared")],
)
def test_k5_matches_plain_on_card(cuda, offsets, route, n):
    # Entries in [-1.8/k, 1.8/k] keep the spectrum inside the filter's
    # [-1.95, 2.15] window.  Degree 400 needs it real (complex eigenvalues
    # grow like rho**400 and overflow float32): symmetric rows, where the
    # offsets pair up (row -o is row +o shifted by o).
    rng = np.random.default_rng(n + len(offsets))
    rows = {o: rng.uniform(-1.8, 1.8, n).astype(np.float32) / len(offsets) for o in offsets}
    symmetric = sorted(offsets) == sorted(-o for o in offsets)
    if symmetric:
        rows.update({-o: np.r_[np.zeros(o, np.float32), rows[o][:-o]] for o in offsets if o > 0})
    data = torch.from_numpy(np.stack([rows[o] for o in offsets])).to(cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    plan = cheby.plan(n, offsets + (() if 0 in offsets else (0,)))
    s = plan.steps
    assert plan.route == route
    for degree in (1, 2, s - 1, s, s + 1, 37) + ((400,) if symmetric else ()):
        launches = cheby.cheby_chain_apply.launches
        on_route = cheby.cheby_chain_apply.launches_by_route[route]
        got = cheby.cheby_chain_apply(data, offsets, x, 0.1, 2.05, degree)
        want = cheby.cheby_chain_apply_reference(data, offsets, x, 0.1, 2.05, degree)
        torch.cuda.synchronize()
        assert cheby.cheby_chain_apply.launches - launches == -(-degree // s)
        assert cheby.cheby_chain_apply.launches_by_route[route] - on_route == -(-degree // s)
        # The bars of chip_smoke.py: K5_TOL, and K5_FLAGSHIP_TOL at degree 400.
        assert _rel(got.cpu(), want.cpu()) < (1e-4 if degree == 400 else 1e-5), degree
    with pytest.raises(NotImplementedError, match="K5"):
        cheby.cheby_chain_apply(data.double(), offsets, x.double(), 0.1, 2.05, 3)


@pytest.mark.gpu
def test_fused_chain_is_the_default_on_card(cuda):
    n = 4096
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=cuda)
    f = ChebyshevFilterOperator.from_interval(op, 64, -2.0, 2.0, 1e-2)
    assert f.use_fused
    x = torch.ones(n, device=cuda)
    launches = cheby.cheby_chain_apply.launches
    fused = f.matvec(x)
    assert cheby.cheby_chain_apply.launches == launches + 1
    f.use_fused = False
    assert _rel(fused.cpu(), f.matvec(x).cpu()) < 1e-5
