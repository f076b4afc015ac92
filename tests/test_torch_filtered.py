"""The PyTorch port's Chebyshev-filtered path against the JAX package on the
CPU: the plain version of kernel K5 (the filter's recurrence chain), the
filter operator, the spectral bounds, ``ShiftSquaredOperator`` and
``filtered_lanczos``.

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
    # The CUDA plan: H = s*w halo cells stay near 128, the window fits the
    # block's shared memory with 5 floats per cell for the flagship's chain.
    s, h, l = cheby.plan(1 << 22, 3, 1)
    assert (s, h) == (128, 128) and l % 32 == 0 and 2 * h / (l + 2 * h) < 0.03
    assert ((3 + 2) * (l + 2 * h) + 4) * 4 <= cheby.SMEM_BYTES
    assert cheby.steps_per_launch(8) == 16 and cheby.plan(100, 3, 1)[2] == 100
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
    with pytest.raises(NotImplementedError, match="item 10"):
        ChebyshevFilterOperator.from_interval(op, 8, -1.0, 1.0, 0.1).matvec_df(None, None)

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


def test_filtered_lanczos_warnings_and_refusals():
    a = _dense_spd(300, 11)
    w = np.linalg.eigvalsh(a)
    op = tl.DenseOperator(a, device="cpu")
    # mu far below the w0-w1 spacing: the second target lies outside the
    # band and is flagged (the JAX package's contract: warn, do not fail),
    # with vals[0] still exact.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vals, _, info = tl.filtered_lanczos(op, num_eigs=2, degree=80, mu=5e-4 * (w[-1] - w[0]))
    assert any(issubclass(c.category, tl.BandCoverageWarning) and "OUTSIDE the amplified mu-band" in str(c.message)
               for c in caught)
    assert all(issubclass(c.category, tl.LanczosWarning) for c in caught)  # AccuracyWarning rides along
    assert abs(vals[0] - w[0]) < 1e-6 and info["residuals"][1] > 1.0
    lo, hi = info["interval"]
    assert w[0] - 1e-6 <= lo <= w[0] + 1.0 and hi >= w[-1]  # edge estimate, safe far bound

    chain = _chain(512, np.float32)
    with pytest.warns(tl.OverflowGuardWarning, match="beyond f32 range once squared"):
        vals, _, info = tl.filtered_lanczos(chain, num_eigs=1, degree=2000, mu=0.04, lo=-2.0, hi=2.0)
    assert info["filter_degree"] * np.arccosh(1 + 2 * 0.04 / (4 - 0.04)) <= 41
    assert abs(vals[0] - _chain_exact(512, 1)[0]) < 0.04

    for kwargs, item in (({"precise": True}, "item 10"), ({"refine_vectors": True}, "item 10"),
                         ({"checkpoint_path": "ckpt"}, "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            tl.filtered_lanczos(chain, num_eigs=1, lo=-2.0, hi=2.0, **kwargs)
    with pytest.raises(ValueError, match="exclusive"):
        tl.filtered_lanczos(chain, num_eigs=1, sigma=0.0, find_maximum=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a clean solve raises no warning
        tl.filtered_lanczos(chain, num_eigs=1, degree=64, mu=0.04, lo=-2.0, hi=2.0)


# ---- on the card ------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [(-1, 1), (-1, 0, 1), (-8, -3, 0, 5, 8)])
def test_k5_matches_plain_on_card(cuda, offsets):
    n = 70001
    gen = torch.Generator(device=cuda).manual_seed(0)
    data = (torch.rand((len(offsets), n), generator=gen, device=cuda) * 2 - 1) * (1.8 / len(offsets))
    x = torch.randn(n, generator=gen, device=cuda)
    s = cheby.steps_per_launch(max(abs(o) for o in offsets))
    for degree in (1, 2, s - 1, s, s + 1, 37):
        launches = cheby.cheby_chain_apply.launches
        got = cheby.cheby_chain_apply(data, offsets, x, 0.1, 2.05, degree)
        want = cheby.cheby_chain_apply_reference(data, offsets, x, 0.1, 2.05, degree)
        torch.cuda.synchronize()
        assert cheby.cheby_chain_apply.launches - launches == -(-degree // s)
        assert _rel(got.cpu(), want.cpu()) < 1e-5, degree
    with pytest.raises(NotImplementedError, match="K5"):
        cheby.cheby_chain_apply(data.double(), offsets, x.double(), 0.1, 2.05, 3)
