"""The PyTorch port's ``Exponentiator`` against the JAX package's and against
exact exponentials.

Both packages get the same operator (Dense, DIA, BSR, built from the same
numpy arrays) and the same input, made with numpy from a seed; in float64
their outputs agree to 1e-12 relative and their iteration and term counts
are equal on every ported method, but for R7 below.  The reference's exponentiator zoo
(test/exponentiator_test.cpp) is held to the reference's own bar, an
overlap error below machine_eps * 1e2 ~ 2.2e-14 (exponentiator.hpp:58),
against ``scipy.linalg.expm``, not to the JAX package's loose complex bars
(R3 in ROADMAP.md).  Where the reference's stop test never fires (R7: a
with a real part), the JAX build runs to max_iteration and the port stops
early; those cases are held to the reference's overlap bar.  The cases of
``tests/test_exponentiator.py`` that apply to the ported methods follow,
and the refusals of what is not ported.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import scipy.linalg as sla  # noqa: E402

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.parallel.sharded import ShardedOperator  # noqa: E402
from lanczos_tpu_torch.solvers import cheby_expm  # noqa: E402

EPS_REF = np.finfo(np.float64).eps * 1e2  # the reference's overlap bar, exponentiator.hpp:58
PARITY = 1e-12  # port against the JAX package, relative to max |output|, float64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _complex(re, im):
    return _np(re).astype(np.float64) + 1j * _np(im).astype(np.float64)


def _overlap_err(truth, out):
    t = np.asarray(truth, np.complex128).ravel()
    o = np.asarray(out, np.complex128).ravel()
    return abs(1.0 - abs(np.vdot(t, o)) / (np.linalg.norm(t) * np.linalg.norm(o)))


def _ring(n=100, t=-1.0):
    h = np.zeros((n, n))
    i = np.arange(n - 1)
    h[i, i + 1] = h[i + 1, i] = t
    h[0, n - 1] = h[n - 1, 0] = t
    return h


def _ring_input(n=100):
    # exponentiator_test.cpp:120-130
    v = np.zeros(n, np.complex128)
    v[0] = v[n - 1] = 1 + 2j
    v[n // 2] = 8 + 2j
    return v / np.linalg.norm(v)


def _chain_coo(n, potential):
    i, d = np.arange(n - 1), np.arange(n)
    rows = np.concatenate([i, i + 1, d])
    cols = np.concatenate([i + 1, i, d])
    return rows, cols, np.concatenate([-np.ones(2 * (n - 1)), potential])


N_OP = 48


def _operators(kind):
    """(JAX operator, port operator, dense float64 matrix) of one problem:
    a random symmetric matrix (dense), or the n = 48 chain with a random
    on-site potential (DIA with three diagonals, BSR with 8 x 8 tiles)."""
    import jax.numpy as jnp
    import lanczos_tpu as lt

    rng = np.random.default_rng({"dense": 11, "dia": 12, "bsr": 13}[kind])
    if kind == "dense":
        a = rng.standard_normal((N_OP, N_OP)) * 0.1
        a = (a + a.T) / 2
        return lt.DenseOperator(jnp.asarray(a)), convert.dense_operator_from_array(a, device="cpu"), a
    pot = rng.uniform(-0.5, 0.5, N_OP)
    rows, cols, vals = _chain_coo(N_OP, pot)
    dense = np.zeros((N_OP, N_OP))
    np.add.at(dense, (rows, cols), vals)
    if kind == "dia":
        diags = [np.full(N_OP, -1.0), pot, np.full(N_OP, -1.0)]
        jop = lt.DIAOperator.from_diagonals([-1, 0, 1], diags, N_OP)
        return jop, convert.dia_operator_from_arrays(jop.offsets, np.asarray(jop.data), N_OP, device="cpu"), dense
    jop = lt.BSROperator.from_coo(rows, cols, vals, N_OP, bm=8, bk=8, dtype=np.float64)
    top = convert.bsr_operator_from_arrays(np.asarray(jop.blocks), np.asarray(jop.col_blocks), N_OP, jop.layout,
                                           device="cpu")
    return jop, top, dense


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return v / np.linalg.norm(v)


GRID = [0.3j, -0.2, 1.1j - 0.1]


def _drive(ex, method, v):
    """One ported method of ``ex`` (either package) on the complex state
    ``v``: (outputs as complex numpy arrays, counts)."""
    if method == "run":
        out, it = ex.run(0.8j, v.real)
        return [_np(out)], [it]
    if method == "run_real_a":
        out, it = ex.run(-0.5, v.real)
        return [_np(out)], [it]
    if method == "run_grid":
        outs, it = ex.run_grid(GRID, v.real)
        return [_np(outs)], [it]
    if method == "run_split":
        (re, im), its = ex.run_split(-1.3j, v.real, v.imag)
        return [_complex(re, im)], list(its)
    if method == "taylor_run":
        out, terms = ex.taylor_run(0.6j - 0.2, v.real)
        return [_np(out)], [terms]
    if method in ("evolve", "evolve_renormalize"):
        re, im = ex.evolve(-0.4j, v.real, v.imag, 5, krylov_dim=12, renormalize=method == "evolve_renormalize")
        return [_complex(re, im)], []
    if method == "run_chebyshev":
        (re, im), terms = ex.run_chebyshev(2.5j - 0.1, v.real, v.imag)
        return [_complex(re, im)], [terms]
    if method == "run_chebyshev_grid":
        (re, im), terms = ex.run_chebyshev_grid([0.5j, 2j, -0.7], v.real, v.imag, lo=-3.0, hi=3.0)
        return [_complex(re, im)], [terms]
    raise ValueError(method)


METHODS = ["run", "run_real_a", "run_grid", "run_split", "taylor_run", "evolve", "evolve_renormalize",
           "run_chebyshev", "run_chebyshev_grid"]


# Methods whose scalar (the grid's largest) has a real part: there the
# reference's stop test never fires (R7), the JAX build runs to
# max_iteration = n, and the port stops when the coefficients settle.
R7_METHODS = {"run_real_a", "run_grid"}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["dense", "dia", "bsr"])
def test_port_matches_jax_exponentiator(kind, method):
    import lanczos_tpu as lt

    jop, top, dense = _operators(kind)
    v = _state(N_OP, seed=len(method))
    want, want_counts = _drive(lt.Exponentiator(jop), method, v)
    got, got_counts = _drive(tl.Exponentiator(top), method, v)
    if method in R7_METHODS:
        # The JAX output is the exact exponential of the full Krylov space;
        # the port's, at the reference's eps, is held to the reference's
        # overlap bar against it (a relative change of the coefficients
        # below sqrt(2 eps) ~ 2e-7 at the stop leaves ~1e-8 in the vector).
        assert want_counts == [N_OP] and 1 <= got_counts[0] < N_OP
        for g, w in zip(got, want):
            for row_g, row_w in zip(g.reshape(-1, N_OP), w.reshape(-1, N_OP)):
                assert _overlap_err(row_w, row_g) < EPS_REF
                assert np.linalg.norm(row_g - row_w) <= 1e-6 * np.linalg.norm(row_w)
        return
    assert got_counts == want_counts
    tol = PARITY
    if method.startswith("evolve"):
        # The JAX package takes each step's small exponential by 12
        # squarings of an 8-term Taylor series in split real arithmetic,
        # which leaves ~1e-12 of its own error after 5 steps.  The port is
        # held to the exact propagator at PARITY, and to the JAX output
        # within twice the JAX output's own distance from it.
        truth = np.linalg.matrix_power(sla.expm(-0.4j * dense), 5) @ v
        assert np.abs(got[0] - truth).max() <= PARITY * np.abs(truth).max()
        tol = max(PARITY, 2 * np.abs(want[0] - truth).max() / np.abs(truth).max())
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.iscomplexobj(g) == np.iscomplexobj(w)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


ZOO = ["dense3_run", "dense3_taylor", "ring_run_complex", "ring_taylor_complex", "ring_split", "ring_zero_run",
       "ring_zero_split", "ring_zero_taylor"]


@pytest.mark.parametrize("case", ZOO)
def test_reference_zoo_at_the_reference_bar(case):
    """exponentiator_test.cpp: the 3 x 3 matrix at a = 3 (:31-81), the
    n = 100 ring at a = 3i with complex input (:106-162) and at a = 0 with
    full reorthogonalization (:164-222), each through the Krylov run, its
    split form on the real ring and the Taylor run."""
    if case.startswith("dense3"):
        m = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
        ex = tl.Exponentiator(m, device="cpu")
        vin = np.array([1.0, 0.0, 0.0])
        out, count = (ex.run if case == "dense3_run" else ex.taylor_run)(3.0, vin)
        truth = sla.expm(3.0 * m) @ vin
    else:
        h, vin = _ring(), _ring_input()
        a = 0.0 if "zero" in case else 3.0j
        truth = sla.expm(a * h) @ vin
        if case.endswith("split"):
            ex = tl.Exponentiator(h, device="cpu")
            ex.full_orthogonalize = "zero" in case
            (re, im), count = ex.run_split(a, vin.real, vin.imag)
            out = _complex(re, im)
        else:
            ex = tl.Exponentiator(h.astype(np.complex128), device="cpu")
            ex.full_orthogonalize = "zero" in case
            out, count = (ex.taylor_run if "taylor" in case else ex.run)(a, vin)
    assert _overlap_err(truth, _np(out)) < EPS_REF
    assert np.all(np.asarray(count) >= 1)


@pytest.mark.parametrize("kind", ["dense", "dia", "bsr"])
def test_run_split_counts_are_the_single_part_runs(kind):
    """The JAX batched driver's per-state counts match single-state runs
    (lanczos_tpu/api.py:573-574); the port's run_split is two single-part
    builds, and its counts equal the JAX run_split's."""
    import lanczos_tpu as lt

    jop, top, _ = _operators(kind)
    v = _state(N_OP, seed=5)
    ex = tl.Exponentiator(top)
    (_re, _im), counts = ex.run_split(-2.0j, v.real, v.imag)
    assert counts == (ex.run(-2.0j, v.real)[1], ex.run(-2.0j, v.imag)[1])
    assert counts == tuple(lt.Exponentiator(jop).run_split(-2.0j, v.real, v.imag)[1])


@pytest.mark.parametrize("a", [-1.0, 1.1j - 0.1])
def test_r7_stop_test_fires_for_a_with_a_real_part(a):
    """R7, a fault of the reference: its stop test, |1 - |<c_prev, c>|| <
    eps (exponentiator.hpp:147-158), needs unit coefficient vectors, which
    exp(aT) e1 is only for imaginary a.  For a with a real part the JAX
    build runs to max_iteration = n (160 here; 2**20 matvecs and host
    eigensolves at the main path's size).  The port stops when the
    relative change of the coefficients settles, reaches the reference's
    overlap bar against expm there, and a smaller eps buys more digits."""
    import lanczos_tpu as lt

    n = 160
    rng = np.random.default_rng(0)
    pot = rng.uniform(-0.5, 0.5, n)
    diags = [np.full(n, -1.0), pot, np.full(n, -1.0)]
    a_mat = np.diag(pot) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    truth = sla.expm(a * a_mat) @ v
    assert lt.Exponentiator(lt.DIAOperator.from_diagonals([-1, 0, 1], diags, n)).run(a, v)[1] == n
    ex = tl.Exponentiator(tl.DIAOperator.from_diagonals([-1, 0, 1], diags, n, device="cpu"))
    out, itern = ex.run(a, v)
    assert itern < 30
    assert _overlap_err(truth, _np(out)) < EPS_REF
    assert np.linalg.norm(_np(out) - truth) <= 1e-7 * np.linalg.norm(truth)
    ex.eps = 1e-26  # a relative change below ~1.4e-13 at the stop
    out, itern_tight = ex.run(a, v)
    assert itern < itern_tight < 40
    assert np.linalg.norm(_np(out) - truth) <= 1e-12 * np.linalg.norm(truth)


class _Slab(ShardedOperator):
    """This rank's slab of a row-partitioned operator, without a process
    group: enough for the refusal."""

    n = n_padded = 8
    dtype = torch.float64
    mesh = type("Mesh", (), {"size": 1, "device": torch.device("cpu"), "group": None})()

    def matvec(self, x):
        return x


@pytest.mark.parametrize("call, error, item", [
    ("mode_fused", NotImplementedError, "item 8 (device-loop part)"),
    ("run_batch", NotImplementedError, "item 8 (device-loop part)"),
    ("evolve_precise", NotImplementedError, "item 10"),
    ("chebyshev_precise", NotImplementedError, "item 10"),
    ("chebyshev_hermitian", NotImplementedError, "item 11"),
    ("sharded", NotImplementedError, "item 13"),
    ("complex_input", TypeError, "run_split"),
])
def test_refusals_name_their_item(call, error, item):
    ex = tl.Exponentiator(np.eye(4), device="cpu")
    v = np.ones(4)
    with pytest.raises(error, match=item.replace("(", r"\(").replace(")", r"\)")):
        if call == "mode_fused":
            tl.Exponentiator(np.eye(4), mode="fused", device="cpu").run(1.0, v)
        elif call == "run_batch":
            ex.run_batch(1.0, np.ones((2, 4)))
        elif call == "evolve_precise":
            ex.evolve(1j, v, v * 0, 2, precise=True)
        elif call == "chebyshev_precise":
            ex.run_chebyshev(1j, v, v * 0, precise=True)
        elif call == "chebyshev_hermitian":
            cheby_expm.chebyshev_expm_apply_hermitian(None, 1j, v, v)
        elif call == "sharded":
            tl.Exponentiator(_Slab())
        else:
            ex.run(1.0, v + 1j)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tl.Exponentiator(np.eye(3)).operator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tl.Exponentiator(np.eye(3))


# The cases of tests/test_exponentiator.py that apply to the ported methods.

def test_f32_run_at_the_float_tolerance():
    # test_exponentiate_f32: exponentiator.hpp:51-56, eps ~ 1e-5 for float
    m = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]], np.float32)
    ex = tl.Exponentiator(m, device="cpu")
    vin = np.array([1.0, 0.0, 0.0], np.float32)
    out, _ = ex.run(1.5, vin)
    assert out.dtype == torch.float32
    assert _overlap_err(sla.expm(1.5 * m.astype(np.float64)) @ vin, _np(out)) < ex.eps


def test_f32_split_meets_the_reference_overlap_bar():
    """test_f32_meets_reference_overlap_tolerance: the float32 build at
    eps = 1e-14 reaches the float64 overlap bar on the ring (the overlap is
    quadratic in the angle), in the float64 build's iterations +-1."""
    h, vin = _ring(), _ring_input()
    truth = sla.expm(3.0j * h) @ vin
    counts = {}
    for dtype in (np.float32, np.float64):
        ex = tl.Exponentiator(h.astype(dtype), device="cpu")
        ex.eps = 1e-14
        (re, im), counts[dtype] = ex.run_split(3.0j, vin.real.astype(dtype), vin.imag.astype(dtype))
        assert _overlap_err(truth, _complex(re, im)) < EPS_REF
    assert all(abs(a - b) <= 1 for a, b in zip(counts[np.float32], counts[np.float64]))


def test_f32_breakdown_terminates():
    """test_fused_f32_breakdown_terminates, in the hybrid build: beta falls
    below the float32 machine eps after ~2 steps and the build stops."""
    n = 8
    ex = tl.Exponentiator(np.diag(np.arange(1, n + 1, dtype=np.float32)), device="cpu")
    v = np.zeros(n, np.float32)
    v[0], v[1] = 1.0, 1e-8
    out, itern = ex.run(0.5, v)
    assert abs(float(out[0]) - np.exp(0.5)) < 1e-4
    assert itern <= n


@pytest.mark.parametrize("case", ["complex_operator", "real_input"])
def test_split_matches_complex_and_expm(case):
    """test_split_complex_evolution_matches_complex and
    test_split_complex_real_input: the split run against the complex
    operator's run, and a real localized input against expm."""
    n = 80 if case == "complex_operator" else 40
    i = np.arange(n - 1)
    h = np.zeros((n, n))
    h[i, i + 1] = h[i + 1, i] = -1.0
    ex = tl.Exponentiator(h, device="cpu")
    if case == "complex_operator":
        psi = _state(n, seed=8)
        truth, _ = tl.Exponentiator(h.astype(np.complex128), device="cpu").run(-0.8j, psi)
        truth, atol = _np(truth), 1e-10
        (re, im), _ = ex.run_split(-0.8j, psi.real, psi.imag)
    else:
        psi = np.zeros(n)
        psi[n // 2] = 1.0
        ex.full_orthogonalize = True  # localized start: a near-full Krylov space
        (re, im), _ = ex.run_split(-1.0j, psi, np.zeros(n))
        truth, atol = sla.expm(-1.0j * h) @ psi, 1e-8
    got = _complex(re, im)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-9
    np.testing.assert_allclose(got, truth, atol=atol)


@pytest.mark.parametrize("renormalize", [False, True])
def test_evolve_matches_the_exact_propagator(renormalize):
    # test_evolve_device_resident
    n = 64
    i = np.arange(n - 1)
    h = np.zeros((n, n))
    h[i, i + 1] = h[i + 1, i] = -1.0
    psi = _state(n, seed=9)
    re, im = tl.Exponentiator(h, device="cpu").evolve(-0.3j, psi.real, psi.imag, steps=5, krylov_dim=16,
                                                      renormalize=renormalize)
    got = _complex(re, im)
    truth = np.linalg.matrix_power(sla.expm(-0.3j * h), 5) @ psi
    assert abs(np.linalg.norm(got) - 1.0) < 1e-12
    assert np.abs(got - truth).max() < 1e-13


def test_chebyshev_propagator_matches_expm():
    """test_chebyshev_propagator_matches_expm: unitary, decay, mixed and a
    long unitary step, the shared-chain grid and the Gershgorin window."""
    n = 100
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, device="cpu")
    a_mat = np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 1, -1.0), 1)
    ex = tl.Exponentiator(op)
    v = _state(n, seed=1)
    for a in (3j, -0.5, 1.5j - 0.2, 25j):
        (re, im), terms = ex.run_chebyshev(a, v.real, v.imag, lo=-2.0, hi=2.0)
        assert np.linalg.norm(_complex(re, im) - sla.expm(a * a_mat) @ v) < 1e-12, a
        assert terms < 120
    ts = [0.5j, 2.0j, 5.0j]
    (g_re, g_im), _ = ex.run_chebyshev_grid(ts, v.real, v.imag, lo=-2.0, hi=2.0)
    for j, t in enumerate(ts):
        assert np.linalg.norm(_complex(g_re[j], g_im[j]) - sla.expm(t * a_mat) @ v) < 1e-12
    (re, im), _ = ex.run_chebyshev(2j, v.real, v.imag)
    assert np.linalg.norm(_complex(re, im) - sla.expm(2j * a_mat) @ v) < 1e-12


def test_chebyshev_heat_kernel_ive_fallback():
    """test_chebyshev_heat_kernel_ive_fallback: past |Re z| ~ 710 the
    coefficients come from ive unscaled by exp(|Re z|); end to end, exp(-tA)
    v of a PSD chain at t = 380 on a float32 operator; a prefactor that
    overflows raises."""
    from scipy.special import iv, ive

    ks = np.arange(40)
    for z0 in (-600 + 0.5j, 600 + 2j):
        direct = iv(ks, z0)
        fall = ive(ks, z0) * np.exp(abs(z0.real))
        assert np.max(np.abs(direct - fall) / np.maximum(np.abs(direct), 1e-280)) < 1e-12
    n, t = 100, 380.0
    a_mat = 2.0 * np.eye(n)
    idx = np.arange(n - 1)
    a_mat[idx, idx + 1] = a_mat[idx + 1, idx] = -1.0
    ex = tl.Exponentiator(a_mat.astype(np.float32), device="cpu")
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    (re, _im), _ = ex.run_chebyshev(-t, v, np.zeros(n), lo=0.0, hi=4.0)
    w, u = np.linalg.eigh(a_mat)
    truth = u @ (np.exp(-t * w) * (u.T @ v))
    assert np.linalg.norm(_np(re) - truth) / np.linalg.norm(truth) < 1e-4
    with pytest.raises(OverflowError):
        cheby_expm.chebyshev_expm_coeffs(400.0 + 1j, 0.0, 2.0)


def test_taylor_overflow_raises():
    """A float32 Taylor run whose peak term overflows raises instead of
    running on (the reference's unbounded loop would spin)."""
    n = 16
    a_mat = np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    ex = tl.Exponentiator(a_mat.astype(np.float32), device="cpu")
    with pytest.raises(OverflowError, match="overflowed"):
        ex.taylor_run(-60.0, np.ones(n, np.float32))
