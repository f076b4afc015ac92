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
then the device-resident build (``mode='fused'``, ``run_batch``) against
the port's hybrid build, the JAX package's fused build and scipy, and the
refusals of what is not ported.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import scipy.linalg as sla  # noqa: E402

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.parallel.sharded import ShardedOperator  # noqa: E402
from lanczos_tpu_torch.solvers import cheby_expm, exponentiator_fused  # noqa: E402
from lanczos_tpu_torch.solvers import exponentiator as _expm  # noqa: E402

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


def _sharded_paths_run():
    """ROADMAP item 13: every method of an Exponentiator over a
    row-partitioned operator (a one-rank gloo world in this process; the
    2- and 4-rank worlds are tests/test_torch_sharded.py's) returns the
    one-device Exponentiator's results within 1e-12, for a real and a
    complex Hermitian chain, in both modes, precise or not."""
    import tempfile

    import torch.distributed as dist

    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedDIAOperator

    n = 64
    rng = np.random.default_rng(17)
    hops = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w = _state(n, 18)
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.initialize_distributed(backend="gloo", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            mesh = pmesh.make_mesh()
            for diags in ([np.full(n, -1.0)] * 2, [hops, np.roll(np.conj(hops), 1)]):
                sharded = tl.Exponentiator(ShardedDIAOperator.from_diagonals([1, -1], diags, n, mesh))
                assert isinstance(sharded.operator, ShardedOperator)
                one = tl.Exponentiator(tl.DIAOperator.from_diagonals([1, -1], diags, n, device="cpu"))
                v = w if sharded.dtype.is_complex else w.real
                for ex in (sharded, one):
                    ex.got = []
                    for mode in ("hybrid", "fused"):
                        ex.mode = mode
                        ex.got.append(ex.run(-0.5j, v)[0])
                    ex.got += [ex.run_grid([0.2, -0.3j], v)[0], ex.run_batch(-0.3j, np.stack([v, 0 * v]))[0],
                               ex.taylor_run(0.2j, v)[0], ex.run_split(-0.4j, w.real, w.imag)[0][1],
                               ex.evolve(0.05j, w.real, w.imag, 5)[0],
                               torch.as_tensor(ex.evolve(0.05j, w.real, w.imag, 5, precise=True)[1]),
                               ex.run_chebyshev(2j, w.real, w.imag)[0][0],
                               torch.as_tensor(ex.run_chebyshev(2j, w.real, w.imag, precise=True)[0][1]),
                               ex.run_chebyshev_grid([1j, 2j], w.real, w.imag)[0][0]]
                for got, want in zip(sharded.got, one.got):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("call, error, item", [
    ("evolve_hermitian_precise", NotImplementedError, "item 11"),
    ("chebyshev_hermitian_precise", NotImplementedError, "item 11"),
    ("chebyshev_hermitian", NotImplementedError, "item 11"),
    ("sharded", NotImplementedError, "item 13"),
    ("complex_input", TypeError, "run_split"),
    ("complex_batch", TypeError, "run_split"),
    ("batch_shape", ValueError, "(B, 4)"),
])
def test_refusals_name_their_item(call, error, item):
    if item == "item 11":
        # ROADMAP item 11 landed: these three ids, refusals until then, run
        # the complex Hermitian paths they named.
        _hermitian_path_runs(call)
        return
    if item == "item 13":
        _sharded_paths_run()
        return
    ex = tl.Exponentiator(np.eye(4), device="cpu")
    v = np.ones(4)
    with pytest.raises(error, match=item.replace("(", r"\(").replace(")", r"\)")):
        if call == "complex_input":
            ex.run(1.0, v + 1j)
        elif call == "complex_batch":
            ex.run_batch(1.0, np.ones((2, 4)) + 1j)
        else:
            ex.run_batch(1.0, np.ones(4))


def _hermitian_path_runs(call):
    """The precise evolution and the (precise) Chebyshev chain of a complex
    Hermitian operator given as its split parts, against scipy's expm at
    the reference's overlap bar; float64 host arrays from the precise
    paths."""
    from lanczos_tpu_torch.ops.hermitian_split import HermitianSplitOperator

    rng = np.random.default_rng(41)
    c = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    h = 0.2 * (c + c.conj().T)
    op = HermitianSplitOperator(tl.DenseOperator(h.real.copy(), device="cpu"),
                                tl.DenseOperator(h.imag.copy(), device="cpu"))
    psi = _state(12, 42)
    if call == "evolve_hermitian_precise":
        re, im = _expm.evolve_hermitian_split_precise(op, psi.real, psi.imag, 0.1j, 10)
        truth = sla.expm(1j * h) @ psi
    else:
        (re, im), terms = cheby_expm.chebyshev_expm_apply_hermitian(op, 2j, psi.real, psi.imag,
                                                                    precise=call.endswith("precise"))
        truth = sla.expm(2j * h) @ psi
        assert terms > 2
    if call.endswith("precise"):
        assert isinstance(re, np.ndarray) and re.dtype == np.float64
    assert _overlap_err(truth, _complex(re, im)) < EPS_REF
    assert np.linalg.norm(_complex(re, im) - truth) <= 1e-12 * np.linalg.norm(truth)


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
    _check_precise_evolve(renormalize)


def _angle(truth, out):
    tn = truth / np.linalg.norm(truth)
    on = out / np.linalg.norm(out)
    ip = np.vdot(tn, on)
    return np.linalg.norm(on - (ip / abs(ip)) * tn)


def _check_precise_evolve(renormalize):
    """``evolve(precise=True)`` (ROADMAP item 10) on the JAX tests' problems
    (tests/test_exponentiator.py::test_evolve_precise_df64, and with
    ``renormalize`` ::test_evolve_precise_renormalize_real_a): float32
    storage, host float64 out, at the JAX bars against the exact
    propagator and within 2e-12 of the JAX package's state; a float32
    operator without a float64 product refuses."""
    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu import Exponentiator as JaxExponentiator

    if not renormalize:
        n, steps, a, m = 192, 25, 0.1j, 16
        rng = np.random.default_rng(3)
        v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        v /= np.linalg.norm(v)
        offsets, diags = [-1, 1], [np.full(n, -1.0, np.float32)] * 2
        d = np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
        w, u = np.linalg.eigh(d)
        truth = u @ (np.exp(a * steps * w) * (u.conj().T @ v))
    else:  # imaginary time onto the ground state of a unit-gapped diagonal
        n, steps, a, m = 64, 20, -1.0, 12
        v = np.random.default_rng(0).standard_normal(n) + 0j
        v /= np.linalg.norm(v)
        offsets, diags = [0], [np.arange(n, dtype=np.float32)]
        truth = np.zeros(n, np.complex128)
        truth[0] = 1.0
    re_j, im_j = JaxExponentiator(JaxDIA.from_diagonals(offsets, diags, n), dtype=np.float32).evolve(
        a, v.real, v.imag, steps, krylov_dim=m, renormalize=renormalize, precise=True)
    ex = tl.Exponentiator(tl.DIAOperator.from_diagonals(offsets, diags, n, device="cpu"))
    re, im = ex.evolve(a, v.real, v.imag, steps, krylov_dim=m, renormalize=renormalize, precise=True)
    assert isinstance(re, np.ndarray) and re.dtype == im.dtype == np.float64
    out = re + 1j * im
    if renormalize:
        assert abs(np.linalg.norm(out) - 1.0) < 1e-10 and abs(re @ (np.arange(n) * re)) < 1e-8
    else:
        assert _angle(truth, out) < 1e-10
        r32, i32 = ex.evolve(a, v.real.astype(np.float32), v.imag.astype(np.float32), steps, krylov_dim=m)
        assert _angle(truth, out) < 1e-2 * _angle(truth, _complex(r32, i32))  # >= 100x the float32 path
    # Within 2e-12 of the JAX state, or of its own distance from the exact
    # propagator where its word-pair floor is wider (3.0e-12 on the
    # unitary case, where the port's float64 state is within 1e-15).
    out_j = np.asarray(re_j) + 1j * np.asarray(im_j)
    floor = 0.0 if renormalize else np.abs(out_j - truth).max()
    assert np.abs(out - out_j).max() < max(2e-12, floor + 1e-13)
    if not renormalize:
        assert np.abs(out - truth).max() < 1e-13
    fn = tl.Exponentiator(tl.FunctionOperator(lambda x: -x, 16, np.float32, device="cpu"))
    with pytest.raises(NotImplementedError, match="matvec_f64"):
        fn.evolve(1j, np.ones(16), np.zeros(16), 2, precise=True)


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
    # The precise chain (ROADMAP item 10) over float32 storage, the JAX
    # test's cases (tests/test_exponentiator.py::
    # test_chebyshev_propagator_precise_df64): 1e-12 relative against expm
    # and within 2e-12 of the JAX package's word-pair chain.
    from lanczos_tpu import DIAOperator as JaxDIA
    from lanczos_tpu import Exponentiator as JaxExponentiator

    diags = [np.full(n, -1.0, np.float32)] * 2
    ex32 = tl.Exponentiator(tl.DIAOperator.from_diagonals([-1, 1], diags, n, device="cpu"))
    ex_j = JaxExponentiator(JaxDIA.from_diagonals([-1, 1], diags, n), dtype=np.float32)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w /= np.linalg.norm(w)
    for a in (3j, 25j, -0.5):
        truth = sla.expm(a * a_mat) @ w
        (re, im), terms = ex32.run_chebyshev(a, w.real, w.imag, lo=-2.0, hi=2.0, precise=True)
        (re_j, im_j), terms_j = ex_j.run_chebyshev(a, w.real, w.imag, lo=-2.0, hi=2.0, precise=True)
        assert isinstance(re, np.ndarray) and re.dtype == np.float64 and terms == terms_j
        out = re + 1j * im
        assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 1e-12, a
        assert np.abs(out - (np.asarray(re_j) + 1j * np.asarray(im_j))).max() < 2e-12, a


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


# The device-resident build: mode='fused' and run_batch.

N_RING = 60


def _fused_case(dtype, seed=3):
    """The JAX package's batch case (tests/test_exponentiator.py:149-175):
    the n = 60 hopping ring and a seeded complex unit state, taken real for
    a real operator."""
    v = _state(N_RING, seed)
    return _ring(N_RING).astype(dtype), v if np.dtype(dtype).kind == "c" else v.real.copy()


def _port_run(h, v, a, mode, full_orth):
    ex = tl.Exponentiator(h, mode=mode, device="cpu")
    ex.full_orthogonalize = full_orth
    out, itern = ex.run(a, v)
    return _np(out), itern


@pytest.mark.parametrize("full_orth", [False, True])
@pytest.mark.parametrize("a", [-0.7j, -0.5])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_fused_matches_hybrid(dtype, a, full_orth):
    """The fused build queues the hybrid step's arithmetic and replays its
    stop test, so it stops at the hybrid's iteration; at a real a both stop
    on the R7-repaired test, far below max_iteration = n."""
    h, v = _fused_case(dtype)
    got, it_fused = _port_run(h, v, a, "fused", full_orth)
    want, it_hybrid = _port_run(h, v, a, "hybrid", full_orth)
    assert it_fused == it_hybrid < N_RING // 2
    assert got.dtype == want.dtype and np.iscomplexobj(got) == (a.imag != 0 or np.dtype(dtype).kind == "c")
    assert np.abs(got - want).max() <= PARITY * np.abs(want).max()


@pytest.mark.parametrize("full_orth", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_fused_matches_jax_fused(dtype, full_orth):
    """At an imaginary a, where the reference's overlap test and the
    port's relative-change test agree (R7 does not bite), the port's fused
    build stops where the JAX package's does, with its output."""
    import jax.numpy as jnp
    import lanczos_tpu as lt

    h, v = _fused_case(dtype)
    jex = lt.Exponentiator(lt.DenseOperator(jnp.asarray(h)), mode="fused")
    jex.full_orthogonalize = full_orth
    want, it_jax = jex.run(-0.7j, jnp.asarray(v))
    got, it_port = _port_run(h, v, -0.7j, "fused", full_orth)
    want = np.asarray(want)
    assert it_port == it_jax
    assert np.abs(got - want).max() <= PARITY * np.abs(want).max()


@pytest.mark.parametrize("full_orth", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_fused_real_a_meets_the_overlap_bar(dtype, full_orth):
    """At a real a the JAX fused build runs to max_iteration = n (R7), so
    scipy's expm is the reference: the port's fused build stops early and
    meets the reference's overlap bar."""
    h, v = _fused_case(dtype)
    got, itern = _port_run(h, v, -0.5, "fused", full_orth)
    truth = sla.expm(-0.5 * h) @ v
    assert itern < N_RING // 2
    assert _overlap_err(truth, got) < EPS_REF
    assert np.linalg.norm(got - truth) <= 1e-7 * np.linalg.norm(truth)


@pytest.mark.parametrize("dtype, a", [(np.complex128, -0.7j), (np.float64, -0.7j), (np.float64, -0.5),
                                      (np.float32, -0.7j)])
def test_run_batch_rows_are_single_runs(dtype, a):
    """tests/test_exponentiator.py:149-175: each row of run_batch has the
    iteration count and the output of run on that row, fused and hybrid,
    and meets the exact propagator's overlap bar; a zero row gives zeros
    and 1 iteration (:255-265)."""
    h = _ring(N_RING).astype(dtype)
    rng = np.random.default_rng(3)
    batch = rng.standard_normal((4, N_RING)) + 1j * rng.standard_normal((4, N_RING))
    batch /= np.linalg.norm(batch, axis=1, keepdims=True)
    batch = np.concatenate([batch if np.dtype(dtype).kind == "c" else batch.real, np.zeros((1, N_RING))]).astype(dtype)
    ex = tl.Exponentiator(h, device="cpu")
    outs, iters = ex.run_batch(a, batch)
    outs = _np(outs)
    assert outs.shape == (5, N_RING) and iters.shape == (5,)
    w, u = np.linalg.eigh(h.astype(np.complex128))
    tol = PARITY if np.dtype(dtype) != np.float32 else 1e-6
    for i in range(4):
        for mode in ("fused", "hybrid"):
            single, it_single = _port_run(h, batch[i], a, mode, False)
            assert int(iters[i]) == it_single
            assert np.abs(outs[i] - single).max() <= tol * np.abs(single).max()
        truth = u @ (np.exp(a * w) * (u.conj().T @ batch[i].astype(np.complex128)))
        assert _overlap_err(truth, outs[i]) < (EPS_REF if np.dtype(dtype) != np.float32 else ex.eps)
    assert np.all(outs[4] == 0) and int(iters[4]) == 1


def test_fused_zero_input_and_zero_batch():
    """exp(a*A) 0 = 0 with no build: 0 iterations for run (as the hybrid
    build), 1 per row for run_batch (the JAX batch's trivial rows)."""
    ex = tl.Exponentiator(_ring(8), mode="fused", device="cpu")
    out, itern = ex.run(-0.5j, np.zeros(8))
    assert itern == 0 and not bool(out.abs().any())
    outs, iters = ex.run_batch(-0.5j, np.zeros((3, 8)))
    assert outs.shape == (3, 8) and outs.dtype == torch.complex128 and not bool(outs.abs().any())
    assert iters.tolist() == [1, 1, 1]


def test_fused_f32_breakdown_terminates():
    """test_fused_f32_breakdown_terminates: beta falls below the float32
    machine eps after ~2 steps; the fused build's queued stage runs on past
    it, but the replay stops at the breakdown, as the hybrid build does, and
    no row past it reaches the output."""
    n = 8
    h = np.diag(np.arange(1, n + 1, dtype=np.float32))
    v = np.zeros(n, np.float32)
    v[0], v[1] = 1.0, 1e-8
    out, itern = tl.Exponentiator(h, mode="fused", device="cpu").run(0.5, v)
    assert abs(float(out[0]) - np.exp(0.5)) < 1e-4
    assert bool(torch.isfinite(out).all())
    assert itern <= n and itern == tl.Exponentiator(h, device="cpu").run(0.5, v)[1]


def test_run_batch_nan_row_is_built():
    """A NaN row is not a trivial row: it is built and comes back
    non-finite with the iteration count of run on it, fused and hybrid, as
    the JAX batch's row test (norm < 10 * tiny) lets it; the other rows
    keep their single runs' outputs."""
    h = _ring(N_RING)
    rng = np.random.default_rng(5)
    batch = rng.standard_normal((2, N_RING))
    batch /= np.linalg.norm(batch, axis=1, keepdims=True)
    batch[0, 7] = np.nan
    outs, iters = tl.Exponentiator(h, device="cpu").run_batch(-0.5, batch)
    outs = _np(outs)
    assert not np.isfinite(outs[0]).any() and np.isfinite(outs[1]).all()
    for mode in ("fused", "hybrid"):
        single, it_single = _port_run(h, batch[0], -0.5, mode, False)
        assert int(iters[0]) == it_single and not np.isfinite(single).any()
    single, it_single = _port_run(h, batch[1], -0.5, "fused", False)
    assert int(iters[1]) == it_single and np.abs(outs[1] - single).max() <= PARITY * np.abs(single).max()


@pytest.mark.parametrize("initial, max_iteration, stages, built", [(16, None, 1, 16), (8, None, 2, 32),
                                                                   (8, 10, 2, 10)])
def test_fused_reads_once_per_stage(monkeypatch, initial, max_iteration, stages, built):
    """What the fused build is for: one host read per stage, not per
    iteration.  The n = 60 ring at a = -0.5 stops after 9 iterations; a
    first stage of 16 holds them, a first stage of 8 grows 4x (to 32, or
    to max_iteration) once.  Every queued iteration is one matvec."""
    reads, matvecs = [], []
    read = exponentiator_fused._read
    monkeypatch.setattr(exponentiator_fused, "_read", lambda s: reads.append(s.queued) or read(s))
    h, v = _fused_case(np.float64)
    ex = tl.Exponentiator(h, mode="fused", device="cpu")
    ex.initial_buffer_size, ex.max_iteration = initial, max_iteration
    matvec = ex.operator.matvec
    ex.operator.matvec = lambda x: matvecs.append(1) or matvec(x)
    out, itern = ex.run(-0.5, v)
    want, it_hybrid = _port_run(h, v, -0.5, "hybrid", False)
    assert itern == it_hybrid == 9
    assert len(reads) == stages and reads[-1] == built and len(matvecs) == built
    assert np.abs(_np(out) - want).max() <= PARITY * np.abs(want).max()
