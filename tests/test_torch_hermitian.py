"""Complex Hermitian input in the PyTorch port against the JAX package on the
CPU.

The JAX package solves ``H = Hr + i Hi`` through its real 2n embedding
(``HermitianSplitOperator``), since TPU runtimes have no complex dtype; the
port keeps that class as an API and solves ``complex_operator()``, one
native complex operator, instead.  Both get the same parts, made from numpy
seeds, in float64.  The ``Exponentiator``'s methods on the split operator
agree to the reference's exponentiator bar, an overlap error of
machine_eps * 1e2 ~ 2.2e-14 (exponentiator.hpp:58); ``solve_hermitian``'s
values agree to 1e-12 relative and its vectors to an |overlap| of
1 - 1e-10; operators carried across with ``convert`` give the JAX objects'
products to 1e-14.  The Harper-Hofstadter lattice (flux 1/4, L = 16; a
4-fold ground level, the deflation case) is held to Harper's reduction.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.ops.hermitian_split import solve_hermitian  # noqa: E402

EPS_REF = np.finfo(np.float64).eps * 1e2  # the reference's overlap bar, exponentiator.hpp:58
VALUES = 1e-12  # eigenvalues, relative to the largest |value|
VECTORS = 1e-10  # 1 - |<v_jax, v_port>|
PRODUCTS = 1e-14  # carried operators' products, relative to max |y|
N = 40


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _complex(re, im):
    return _np(re).astype(np.float64) + 1j * _np(im).astype(np.float64)


def _overlap_err(truth, out):
    t = np.asarray(truth, np.complex128).ravel()
    o = np.asarray(out, np.complex128).ravel()
    return abs(1.0 - abs(np.vdot(t, o)) / (np.linalg.norm(t) * np.linalg.norm(o)))


def _hermitian(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return scale * (a + a.conj().T) / 2


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return v / np.linalg.norm(v)


def _split_pair(h):
    """The same split operator in both packages: DenseOperator float64
    parts (the port's on the CPU)."""
    import jax.numpy as jnp
    import lanczos_tpu as lj
    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator as JaxSplit

    hr, hi = np.ascontiguousarray(h.real), np.ascontiguousarray(h.imag)
    jax_op = JaxSplit(lj.DenseOperator(jnp.asarray(hr)), lj.DenseOperator(jnp.asarray(hi)))
    return jax_op, convert.hermitian_split_from_arrays("dense", (hr,), (hi,), device="cpu")


def _drive(ex, method, psi):
    """One ``Exponentiator`` method (either package, on a split operator) of
    the complex n-state ``psi``: a list of complex output states."""
    if method == "run":
        return [_np(ex.run(-0.7j, psi)[0])]
    if method == "run_grid":
        return list(_np(ex.run_grid([0.3j, -0.7j, 1.1j], psi)[0]))
    if method == "run_split":
        return [_complex(*ex.run_split(-0.7j, psi.real, psi.imag)[0])]
    if method == "run_batch":
        return list(_np(ex.run_batch(-0.7j, np.stack([psi, _state(len(psi), 5)]))[0]))
    if method == "taylor_run":
        return [_np(ex.taylor_run(-0.7j, psi)[0])]
    if method == "evolve":
        return [_complex(*ex.evolve(0.05j, psi.real, psi.imag, 10, krylov_dim=12))]
    if method == "evolve_precise":
        return [_complex(*ex.evolve(0.05j, psi.real, psi.imag, 10, krylov_dim=16, precise=True))]
    if method == "run_chebyshev":
        return [_complex(*ex.run_chebyshev(1.5j, psi.real, psi.imag)[0])]
    if method == "run_chebyshev_precise":
        return [_complex(*ex.run_chebyshev(1.5j, psi.real, psi.imag, precise=True)[0])]
    (re, im), _ = ex.run_chebyshev_grid([0.5j, 1.5j], psi.real, psi.imag)
    return list(_complex(re, im))


METHODS = ("run", "run_grid", "run_split", "run_batch", "taylor_run", "evolve", "evolve_precise", "run_chebyshev",
           "run_chebyshev_precise", "run_chebyshev_grid")


def test_exponentiator_on_split_operators_matches_jax():
    """Every method of the JAX package's ``Exponentiator`` on a
    ``HermitianSplitOperator`` (its real 2n embedding) against the port's
    (native complex builds on ``complex_operator()``): the same complex
    n-states to the reference's overlap bar, and to exp(a H) psi itself."""
    import scipy.linalg as sla
    from lanczos_tpu import Exponentiator as JaxExponentiator

    h = _hermitian(N, 21, scale=0.1)
    jax_op, port_op = _split_pair(h)
    assert port_op.n == jax_op.n == 2 * N and port_op.complex_operator().dtype == torch.complex128
    psi = _state(N, 4)
    for method in METHODS:
        want = _drive(JaxExponentiator(jax_op), method, psi)
        got = _drive(tl.Exponentiator(port_op), method, psi)
        assert len(got) == len(want), method
        for w, g in zip(want, got):
            assert g.shape == (N,) and np.iscomplexobj(g), method
            assert _overlap_err(w, g) < EPS_REF, (method, _overlap_err(w, g))
    # A native complex operator takes the same paths.
    ex = tl.Exponentiator(h, device="cpu")
    (re, im), _ = ex.run_chebyshev(1.5j, psi.real, psi.imag)
    assert _overlap_err(sla.expm(1.5j * h) @ psi, _complex(re, im)) < EPS_REF
    out = _complex(*ex.evolve(0.05j, psi.real, psi.imag, 10, krylov_dim=16))
    assert _overlap_err(sla.expm(0.5j * h) @ psi, out) < EPS_REF


def test_solve_hermitian_and_carried_operators_match_jax():
    """``solve_hermitian`` (JAX: the embedded solve and its pair folding;
    the port: the complex operator directly) at both ends, with
    ``precise=True`` and ``method='filtered'`` held to ``eigvalsh``; and
    the JAX package's split and shift-invert operators carried across with
    ``convert`` give the same products."""
    import jax.numpy as jnp
    import lanczos_tpu as lj
    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator as JaxSplit
    from lanczos_tpu.ops.hermitian_split import solve_hermitian as jax_solve

    h = _hermitian(N, 22)
    w = np.linalg.eigvalsh(h)
    jax_op, port_op = _split_pair(h)
    for find_max in (False, True):
        jv, jvec = jax_solve(jax_op.op_r, jax_op.op_i, 3, find_max)
        tv, tvec = solve_hermitian(port_op.op_r, port_op.op_i, 3, find_max)
        want = w[::-1][:3] if find_max else w[:3]
        scale = np.abs(w).max()
        assert np.max(np.abs(tv - jv)) <= VALUES * scale and np.max(np.abs(tv - want)) <= VALUES * scale
        assert tvec.shape == (3, N) and np.iscomplexobj(tvec)
        for j in range(3):
            assert 1 - abs(np.vdot(jvec[j], tvec[j])) <= VECTORS, (find_max, j)
    for kw in ({"precise": True}, {"method": "filtered", "precise": True, "auto_window": True}):
        tv, tvec = solve_hermitian(port_op.op_r, port_op.op_i, 2, **kw)
        assert np.max(np.abs(tv - w[:2])) <= VALUES * np.abs(w).max(), kw
        assert tvec.dtype == np.complex128
        resid = h @ tvec.T - tvec.T * tv
        assert np.linalg.norm(resid, axis=0).max() <= 1e-8, kw
    # The precise filtered solve of complex input (the port: its float64
    # view and a complex128 basis) against the JAX package's embedded one,
    # on samples/sample12_refined_checkpoint.py's m = 80 matrix stored in
    # float32, at that sample's 1e-10 bar on values and residuals.
    rng = np.random.default_rng(0)
    h80 = rng.standard_normal((80, 80)) + 1j * rng.standard_normal((80, 80))
    h80 = (h80 + h80.conj().T) / 2
    hr32, hi32 = h80.real.astype(np.float32), h80.imag.astype(np.float32)
    h80 = hr32.astype(np.float64) + 1j * hi32.astype(np.float64)
    h80 = (h80 + h80.conj().T) / 2
    jv, _jvec = jax_solve(lj.DenseOperator(jnp.asarray(hr32)), lj.DenseOperator(jnp.asarray(hi32)), 2,
                          method="filtered", precise=True)
    tv, tvec = solve_hermitian(tl.DenseOperator(hr32, device="cpu"), tl.DenseOperator(hi32, device="cpu"), 2,
                               method="filtered", precise=True)
    assert np.max(np.abs(np.sort(tv) - np.sort(jv))) <= 1e-10
    assert np.max(np.abs(np.sort(tv) - np.linalg.eigvalsh(h80)[:2])) <= 1e-10
    assert tvec.dtype == np.complex128
    assert np.linalg.norm(h80 @ tvec.T - tvec.T * tv, axis=0).max() <= 1e-10

    # Carried operators: the embedding's products (matvec and matvec_f64
    # against JAX's matvec and matvec_df), the complex operator against the
    # matrix, for dense, DenseDF, BSR and DIA parts; and a ShiftInvertOperator.
    x = np.random.default_rng(23).standard_normal(2 * N)
    z = x[:N] + 1j * x[N:]
    rows, cols = np.nonzero(np.abs(h) > 0.8)
    jbsr = JaxSplit(*(lj.BSROperator.from_coo(rows, cols, part[rows, cols], N, bm=8, bk=8, dtype=np.float64)
                      for part in (h.real, h.imag)))
    hs = np.zeros_like(h)
    hs[rows, cols] = h[rows, cols]
    carried = {
        "dense": (jax_op, port_op, h),
        "dense_df": (JaxSplit(lj.DenseDFOperator.from_f64(h.real), lj.DenseDFOperator.from_f64(h.imag)),
                     convert.hermitian_split_from_arrays("dense_df", (h.real,), (h.imag,), device="cpu"), h),
        "bsr": (jbsr, convert.hermitian_split_from_arrays(
            "bsr", *[(np.asarray(p.blocks), np.asarray(p.col_blocks), N, p.layout) for p in (jbsr.op_r, jbsr.op_i)],
            device="cpu"), hs),
    }
    # DIA parts: a banded Hermitian matrix, its complex operator composed
    # of the parts' own products.
    offs = (-1, 0, 1)
    hb = np.triu(np.tril(h, 1), -1)
    diags = [np.concatenate([np.diagonal(hb, d), np.zeros(abs(d))]) if d >= 0 else
             np.concatenate([np.zeros(-d), np.diagonal(hb, d)]) for d in offs]
    jdia = JaxSplit(*(lj.DIAOperator.from_diagonals(offs, [part(dd) for dd in diags], N)
                      for part in (np.real, np.imag)))
    carried["dia"] = (jdia, convert.hermitian_split_from_arrays(
        "dia", *[(p.offsets, np.asarray(p.data), N) for p in (jdia.op_r, jdia.op_i)], device="cpu"), hb)
    for kind, (jop, top, mat) in carried.items():
        want = np.asarray(jop.matvec(jnp.asarray(x)))
        if kind == "dense_df":
            hi_, lo_ = jop.matvec_df(jnp.asarray(x), jnp.zeros(2 * N))
            want = np.asarray(hi_) + np.asarray(lo_)
            got = _np(top.matvec_f64(torch.from_numpy(x)))
        else:
            got = _np(top.matvec(torch.from_numpy(x)))
        assert np.max(np.abs(got - want)) <= PRODUCTS * np.abs(want).max(), kind
        cz = _np(top.complex_operator().matvec(torch.from_numpy(z)))
        assert np.max(np.abs(cz - mat @ z)) <= PRODUCTS * np.abs(mat @ z).max(), kind
    assert isinstance(carried["bsr"][1].complex_operator(), tl.BSROperator)
    assert type(carried["dia"][1].complex_operator()).__name__ == "ComposedHermitianOperator"
    # The Chebyshev windows' Gershgorin bound of a complex operator: the
    # rows' sums of |entries|.
    from lanczos_tpu_torch.utils import estimate

    for kind in ("dense", "bsr"):
        _jop, top, mat = carried[kind]
        bound = estimate.gershgorin_bound(top.complex_operator())
        assert abs(bound - np.abs(mat).sum(axis=1).max()) <= 1e-12 * bound, kind
    sigma = 0.5 * (w[N // 2] + w[N // 2 + 1])
    jsi = lj.ShiftInvertOperator(lj.DenseOperator(jnp.asarray(h.real)), jnp.asarray(sigma), 1e-12, 400)
    tsi = convert.shift_invert_from(port_op.op_r, float(jsi.sigma), jsi.inner_tol, jsi.inner_maxiter)
    want = np.asarray(jsi.matvec(jnp.asarray(x[:N])))
    got = _np(tsi.matvec(torch.from_numpy(x[:N])))
    # Each product is an inner MINRES solve (51 iterations here, the same
    # count in both packages): its last iterate carries the two packages'
    # roundings amplified by the shifted system's conditioning, so the bar
    # is 1e-12 (measured 9.6e-14), with the exact solve beside it.
    exact = np.linalg.solve(h.real - sigma * np.eye(N), x[:N])
    assert np.max(np.abs(got - want)) <= 1e-12 * np.abs(want).max()
    assert np.max(np.abs(got - exact)) <= 1e-10 * np.abs(exact).max()


def _hofstadter(L, alpha=0.25):
    """The Harper-Hofstadter lattice, L x L, periodic, Landau gauge, t = 1,
    sites x + L*y, as a dense complex128 matrix."""
    x, y = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    x, y = x.ravel(), y.ravel()
    s = x + L * y
    h = np.zeros((L * L, L * L), np.complex128)
    h[(x + 1) % L + L * y, s] = -1.0
    h[x + L * ((y + 1) % L), s] = -np.exp(2j * np.pi * alpha * x)
    return h + h.conj().T


def _harper(L, q=4):
    """Every level of the L x L lattice at flux 1/q by Harper's reduction:
    a q x q Bloch matrix for each k_y = 2 pi m / L and k_x = 2 pi j / L,
    j < L/q."""
    out = []
    for m in range(L):
        for j in range(L // q):
            ky, kx = 2 * np.pi * m / L, 2 * np.pi * j / L
            mat = np.diag(-2.0 * np.cos(ky + 2 * np.pi * np.arange(q) / q)).astype(np.complex128)
            mat += np.diag(-np.ones(q - 1), 1) + np.diag(-np.ones(q - 1), -1)
            mat[q - 1, 0] += -np.exp(-1j * kx * q)
            mat[0, q - 1] += -np.exp(1j * kx * q)
            out.append(np.linalg.eigvalsh(mat))
    return np.sort(np.concatenate(out))


def test_hofstadter_lattice_against_harper():
    """L = 16, flux 1/4: Harper's reduction is the spectrum; the lowest
    level is 4-fold, so each solve needs its deflation rounds.  ``eigsh``
    on the dense and the sparse complex matrix, ``solve_hermitian`` on its
    parts and a complex BSR operator in complex64 (K1's complex instance on
    the card; the plain version here), whose tight route runs in
    complex128 over ``float64_view``."""
    import scipy.sparse as sp

    L = 16
    h = _hofstadter(L)
    ref = _harper(L)
    assert np.max(np.abs(np.linalg.eigvalsh(h) - ref)) < 1e-13
    bar = VALUES * np.abs(ref).max()
    w, v = tl.eigsh(h, k=6, which="SA", device="cpu")
    assert np.max(np.abs(w - ref[:6])) <= bar and v.shape == (L * L, 6)
    assert np.linalg.norm(h @ v - v * w, axis=0).max() <= 1e-8
    # A start that once left the second level's copies at residuals of 2e-8:
    # the fifth round's Krylov space grew copies of that 8-fold level from
    # rounding, their values below the accepted pairs' only in the last bits,
    # and a strict ranking let them evict converged pairs.  Values within
    # the engine's eps now rank as ties, so the accepted pairs stay.
    g = np.random.default_rng(0)
    eng = tl.LambdaLanczos(h, num_eigs=6, device="cpu")
    eng.init_vector = lambda n: g.uniform(-1.0, 1.0, n) + 1j * g.uniform(-1.0, 1.0, n)
    vals, vecs = eng.run()
    v6 = vecs.numpy().T
    assert np.max(np.abs(vals - ref[:6])) <= bar
    assert np.linalg.norm(h @ v6 - v6 * vals, axis=0).max() <= 1e-12
    assert np.max(np.abs(tl.eigsh(sp.csr_matrix(h), k=6, which="BE", device="cpu", return_eigenvectors=False)
                         - np.concatenate([ref[:3], ref[-3:]]))) <= bar
    vals, vecs = solve_hermitian(tl.DenseOperator(h.real.copy(), device="cpu"),
                                 tl.DenseOperator(h.imag.copy(), device="cpu"), 5)
    assert np.max(np.abs(vals - ref[:5])) <= bar
    assert np.max(np.abs(vecs.conj() @ vecs.T - np.eye(5))) < 1e-8  # the 4-fold level's vectors are orthonormal
    rows, cols = np.nonzero(h)
    op = tl.BSROperator.from_coo(rows, cols, h[rows, cols], L * L, bm=16, bk=16, dtype=torch.complex64, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the complex128 route raises no warning
        w64 = tl.eigsh(op, k=6, which="SA", tol=0, return_eigenvectors=False)
    assert np.max(np.abs(w64 - ref[:6])) <= 1e-6 * np.abs(ref).max()  # the entries are complex64
    w_loose = tl.eigsh(op, k=6, which="SA", tol=1e-6, return_eigenvectors=False)
    assert np.max(np.abs(w_loose - ref[:6])) <= 1e-5 * np.abs(ref).max()
