"""Tridiagonal layer of the PyTorch port against the JAX package: the Sturm
multisection of the fused engine's convergence test and the host solvers;
and the host library's other entry, the COO -> BSR packer."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

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


@pytest.mark.parametrize("backend", ["lapack", "numpy", "native", "bisect"])
def test_host_solvers_match_jax(backend):
    """The host backends against the JAX package's.  ``native`` and
    ``bisect`` compile the same source with the same flags in both
    packages, so they agree bit for bit, and the unconverged-block total
    moves by the same count in both (a NaN coupling never deflates, so
    every block of the QL sweep hits its cap)."""
    pytest.importorskip("jax")
    from lanczos_tpu.core import tridiagonal as jtri

    alpha, beta = _tridiagonal(30, seed=2)
    w_j, z_j = jtri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    w_t, z_t = ttri.eigh_tridiagonal_host(alpha, beta[:29], backend=backend)
    ext_j, ext_t = (
        [mod.extremal_eigvals_host(alpha, beta, 4, fm, backend=backend) for fm in (False, True)] for mod in (jtri, ttri)
    )
    if backend == "native":
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_array_equal(z_t, z_j)
        np.testing.assert_array_equal(ext_t, ext_j)
    elif backend == "bisect":
        # The eigenvalues keep the JAX package's bits.  The eigenvectors are
        # repaired (R8): this case holds a pair 5.2e-3 apart, inside the
        # 1e-3 ||T||_1 = 7.2e-3 cluster tolerance, so they are the JAX
        # vectors only up to rounding.
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_array_equal(ext_t, ext_j)
        np.testing.assert_allclose(np.abs(np.sum(z_t * z_j, axis=1)), 1.0, atol=1e-12)
    else:
        np.testing.assert_allclose(w_t, w_j, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(np.abs(np.sum(z_t * z_j, axis=1)), 1.0, atol=1e-12)
        np.testing.assert_allclose(ext_t, ext_j, rtol=1e-13, atol=1e-13)
    exact = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta[:29], 1) + np.diag(beta[:29], -1))
    np.testing.assert_allclose(w_t, exact, rtol=0, atol=1e-12 * np.abs(exact).max())
    if backend == "bisect":
        # the plain version: numpy eigenvalues, the backward recurrence and
        # two inverse iterations
        w_p, z_p = ttri._eigh_bisect_np(alpha, beta[:29])
        np.testing.assert_allclose(w_t, w_p, rtol=0, atol=1e-12 * np.abs(exact).max())
        np.testing.assert_allclose(np.abs(np.sum(z_t * z_p, axis=1)), 1.0, atol=1e-12)
        # R8's repro (ROADMAP.md queue 3): m = 128, smallest gap 7.9e-6; the
        # unrepaired vectors had residuals up to 2.2 and overlaps of 1e-33
        # with the true ones.  Both routes against np.linalg.eigh.
        rng = np.random.default_rng(11)
        a8, b8 = rng.standard_normal(128), rng.uniform(0.1, 1.0, 127)
        t8 = np.diag(a8) + np.diag(b8, 1) + np.diag(b8, -1)
        scale = np.linalg.norm(t8, 2)
        w8 = np.linalg.eigh(t8)[0]
        for w, z in (ttri.eigh_tridiagonal_host(a8, b8, backend="bisect"), ttri._eigh_bisect_np(a8, b8)):
            np.testing.assert_allclose(w, w8, rtol=0, atol=1e-12 * scale)
            assert np.linalg.norm(t8 @ z.T - z.T * w, axis=0).max() <= 1e-12 * scale
            assert np.abs(z @ z.T - np.eye(128)).max() <= 1e-12 * scale
    if backend == "native":
        bad = beta[:29].copy()
        bad[3] = np.nan
        before = (jtri.unconverged_total(), ttri.unconverged_total())
        jtri.eigh_tridiagonal_host(alpha, bad, eigvals_only=True, backend="native")
        ttri.eigh_tridiagonal_host(alpha, bad, eigvals_only=True, backend="native")
        moved = (jtri.unconverged_total() - before[0], ttri.unconverged_total() - before[1])
        assert moved[0] == moved[1] > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eigenvectors_backward_device_matches_jax(dtype):
    """The device backward recurrence against the JAX package's on the same
    (cap, size, lams): a strongly coupled tridiagonal, where the pure
    recurrence is accurate (the JAX package's own case), and size 1."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu.core import tridiagonal as jtri

    rng = np.random.default_rng(13)
    m, cap = 19, 32
    alpha = np.zeros(cap, dtype)
    beta = np.zeros(cap, dtype)
    alpha[:m] = 0.3 * rng.standard_normal(m)
    beta[: m - 1] = -1.0
    t = np.diag(alpha[:m].astype(np.float64)) + np.diag(beta[: m - 1].astype(np.float64), 1)
    t += np.diag(beta[: m - 1].astype(np.float64), -1)
    lams = np.linalg.eigvalsh(t)[[0, 1, m - 1]].astype(dtype)
    want = np.asarray(jtri.eigenvectors_backward_device(jnp.asarray(alpha), jnp.asarray(beta), m, lams))
    for size in (m, torch.tensor(m)):  # a Python int or a 0-d tensor
        got = ttri.eigenvectors_backward_device(torch.from_numpy(alpha), torch.from_numpy(beta), size,
                                                torch.from_numpy(lams)).numpy()
        assert got.shape == (3, cap) and got.dtype == dtype and np.all(got[:, m:] == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == np.float64 else 2e-5)
        for v, lam in zip(got, lams):
            np.testing.assert_allclose(t @ v[:m], lam * v[:m], atol=1e-8 if dtype == np.float64 else 2e-3)
    one = ttri.eigenvectors_backward_device(torch.zeros(8, dtype=torch.float64).index_fill(0, torch.tensor([0]), 3.0),
                                            torch.zeros(8, dtype=torch.float64), 1, [3.0])
    np.testing.assert_allclose(one.numpy()[0], np.eye(8)[0], atol=1e-14)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_bsr_matches_jax_and_numpy(dtype):
    # native.host_kernels.pack_bsr (lanczos_tpu/native/host_kernels.py:137)
    # against the JAX package's and against the numpy packer, bit for bit,
    # on a band with duplicates (summed in input order by all three).
    from lanczos_tpu.native import host_kernels as jhk

    from lanczos_tpu_torch.native import host_kernels as thk
    from lanczos_tpu_torch.ops.operators import _pack_bsr

    rng = np.random.default_rng(17)
    n, bm, bk = 300, 16, 8
    rows = rng.integers(0, n, 4000)
    cols = np.clip(rows + rng.integers(-20, 21, rows.shape[0]), 0, n - 1)
    rows, cols = np.concatenate([rows, rows[:700]]), np.concatenate([cols, cols[:700]])  # exact duplicates
    vals = rng.standard_normal(rows.shape[0])
    n_pad = 304  # lcm(bm, bk) = 16
    ncb = n_pad // bk
    ids, tiles = thk.pack_bsr(rows, cols, vals, ncb, bm, bk, dtype=dtype)
    ids_j, tiles_j = jhk.pack_bsr(rows, cols, vals, ncb, bm, bk, dtype=dtype)
    assert tiles.dtype == dtype and np.array_equal(ids, ids_j) and tiles.tobytes() == tiles_j.tobytes()
    # the numpy packer's tiles, gathered in block-id order, are pack_bsr's
    rb = ids // ncb
    slot = np.arange(ids.shape[0]) - np.concatenate([[0], np.cumsum(np.bincount(rb, minlength=n_pad // bm))])[rb]
    for layout in ("rmsk", "rsmk"):
        blocks, col_blocks = _pack_bsr(rows, cols, vals, n, bm, bk, dtype, layout)
        by_tile = blocks.transpose(0, 2, 1, 3) if layout == "rmsk" else blocks  # a view, (R, S, bm, bk)
        assert blocks.dtype == dtype and by_tile[rb, slot].tobytes() == tiles.tobytes()
        assert np.array_equal(col_blocks[rb, slot], ids % ncb)
        by_tile[rb, slot] = 0
        assert not blocks.any()  # no entry outside pack_bsr's tiles
    with pytest.raises(ValueError, match="out of range"):
        thk.pack_bsr([0, -1], [0, 0], [1.0, 1.0], ncb, bm, bk)


def test_host_backend_resolution(monkeypatch, tmp_path):
    """``auto`` resolves as in the JAX package: ``native`` when the port's
    own library builds, which it does here (g++), into
    ``lanczos_tpu_torch/build/``; else ``lapack``.  A failed build raises
    with the compiler's message wherever ``native`` or ``bisect`` is asked
    for by name."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.native import build, host_kernels

    assert ttri._resolve_backend(None) == "native"
    assert ttri._resolve_backend("auto") == "native"
    assert ttri._resolve_backend("bisect") == "bisect"
    with pytest.raises(ValueError):
        ttri._resolve_backend("qr")
    with pytest.raises(ValueError):
        ttri.set_default_host_backend("qr")
    path = build.shared_object_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert not list(build.SOURCE.parent.glob("*.so"))  # nothing beside the source
    assert build.gxx_command("s.cpp", "o.so")[1:6] == ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=default"]
    try:
        ttri.set_default_host_backend("lapack")
        assert ttri._resolve_backend(None) == "lapack"
    finally:
        ttri.set_default_host_backend("auto")
    (w,) = ttri.eigh_tridiagonal_host([3.0], [], eigvals_only=True)
    assert w.tolist() == [3.0]

    bad = tmp_path / "host_kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build.shared_object_path()
    assert "error" in str(err.value)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(host_kernels, "_load", lambda: (None, str(err.value)))
    assert ttri._resolve_backend("auto") == "lapack"
    for backend in ("native", "bisect"):
        with pytest.raises(RuntimeError, match="not C\\+\\+"):
            ttri.eigh_tridiagonal_host([1.0, 2.0], [0.5], backend=backend)


def _lanczos_tridiagonal(n, m, seed):
    """The first m Lanczos coefficients (full reorthogonalization, numpy
    float64) of a diagonal matrix with a few separated extremes: leading
    blocks whose extremal eigenvalues settle, as a build's do."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([[-3.0, -2.6, -2.3], rng.uniform(-1.0, 1.0, n - 6), [2.2, 2.5, 3.1]])
    q = rng.standard_normal(n)
    basis = [q / np.linalg.norm(q)]
    alpha, beta = np.zeros(m), np.zeros(m)
    for j in range(m):
        w = d * basis[j]
        alpha[j] = basis[j] @ w
        for b in basis:
            w -= (b @ w) * b
        beta[j] = np.linalg.norm(w)
        basis.append(w / beta[j])
    return alpha, beta


def _host_check_as_it_stood(st, k, nroot, find_maximum, eps, breakdown_eps):
    """The fused engine's check before K6: the buffers copied to the host
    and the decision taken there (solvers/lanczos_fused.py of PR 11)."""
    alpha, beta = st.alpha.cpu(), st.beta.cpu()
    broke = torch.nonzero(beta[st.screened : k] < breakdown_eps)
    if broke.numel():
        st.stop, st.itern = True, st.screened + int(broke[0, 0]) + 1
        return
    st.screened = k
    if eps == 0.0:
        return
    evs = ttri.extremal_eigenvalues_reference(alpha[:k], beta[:k], k, nroot, find_maximum)
    eps_t = torch.tensor(eps, dtype=alpha.dtype)
    rel_ok = bool(torch.all((evs - st.evs_prev).abs() < torch.minimum(evs.abs(), st.evs_prev.abs()) * eps_t))
    converged = st.have_prev and rel_ok and eps > 0
    st.evs_prev, st.have_prev = evs, k >= nroot
    if converged:
        st.stop, st.itern = True, k


def test_device_decision_matches_the_host_check():
    """The check with its decision on the buffers' device
    (``convergence_check`` through ``lanczos_fused._check``, the plain
    version here) stops where the host check stopped, with the same
    (stop, itern), screen position, gate and previous estimate after every
    check: seeded Lanczos tridiagonals in float32 and float64, both ends,
    eps > 0, eps = 0 (breakdown screen only) and eps < 0 (never stops), with
    and without a breakdown between two checks."""
    from types import SimpleNamespace

    from lanczos_tpu_torch.solvers import lanczos_fused

    stops = set()
    for dtype in (torch.float32, torch.float64):
        alpha_np, beta_np = _lanczos_tridiagonal(200, 96, seed=17)
        eps_m = float(torch.finfo(dtype).eps)
        for find_maximum in (False, True):
            for eps in (1e-6 if dtype == torch.float32 else 1e-10, 0.0, -1.0):
                for broken_at in (None, 9):
                    beta = beta_np.copy()
                    if broken_at is not None:
                        beta[broken_at] = 0.01 * eps_m
                    states = [
                        SimpleNamespace(alpha=torch.tensor(alpha_np, dtype=dtype), beta=torch.tensor(beta, dtype=dtype),
                                        screened=0, stop=False, itern=0, have_prev=False,
                                        evs_prev=torch.full((3,), float("inf"), dtype=dtype))
                        for _ in range(2)
                    ]
                    for k in [*range(4, 96, 4), 96]:
                        _host_check_as_it_stood(states[0], k, 3, find_maximum, eps, 10 * eps_m)
                        lanczos_fused._check(states[1], k, 3, find_maximum, eps, 10 * eps_m)
                        old, new = states
                        assert (new.stop, new.itern, new.screened, new.have_prev) == (
                            old.stop, old.itern, old.screened, old.have_prev), (dtype, eps, broken_at, k)
                        assert torch.equal(new.evs_prev, old.evs_prev)
                        if old.stop:
                            stops.add((eps > 0, broken_at is not None, old.itern))
                            break
    # Every kind of stop was seen: convergence, and a breakdown (at 10)
    # with and without the test.
    assert {s[:2] for s in stops} == {(True, False), (True, True), (False, True)}
    assert all(it == 10 for conv, broke, it in stops if broke) and all(it > 10 for conv, broke, it in stops if not broke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k6_matches_plain_on_card(cuda):
    """K6 against its plain version on the same CUDA tensors, bit for bit,
    in float32 and float64 (one item: the file's item count fixes its
    place in pytest-xdist's loadfile queue)."""
    for dtype in (torch.float32, torch.float64):
        _check_k6_against_plain(cuda, dtype)


def _check_k6_against_plain(cuda, dtype):
    """K6 against its plain version on the same CUDA tensors, bit for bit:
    the multisection on both routes (shared memory to 3600 rows in float32
    and 1800 in float64, global scratch past them), both ends, zero betas,
    buffers longer than the block; and the check's decision and new
    estimate, one launch each."""
    from lanczos_tpu_torch.ops import sturm_check

    rng = np.random.default_rng(23)
    for size, cap, nroot in ((1, 4, 2), (3, 3, 5), (40, 48, 3), (128, 128, 5), (700, 700, 2), (760, 800, 2),
                             (1801, 1801, 3), (3601, 3650, 1)):
        alpha = rng.standard_normal(cap)
        beta = rng.uniform(0.1, 1.0, cap)
        beta[rng.choice(max(size - 1, 1), max(1, size // 30), replace=False)] = 0.0
        a, b = torch.tensor(alpha, dtype=dtype, device=cuda), torch.tensor(beta, dtype=dtype, device=cuda)
        for find_maximum in (False, True):
            launches = sturm_check.sturm_check.launches
            got = ttri.extremal_eigenvalues_device(a, b, size, nroot, find_maximum)
            want = ttri.extremal_eigenvalues_reference(a, b, size, nroot, find_maximum)
            assert sturm_check.sturm_check.launches == launches + 1
            assert torch.equal(got, want), (size, find_maximum, (got - want).abs().max())
    alpha_np, beta_np = _lanczos_tridiagonal(200, 96, seed=5)
    a, b = torch.tensor(alpha_np, dtype=dtype, device=cuda), torch.tensor(beta_np, dtype=dtype, device=cuda)
    eps_m = float(torch.finfo(dtype).eps)
    for eps, have_prev, screened in ((1e-6, True, 60), (1e-6, False, 60), (-1.0, True, 60), (0.0, True, 0)):
        prev = [ttri.extremal_eigenvalues_reference(a[:60], b[:60], 60, 3, False) for _ in range(2)]
        kw = dict(screened=screened, k=64, nroot=3, find_maximum=False, eps=eps, breakdown_eps=10 * eps_m,
                  have_prev=have_prev)
        launches = sturm_check.sturm_check.launches
        got = ttri.convergence_check(a, b, prev[0], **kw)
        want = ttri.convergence_check_reference(a, b, prev[1], **kw)
        assert sturm_check.sturm_check.launches == launches + 1
        assert got.device.type == "cuda" and got.tolist() == want.tolist() and torch.equal(prev[0], prev[1])
