"""Kernel K1 (BSR sparse matvec) of the PyTorch port: its plain version
against the JAX package's Pallas kernels (interpret mode) and plain einsum,
the numpy packer against the JAX packer, and — on a CUDA device — the
hand-written kernel against its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

from lanczos_tpu_torch import BSROperator as TorchBSR  # noqa: E402
from lanczos_tpu_torch.convert import bsr_operator_from_arrays  # noqa: E402
from lanczos_tpu_torch.ops import spmv  # noqa: E402

# float32 results differ only in summation order; float64 the same at its eps.
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _random_sparse(n, density, block, dtype, seed=0):
    """Symmetric matrix with clustered nonzeros (dense-ish diagonal blocks
    plus scattered entries), the shape BSR is for."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for s in range(0, n, block):
        e = min(s + block, n)
        a[s:e, s:e] = rng.standard_normal((e - s, e - s))
    mask = rng.random((n, n)) < density
    a[mask] += rng.standard_normal(mask.sum())
    return ((a + a.T) / 2).astype(dtype)


def _coo(a):
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols]


@pytest.mark.parametrize("n,bm", [(256, 8), (300, 8), (300, 128)])
def test_plain_rmsk_matches_pallas_t_interpret(n, bm):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu import BSROperator
    from lanczos_tpu.ops import pallas_spmv

    a = _random_sparse(n, 0.05, bm, np.float32)
    op = BSROperator.from_coo(*_coo(a), n, bm=bm, bk=bm)
    assert op.layout == "rmsk"
    x = np.random.default_rng(9).standard_normal(op.n_padded).astype(np.float32)
    want = np.asarray(pallas_spmv.bsr_matvec_pallas_t(op.blocks, op.col_blocks, jnp.asarray(x), interpret=True))
    got = spmv.bsr_matvec_reference(
        torch.from_numpy(np.array(op.blocks)), torch.from_numpy(np.array(op.col_blocks)),
        torch.from_numpy(x), layout="rmsk",
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[np.float32], atol=RTOL[np.float32] * np.abs(want).max())


@pytest.mark.parametrize("n,bm", [(256, 8), (300, 128)])
def test_plain_rsmk_matches_pallas_interpret(n, bm):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu import BSROperator
    from lanczos_tpu.ops import pallas_spmv

    a = _random_sparse(n, 0.05, bm, np.float32, seed=1)
    op = BSROperator.from_coo(*_coo(a), n, bm=bm, bk=bm, use_pallas=False)
    assert op.layout == "rsmk"
    x = np.random.default_rng(3).standard_normal(op.n_padded).astype(np.float32)
    want = np.asarray(pallas_spmv.bsr_matvec_pallas(op.blocks, op.col_blocks, jnp.asarray(x), interpret=True))
    got = spmv.bsr_matvec_reference(
        torch.from_numpy(np.array(op.blocks)), torch.from_numpy(np.array(op.col_blocks)),
        torch.from_numpy(x), layout="rsmk",
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[np.float32], atol=RTOL[np.float32] * np.abs(want).max())


@pytest.mark.parametrize("layout", ["rsmk", "rmsk"])
@pytest.mark.parametrize("n,bm", [(256, 8), (300, 128)])
def test_plain_float64_matches_jax_reference(layout, n, bm):
    # The Pallas kernels accumulate in float32 (preferred_element_type), so
    # the float64 oracle is the JAX package's plain einsum, which the
    # kernels are tested against in turn.
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu import BSROperator
    from lanczos_tpu.ops import pallas_spmv

    a = _random_sparse(n, 0.05, bm, np.float64, seed=2)
    op = BSROperator.from_coo(*_coo(a), n, bm=bm, bk=bm, dtype=jnp.float64)
    blocks = np.array(op.blocks)  # float64 packs the canonical rsmk layout
    if layout == "rmsk":
        blocks = np.ascontiguousarray(np.moveaxis(blocks, 2, 1))
    x = np.random.default_rng(4).standard_normal(op.n_padded)
    want = np.asarray(pallas_spmv.bsr_matvec_reference(jnp.asarray(blocks), op.col_blocks, jnp.asarray(x), layout=layout))
    got = spmv.bsr_matvec_reference(
        torch.from_numpy(blocks), torch.from_numpy(np.array(op.col_blocks)), torch.from_numpy(x), layout=layout
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[np.float64], atol=RTOL[np.float64] * np.abs(want).max())
    np.testing.assert_allclose(got[:n], a @ x[:n], rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bm,bk", [(300, 8, 8), (300, 128, 128), (200, 6, 4)])
def test_packer_matches_jax_packer(dtype, n, bm, bk):
    pytest.importorskip("jax")
    from lanczos_tpu import BSROperator

    a = _random_sparse(n, 0.05, bm, dtype, seed=5)
    rows, cols, vals = _coo(a)
    # duplicates are summed by both packers
    rows, cols, vals = np.concatenate([rows, rows[:7]]), np.concatenate([cols, cols[:7]]), np.concatenate([vals, vals[:7]])
    ref = BSROperator.from_coo(rows, cols, vals, n, bm=bm, bk=bk, dtype=dtype)
    want = bsr_operator_from_arrays(np.asarray(ref.blocks), np.asarray(ref.col_blocks), n, ref.layout, device="cpu")
    got = TorchBSR.from_coo(rows, cols, vals, n, bm=bm, bk=bk, dtype=dtype, device="cpu")
    assert torch.equal(got.col_blocks, want.col_blocks)
    np.testing.assert_allclose(got.blocks.numpy(), want.blocks.numpy(), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_operator_matvec_unpadded_and_ragged(dtype):
    # n not a multiple of the tile: matvec takes and returns length-n vectors.
    n = 300
    a = _random_sparse(n, 0.05, 16, dtype, seed=6)
    op = TorchBSR.from_coo(*_coo(a), n, bm=16, bk=16, dtype=dtype, device="cpu")
    x = np.random.default_rng(7).standard_normal(n).astype(dtype)
    y = op.matvec(torch.from_numpy(x)).numpy()
    assert y.shape == (n,)
    want = a.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y, want, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(want).max() * 10)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,bm,s,bk,n", [(3, 128, 3, 128, 300), (64, 8, 5, 8, 509), (17, 16, 300, 16, 272), (4, 6, 2, 6, 24)])
def test_kernel_matches_plain_on_cuda(cuda, dtype, r, bm, s, bk, n):
    # (17, 16, 300, 16): S*bk exceeds one shared-memory piece in float64.
    g = torch.Generator().manual_seed(r * s)
    blocks = torch.randn((r, bm, s, bk), generator=g, dtype=dtype)
    col_blocks = torch.randint(0, (r * bm) // bk, (r, s), generator=g, dtype=torch.int32)
    x = torch.randn(n, generator=g, dtype=dtype)
    want = spmv.bsr_matvec(blocks, col_blocks, x, n_out=n)  # CPU: plain version
    before = spmv.bsr_matvec.launches
    got = spmv.bsr_matvec(blocks.to(cuda), col_blocks.to(cuda), x.to(cuda), n_out=n)
    torch.cuda.synchronize()
    assert spmv.bsr_matvec.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol * float(want.abs().max()))
    if dtype == torch.float32:
        _check_k1x_on_cuda(cuda, blocks, col_blocks, torch.randn(n, generator=g, dtype=torch.float64), n)
        if r == 3:  # a tile width whose float64 x piece needs the shared-memory opt-in, the float32 one not
            assert spmv.plan(128, 1, 8192, 8)["opt_in"] and not spmv.plan(128, 1, 8192, 4)["opt_in"]
            wide = torch.randn((64, 128, 1, 8192), generator=g)
            _check_k1x_on_cuda(cuda, wide, torch.zeros((64, 1), dtype=torch.int32),
                               torch.randn(8192, generator=g, dtype=torch.float64), 8192)
    # The complex instances on the same pattern: complex64 (and K1x's
    # complex64 tiles against a complex128 x) beside float32, complex128
    # beside float64.
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    cblocks = torch.randn((r, bm, s, bk), generator=g, dtype=ctype)
    pairs = [(ctype, tol)] + ([(torch.complex128, 1e-13)] if ctype == torch.complex64 else [])
    for xtype, ctol in pairs:
        cx = torch.randn(n, generator=g, dtype=xtype)
        want = spmv.bsr_matvec(cblocks, col_blocks, cx, n_out=n)  # CPU: plain version
        counter = spmv.bsr_matvec_c64x128 if xtype != ctype else spmv.bsr_matvec
        before = counter.launches
        args = (cblocks.to(cuda), col_blocks.to(cuda), cx.to(cuda))
        got, again = (spmv.bsr_matvec(*args, n_out=n) for _ in range(2))
        torch.cuda.synchronize()
        assert counter.launches == before + 2 and got.dtype == xtype and torch.equal(got, again)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=ctol * float(want.abs().max()))


def _check_k1x_on_cuda(cuda, blocks, col_blocks, x64, n):
    """K1x (float32 rmsk tiles, float64 x) and its rsmk twin against their
    plain versions at 1e-13 of max |y|, each repeating bit for bit, with
    their own launch counts, and the launch plan as the library makes it."""
    import ctypes

    from lanczos_tpu_torch import _build

    r, bm, s, bk = blocks.shape
    want = spmv.bsr_matvec(blocks, col_blocks, x64, n_out=n)  # CPU: plain version, float64 accumulation
    assert want.dtype == torch.float64
    before = spmv.bsr_matvec_f32x64.launches
    args = (blocks.to(cuda), col_blocks.to(cuda), x64.to(cuda))
    got, again = (spmv.bsr_matvec(*args, n_out=n) for _ in range(2))
    torch.cuda.synchronize()
    assert spmv.bsr_matvec_f32x64.launches == before + 2 and got.dtype == torch.float64
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-13 * float(want.abs().max()))
    rsmk = blocks.permute(0, 2, 1, 3).contiguous()  # the same tiles in the canonical layout
    xp = torch.nn.functional.pad(x64, (0, r * bm - n))
    want_r = spmv.bsr_matvec_rsmk(rsmk, col_blocks, xp)
    before_r, before_k2 = spmv.bsr_matvec_rsmk_f32x64.launches, spmv.bsr_matvec_rsmk.launches
    got_r, again_r = (spmv.bsr_matvec_rsmk(rsmk.to(cuda), col_blocks.to(cuda), xp.to(cuda)) for _ in range(2))
    torch.cuda.synchronize()
    assert spmv.bsr_matvec_rsmk_f32x64.launches == before_r + 2 and spmv.bsr_matvec_rsmk.launches == before_k2
    assert torch.equal(got_r, again_r)
    torch.testing.assert_close(got_r.cpu(), want_r, rtol=0, atol=1e-13 * float(want_r.abs().max()))
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().lt_bsr_spmv_info(bm, s, bk, 8, info), "lt_bsr_spmv_info")
    p = spmv.plan(bm, s, bk, 8)
    assert (p["s_piece"], p["smem"], p["opt_in"], info[3]) == (info[0], info[1], bool(info[2]), 0)


@pytest.mark.gpu
def test_kernel_refuses_unsupported_dtype_on_cuda(cuda):
    # A bfloat16 x only: K1 has complex instances and takes bfloat16 tiles
    # against a float32 or float64 x, but no engine builds a bfloat16
    # vector, so bfloat16 tiles against a bfloat16 x still raise; the
    # heading is quoted.
    blocks = torch.zeros((1, 8, 1, 8), dtype=torch.bfloat16, device=cuda)
    cb = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="K1 for complex and bfloat16 tiles"):
        spmv.bsr_matvec(blocks, cb, torch.zeros(8, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(NotImplementedError, match="K2 for complex and bfloat16 tiles"):
        spmv.bsr_matvec_rsmk(blocks.view(1, 1, 8, 8), cb, torch.zeros(8, dtype=torch.bfloat16, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("r,bm,s,bk,n", [(3, 128, 3, 128, 300), (64, 8, 5, 8, 509), (17, 16, 300, 16, 272),
                                         (4, 6, 2, 6, 24), (9, 12, 4, 12, 100), (64, 9, 5, 64, 570),
                                         (128, 16, 5, 1024, 2040), (8, 40, 5, 64, 317),
                                         (64, 17, 6, 64, 1080), (8, 24, 5, 64, 190)])
def test_bf16_kernels_match_plain_on_cuda(cuda, r, bm, s, bk, n):
    # bfloat16 tiles: K1 and K2 against a float32 x, K1x and K1x-rsmk
    # against a float64 one, each against its plain version (float32: 1e-5
    # of max |y|, float64: 1e-13), repeating bit for bit, with its own
    # launch count; bk = 6 and 12 take the scalar loop (bk % 8 != 0), n < R*bm
    # leaves a tail of padded rows unwritten.  K1 against K1 float32 over
    # the widened tiles (another order: 8 values a lane, not 4), and K1
    # against K2 bit for bit at bm = bk = 128.  K1x's own body
    # (``spmv.bf16x64_plan``, held to the library's plan here) at every
    # branch: bm = 128 with 16 lanes of 3 vectors a row (the main path's
    # plan), 9 and 40 rows against 2 rows a warp step with 40 vectors a row
    # against 16 lanes of 3 (an odd row count, a partial chunk), bk = 1024
    # and S = 300 at bk = 16 (pieces wider than one register chunk, and a
    # second, shorter piece), bm = 8 (32 lanes of 1 vector), 17 rows (32
    # lanes of 2) and 24 rows (8 lanes of 1, four rows a warp step); K1x and
    # K1x-rsmk bit for bit wherever the body runs (bk % 8 == 0).
    import ctypes

    from lanczos_tpu_torch import _build

    info = (ctypes.c_int * 8)()
    want_plan = spmv.bf16x64_plan(bm, s, bk)
    for rsmk_form in (0, 1):
        _build.check(_build.library().lt_bsr_spmv_bf16x64_info(bm, s, bk, rsmk_form, info), "lt_bsr_spmv_bf16x64_info")
        assert {"lanes_per_row": info[0], "vectors_per_lane": info[1], "s_piece": info[2], "smem": info[3],
                "opt_in": bool(info[4])} == want_plan
    g = torch.Generator().manual_seed(r * s + 1)
    blocks = torch.randn((r, bm, s, bk), generator=g).to(torch.bfloat16)
    col_blocks = torch.randint(0, (r * bm) // bk, (r, s), generator=g, dtype=torch.int32)
    rsmk = blocks.permute(0, 2, 1, 3).contiguous()
    on = (blocks.to(cuda), col_blocks.to(cuda))
    for xtype, k1, k2, tol in ((torch.float32, spmv.bsr_matvec, spmv.bsr_matvec_rsmk, 1e-5),
                               (torch.float64, spmv.bsr_matvec_bf16x64, spmv.bsr_matvec_rsmk_bf16x64, 1e-13)):
        x = torch.randn(n, generator=g, dtype=xtype)
        want = spmv.bsr_matvec(blocks, col_blocks, x, n_out=n)  # CPU: plain version
        before, by_dtype = k1.launches, spmv.bsr_matvec.launches_by_dtype[torch.bfloat16]
        got, again = (spmv.bsr_matvec(*on, x.to(cuda), n_out=n) for _ in range(2))
        torch.cuda.synchronize()
        assert k1.launches == before + 2 and got.dtype == xtype and torch.equal(got, again)
        if xtype == torch.float32:
            assert spmv.bsr_matvec.launches_by_dtype[torch.bfloat16] == by_dtype + 2
            f32 = spmv.bsr_matvec(on[0].float(), on[1], x.to(cuda), n_out=n)
            torch.testing.assert_close(got, f32, rtol=0, atol=tol * float(f32.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol * float(want.abs().max()))
        xp = torch.nn.functional.pad(x, (0, r * bm - n))
        want_r = spmv.bsr_matvec_rsmk(rsmk, col_blocks, xp, n_out=n)
        before_r = k2.launches
        got_r, again_r = (spmv.bsr_matvec_rsmk(rsmk.to(cuda), on[1], xp.to(cuda), n_out=n) for _ in range(2))
        torch.cuda.synchronize()
        assert k2.launches == before_r + 2 and got_r.dtype == xtype and torch.equal(got_r, again_r)
        torch.testing.assert_close(got_r.cpu(), want_r, rtol=0, atol=tol * float(want_r.abs().max()))
        if (bm == bk == 128 and xtype == torch.float32) or (bk % 8 == 0 and xtype == torch.float64):
            assert torch.equal(got, got_r)


# ---- the remaining operators (COO, CSR, Sum, Scaled): plain PyTorch ----------


def _chain_with_potential(n, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    d = np.arange(n)
    rows = np.concatenate([i, i + 1, d, [5, 5]])  # a duplicate entry (5, 7) in two parts
    cols = np.concatenate([i + 1, i, d, [7, 7]])
    vals = np.concatenate([-np.ones(2 * (n - 1)), rng.uniform(-1.0, 1.0, n), [0.25, 0.5]])
    rows, cols, vals = np.concatenate([rows, [7]]), np.concatenate([cols, [5]]), np.concatenate([vals, [0.75]])
    perm = rng.permutation(rows.size)  # COO entries out of row order
    return rows[perm], cols[perm], vals[perm]


def _operator_pair(kind, n, dtype=np.float64):
    """The same operator in both packages (values in ``dtype``, the port on
    the CPU)."""
    import jax.numpy as jnp
    import lanczos_tpu as lj
    import scipy.sparse as sp

    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch import convert

    rows, cols, vals = _chain_with_potential(n, seed=n)
    vals = vals.astype(dtype)
    coo_j = lj.COOOperator.from_arrays(rows, cols, vals, n)
    coo_t = convert.coo_operator_from_arrays(rows, cols, vals, n, device="cpu")
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    csr_j, csr_t = lj.CSROperator.from_scipy(mat), lt.CSROperator.from_scipy(mat, device="cpu")
    if kind == "coo":
        return coo_j, coo_t, mat.toarray()
    if kind == "csr":
        return csr_j, csr_t, mat.toarray()
    diag = np.random.default_rng(1).uniform(0.0, 2.0, n).astype(dtype)
    dia_j = lj.DIAOperator.from_diagonals([0], [jnp.asarray(diag)], n)
    dia_t = convert.dia_operator_from_arrays([0], diag[None], n, device="cpu")
    if kind == "sum":
        return lj.SumOperator((dia_j, coo_j)), lt.SumOperator((dia_t, coo_t)), np.diag(diag) + mat.toarray()
    return (lj.ScaledOperator(csr_j, -0.5, 1.25), lt.ScaledOperator(csr_t, -0.5, 1.25),
            -0.5 * mat.toarray() + 1.25 * np.eye(n))


@pytest.mark.parametrize("kinds", [("coo", "sum"), ("csr", "scaled")])
def test_sparse_operators_match_jax(kinds):
    """COO, CSR (``from_scipy``, ``to_bsr``), Sum (DIA + COO) and Scaled
    (over CSR) against the JAX package's in float64: the matvec at 1e-12
    relative, both solves of the three lowest pairs, the Gershgorin bound
    of the branch, and (COO, CSR) the dense form and the BSR packing;
    ``vector_to_string`` gives the JAX package's string; with float32
    values, ``matvec_f64`` and the ``matvec_df`` adapter against the JAX
    package's double-float ``matvec_df`` (joined in float64) at 1e-13 of
    max |y|.  Two operators an item: the file's item count fixes its place
    in pytest-xdist's loadfile queue."""
    for kind in kinds:
        _check_operator_against_jax(kind)


def _check_operator_against_jax(kind):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lanczos_tpu import LambdaLanczos as JaxLanczos
    from lanczos_tpu.utils import estimate as jest
    from lanczos_tpu.utils import stats as jstats

    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch.utils import estimate as test_
    from lanczos_tpu_torch.utils import stats as tstats

    n = 160
    op_j, op_t, dense = _operator_pair(kind, n)
    assert op_t.n == n and op_t.dtype == torch.float64 and op_t.device.type == "cpu"
    x = np.random.default_rng(2).standard_normal(n)
    y_j = np.asarray(op_j.matvec(jnp.asarray(x)))
    y_t = op_t.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12 * np.abs(y_j).max())
    np.testing.assert_allclose(y_t, dense @ x, rtol=1e-12, atol=1e-12 * np.abs(y_j).max())
    assert torch.equal(op_t.matvec(torch.from_numpy(x)), torch.from_numpy(y_t))  # a fixed sum order
    assert test_.gershgorin_bound(op_t) == pytest.approx(jest.gershgorin_bound(op_j), rel=1e-12)
    if kind in ("coo", "csr"):
        np.testing.assert_array_equal(op_t.to_dense().numpy() if kind == "coo" else dense, dense)
    if kind == "csr":
        np.testing.assert_array_equal(op_t.row_of_nnz.numpy(), np.asarray(op_j.row_of_nnz))
        bsr = op_t.to_bsr(bm=16, bk=16)
        assert isinstance(bsr, lt.BSROperator) and bsr.device.type == "cpu" and bsr.dtype == torch.float64
        np.testing.assert_allclose(bsr.matvec(torch.from_numpy(x)).numpy(), y_j, rtol=1e-12,
                                   atol=1e-12 * np.abs(y_j).max())
        assert op_t.to_bsr(bm=16, bk=16, dtype=torch.float32).dtype == torch.float32
    # The precise tier (ROADMAP item 10): the float64 product of float32
    # entries against the JAX package's double-float product.
    torch.testing.assert_close(op_t.matvec_f64(torch.from_numpy(x)), op_t.matvec(torch.from_numpy(x)), rtol=0, atol=0)
    op_j32, op_t32, _ = _operator_pair(kind, n, np.float32)
    assert op_t32.dtype == torch.float32
    x_hi = x.astype(np.float32)
    x_lo = (x - x_hi.astype(np.float64)).astype(np.float32)
    yh, yl = op_j32.matvec_df(jnp.asarray(x_hi), jnp.asarray(x_lo))
    y_df = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    x_join = torch.from_numpy(x_hi.astype(np.float64) + x_lo.astype(np.float64))
    y64 = op_t32.matvec_f64(x_join)
    assert y64.dtype == torch.float64
    bar = 1e-13 * np.abs(y_df).max()
    np.testing.assert_allclose(y64.numpy(), y_df, rtol=0, atol=bar)
    th, tl_ = op_t32.matvec_df(torch.from_numpy(x_hi), torch.from_numpy(x_lo))
    assert th.dtype == tl_.dtype == torch.float32
    np.testing.assert_allclose(th.double().numpy() + tl_.double().numpy(), y_df, rtol=0, atol=bar)

    v0 = np.random.default_rng(7).uniform(-1.0, 1.0, n)
    found = []
    for eng in (JaxLanczos(op_j, num_eigs=3), lt.LambdaLanczos(op_t, num_eigs=3)):
        eng.eps = 1e-12
        eng.tridiag_backend = "lapack"
        eng.init_vector = lambda n: v0
        vals, vecs = eng.run()
        found.append((np.asarray(vals), np.asarray(vecs)))
    (vj, Vj), (vt, Vt) = found
    np.testing.assert_allclose(vt, vj, rtol=1e-12)
    np.testing.assert_allclose(vt, np.linalg.eigvalsh(dense)[:3], rtol=1e-11)
    np.testing.assert_allclose(np.abs(np.sum(Vt * Vj, axis=1)), 1.0, atol=1e-9)
    for digits in (16, 5):
        assert tstats.vector_to_string(torch.from_numpy(vt), digits) == jstats.vector_to_string(vt, digits)
