"""Kernel K1 (BSR sparse matvec) of the PyTorch port: its plain version
against the JAX package's Pallas kernels (interpret mode) and plain einsum,
the numpy packer against the JAX packer, and — on a CUDA device — the
hand-written kernel against its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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
    want = bsr_operator_from_arrays(np.asarray(ref.blocks), np.asarray(ref.col_blocks), n, ref.layout)
    got = TorchBSR.from_coo(rows, cols, vals, n, bm=bm, bk=bk, dtype=dtype)
    assert torch.equal(got.col_blocks, want.col_blocks)
    np.testing.assert_allclose(got.blocks.numpy(), want.blocks.numpy(), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_operator_matvec_unpadded_and_ragged(dtype):
    # n not a multiple of the tile: matvec takes and returns length-n vectors.
    n = 300
    a = _random_sparse(n, 0.05, 16, dtype, seed=6)
    op = TorchBSR.from_coo(*_coo(a), n, bm=16, bk=16, dtype=dtype)
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


@pytest.mark.gpu
def test_kernel_refuses_unsupported_dtype_on_cuda(cuda):
    blocks = torch.zeros((1, 8, 1, 8), dtype=torch.bfloat16, device=cuda)
    cb = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmv.bsr_matvec(blocks, cb, torch.zeros(8, dtype=torch.bfloat16, device=cuda))
