"""bfloat16 BSR tiles in the PyTorch port against the JAX package on the CPU.

The JAX package's ``BSROperator(dtype=jnp.bfloat16)`` stores its tiles in
bfloat16 and multiplies them against float32 vectors, accumulating in
float32; no JAX engine builds a bfloat16 basis (``LambdaLanczos`` raises
"not inexact").  The port packs the same tiles (float32 packing, one
round-to-nearest-even cast), carries a JAX operator's bfloat16 arrays by
their bits and runs every engine over them with ``dtype=torch.float32``.
Bars: the tiles bit for bit without duplicates, one bfloat16 ulp with
duplicates (the two packers sum them in float32 in different orders);
products within 1e-6 of |A||x| row-wise (float32 sums in another order);
the fused solve within 1e-5 relative of the JAX package's and of
``eigh_tridiagonal`` on the rounded entries; the other engines against
that reference only (float32: 1e-5 relative; precise: 1e-11 absolute), the
Exponentiator against ``scipy.linalg.expm`` of the rounded matrix (1e-5 at
eps 1e-8) and, at its default eps, against its run over float32 tiles that
hold the rounded values (1e-6).
The card's tests of the kernels sit in ``tests/test_torch_spmv.py`` and the
2-rank world's bfloat16 solve in ``tests/test_torch_sharded.py``.
"""

import tempfile

import numpy as np
import pytest
import scipy.linalg

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import convert  # noqa: E402
from lanczos_tpu_torch.ops import spmv  # noqa: E402
from lanczos_tpu_torch.ops.operators import float64_view  # noqa: E402

N = 600  # the chain of the JAX package's bfloat16 runs
VALUES = 1e-5  # float32 engines: relative to |value|
PRECISE = 1e-11  # the precise tier: absolute, PV_MAIN_BAR


def _chain(n=N, duplicates=False):
    """The n-site hopping chain (-1 hops) with a potential from
    ``default_rng(0)``: COO triplets and the potential; with
    ``duplicates`` every diagonal entry is split into three parts, out of
    order."""
    rng = np.random.default_rng(0)
    pot = rng.random(n)
    i, d = np.arange(n - 1), np.arange(n)
    rows, cols = np.concatenate([i, i + 1, d]), np.concatenate([i + 1, i, d])
    vals = np.concatenate([-np.ones(2 * (n - 1)), pot])
    if duplicates:
        parts = rng.uniform(-1.0, 1.0, (2, n))
        rows, cols = np.concatenate([rows, d, d]), np.concatenate([cols, d, d])
        vals = np.concatenate([vals[: 2 * (n - 1)], pot - parts.sum(axis=0), parts[0], parts[1]])
        perm = rng.permutation(rows.size)
        rows, cols, vals = rows[perm], cols[perm], vals[perm]
    return rows, cols, vals, pot


def _bits(t):
    """A bfloat16 tensor's or numpy array's 16-bit words."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _widened(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t).astype(np.float32)


def _rounded_reference(pot, k=3):
    """The k lowest eigenvalues of the chain with its potential rounded to
    bfloat16 (the hops are exact), in float64."""
    d = torch.tensor(pot, dtype=torch.float32).to(torch.bfloat16).double().numpy()
    return scipy.linalg.eigh_tridiagonal(d, -np.ones(d.size - 1), select="i", select_range=(0, k - 1))[0], d


def _port_op(bm=8, bk=8):
    rows, cols, vals, pot = _chain()
    return tl.BSROperator.from_coo(rows, cols, vals, N, bm=bm, bk=bk, dtype=torch.bfloat16, device="cpu"), pot


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("bm,bk", [(8, 8), (128, 128), (6, 4)])
def test_packing_matches_jax_packer(duplicates, bm, bk):
    import jax.numpy as jnp
    import lanczos_tpu as lj

    rows, cols, vals, _ = _chain(duplicates=duplicates)
    jop = lj.BSROperator.from_coo(rows, cols, vals, N, bm=bm, bk=bk, dtype=jnp.bfloat16)
    top = tl.BSROperator.from_coo(rows, cols, vals, N, bm=bm, bk=bk, dtype=torch.bfloat16, device="cpu")
    assert jop.layout == "rsmk" and top.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jop.col_blocks), top.col_blocks.numpy())
    want = np.moveaxis(np.asarray(jop.blocks), 2, 1)  # the port stores rmsk
    if not duplicates:
        np.testing.assert_array_equal(_bits(want), _bits(top.blocks))
    else:
        a, b = _widened(want), _widened(top.blocks)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0**16  # float32's spacing, 16 bits shorter
        assert np.all(np.abs(a - b) <= ulp)
    # The JAX operator's arrays carried across: the same bits.
    carried = convert.bsr_operator_from_arrays(jop.blocks, jop.col_blocks, N, jop.layout, device="cpu")
    assert carried.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(carried.blocks), _bits(want))
    # Row sums (the Gershgorin bound's) accumulate in float32.
    sums = top.abs_row_sums()
    assert sums.dtype == torch.float32
    np.testing.assert_allclose(sums.numpy(), np.abs(_widened(top.blocks)).sum(axis=(2, 3)).reshape(-1)[:N], rtol=1e-6)


def test_matvec_matches_jax_reference():
    import jax.numpy as jnp
    import lanczos_tpu as lj
    from lanczos_tpu.ops import pallas_spmv

    rows, cols, vals, _ = _chain(duplicates=True)
    jop = lj.BSROperator.from_coo(rows, cols, vals, N, bm=8, bk=8, dtype=jnp.bfloat16)
    top = convert.bsr_operator_from_arrays(jop.blocks, jop.col_blocks, N, jop.layout, device="cpu")
    x = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    xp = np.pad(x, (0, jop.n_padded - N))
    want = np.asarray(pallas_spmv.bsr_matvec_reference(jop.blocks, jop.col_blocks, jnp.asarray(xp),
                                                       layout=jop.layout))[:N]
    assert want.dtype == np.float32
    got = top.matvec(torch.from_numpy(x))
    assert got.dtype == torch.float32
    scale = spmv.bsr_matvec_reference(top.blocks.abs(), top.col_blocks, torch.from_numpy(np.abs(xp)),
                                      layout="rmsk")[:N].numpy()
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * scale)
    # The precise product: the widened tiles against a float64 x, in float64.
    dense = np.zeros((jop.n_padded, jop.n_padded))
    blocks = _widened(top.blocks).astype(np.float64)
    for r in range(blocks.shape[0]):
        for s in range(blocks.shape[2]):
            c = int(top.col_blocks[r, s])
            dense[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += blocks[r, :, s, :]
    x64 = np.random.default_rng(6).standard_normal(N)
    got64 = float64_view(top).matvec(torch.from_numpy(x64))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), (dense[:N, :N] @ x64), rtol=0, atol=1e-13 * np.abs(dense).sum())


def test_fused_solve_matches_jax():
    import jax.numpy as jnp
    import lanczos_tpu as lj

    rows, cols, vals, pot = _chain()
    ref, _ = _rounded_reference(pot)
    jop = lj.BSROperator.from_coo(rows, cols, vals, N, bm=8, bk=8, dtype=jnp.bfloat16)
    top = convert.bsr_operator_from_arrays(jop.blocks, jop.col_blocks, N, jop.layout, device="cpu")
    got = {}
    for name, eng in (("jax", lj.LambdaLanczos(jop, num_eigs=3, dtype=jnp.float32, mode="fused")),
                      ("port", tl.LambdaLanczos(top, num_eigs=3, dtype=torch.float32, mode="fused"))):
        eng.eps = 1e-6
        vals_, vecs = eng.run()
        got[name] = np.sort(np.asarray(vals_))
        assert np.asarray(vecs).shape == (3, N) and np.asarray(vecs).dtype == np.float32
    np.testing.assert_allclose(got["port"], got["jax"], rtol=VALUES)
    for v in got.values():
        np.testing.assert_allclose(v, ref, rtol=VALUES)


@pytest.mark.parametrize("engine", ["hybrid", "thick", "precise"])
def test_engines_match_rounded_reference(engine):
    op, pot = _port_op()
    ref, _ = _rounded_reference(pot)
    eng = tl.LambdaLanczos(op, num_eigs=3, dtype=torch.float32, mode="hybrid" if engine == "hybrid" else "auto")
    eng.eps = 1e-6  # the thick engine's default 1.2e-4 is too loose to test the values
    if engine == "thick":
        eng.restart_policy = "thick"
    if engine == "precise":
        eng.precise_vectors = True
        eng.eps = 1e-12
    k1x = spmv.bsr_matvec_bf16x64.launches
    vals_, vecs = eng.run()
    assert spmv.bsr_matvec_bf16x64.launches == k1x  # CPU tensors: the plain version
    assert vecs.shape == (3, N) and vecs.dtype == torch.float32
    if engine == "precise":
        np.testing.assert_allclose(np.sort(vals_), ref, rtol=0, atol=PRECISE)
    else:
        np.testing.assert_allclose(np.sort(vals_), ref, rtol=VALUES)


def test_exponentiator_matches_expm():
    op, pot = _port_op()
    _, d = _rounded_reference(pot)
    a = np.diag(d) - np.eye(N, k=1) - np.eye(N, k=-1)
    v = np.random.default_rng(7).standard_normal(N)
    v /= np.linalg.norm(v)
    want = scipy.linalg.expm(-0.5 * a) @ v
    v32 = torch.from_numpy(v).float()
    # At its default float32 eps (1.2e-5) the build stops after 5 steps, 3.9e-4
    # from expm for any float32 operator: the run over bfloat16 tiles is
    # held to the run over float32 tiles that hold the same rounded values,
    # and a run at eps 1e-8 to expm.
    rows, cols, _, _ = _chain()
    op32 = tl.BSROperator.from_coo(rows, cols, np.concatenate([-np.ones(2 * (N - 1)), d]), N, bm=8, bk=8,
                                   dtype=torch.float32, device="cpu")
    out, iters = tl.Exponentiator(op, dtype=torch.float32).run(-0.5, v32)
    out32, iters32 = tl.Exponentiator(op32).run(-0.5, v32)
    assert out.dtype == torch.float32 and iters == iters32
    assert np.linalg.norm(out.numpy() - out32.numpy()) <= 1e-6 * np.linalg.norm(want)
    ex = tl.Exponentiator(op, dtype=torch.float32)
    ex.eps = 1e-8
    out, _ = ex.run(-0.5, v32)
    assert np.linalg.norm(out.numpy() - want) <= 1e-5 * np.linalg.norm(want)


def test_bfloat16_vectors_raise():
    op, _ = _port_op()
    for make in (lambda: tl.LambdaLanczos(op), lambda: tl.LambdaLanczos(op, dtype=torch.bfloat16),
                 lambda: tl.Exponentiator(op)):
        with pytest.raises(ValueError, match="storage dtype"):
            make()
    with pytest.raises(TypeError, match="complex values"):
        tl.BSROperator.from_coo([0], [0], [1j], 4, bm=2, bk=2, dtype=torch.bfloat16, device="cpu")


def test_sharded_packing_matches_jax_one_rank():
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist
    from lanczos_tpu.parallel import mesh as jmesh
    from lanczos_tpu.parallel.sharded import ShardedBSROperator as JaxSharded

    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    rows, cols, vals, _ = _chain()
    jop = JaxSharded.from_coo(rows, cols, vals, N, jmesh.make_mesh(jax.devices()[:1]), bm=8, bk=8, dtype=jnp.bfloat16)
    one, _ = _port_op()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(N).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.initialize_distributed(backend="gloo", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            mesh = pmesh.make_mesh()
            packed = ShardedBSROperator.from_coo(rows, cols, vals, N, mesh, bm=8, bk=8, dtype=torch.bfloat16)
            carried = convert.sharded_bsr_operator_from_arrays(jop.blocks, jop.col_blocks, N, mesh)
            for op in (packed, carried):
                assert op.blocks.dtype == torch.bfloat16 and op.abs_row_sums().dtype == torch.float32
                np.testing.assert_array_equal(_bits(op.blocks), _bits(jop.blocks))
                y = op.gather(op.matvec(op.scatter(x)))
                assert y.dtype == torch.float32
                want = one.matvec(x).numpy()  # the rmsk plain version: another order
                np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        finally:
            dist.destroy_process_group()
