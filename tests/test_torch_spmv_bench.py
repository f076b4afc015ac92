"""The SpMV study of the PyTorch port (``lanczos_tpu_torch.experiments.spmv_bench``,
kernel E1's three variants): the plain versions against the JAX package's
study script ``experiments/pallas_spmv_bench.py`` (run as it stands, with
the Pallas interpreter) and against a float64 dense product, the study's
fault R6 (the Pallas grid leaves the last R mod G row blocks unwritten)
pinned, and — on a CUDA device — each kernel against its plain version."""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from lanczos_tpu_torch.experiments import spmv_bench  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
S, BM, BK = 3, 16, 8
F32_TOL = 1e-6  # relative to max |y|: float32 rounding of S*bk = 24-term sums
F64_TOL = 1e-12
VARIANTS = ["v2", "v2vpu", "v3"]


@pytest.fixture(scope="module")
def jax_study():
    """The JAX study module with ``pallas_call`` in interpret mode for this
    module's tests; the compile-cache settings an import of the JAX package
    may change are put back."""
    jax = pytest.importorskip("jax")
    from jax.experimental import pallas

    settings = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {name: getattr(jax.config, name) for name in settings}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO))
        mp.setattr(pallas, "pallas_call", functools.partial(pallas.pallas_call, interpret=True))
        try:
            from experiments import pallas_spmv_bench as study
        finally:
            for name, value in saved.items():
                jax.config.update(name, value)
        yield study


def _port(variant, blocks, blocks_t, cb, x, G):
    """The port's wrapper for ``variant`` on numpy operands (CPU tensors,
    so the plain version)."""
    b, bt, c, v = (torch.from_numpy(a) for a in (blocks, blocks_t, cb, x))
    if variant == "v3":
        return spmv_bench.spmv_v3(bt, c, v, G=G).numpy()
    return spmv_bench.spmv_v2(b, c, v, G=G, vpu=variant == "v2vpu").numpy()


def _jax(study, variant, blocks, blocks_t, cb, x, G):
    jnp = pytest.importorskip("jax").numpy
    if variant == "v3":
        return np.asarray(study.spmv_v3(jnp.asarray(blocks_t), jnp.asarray(cb), jnp.asarray(x), G=G))
    return np.asarray(study.spmv_v2(jnp.asarray(blocks), jnp.asarray(cb), jnp.asarray(x), G=G,
                                    vpu=variant == "v2vpu"))


def _dense64(blocks, cb, x):
    """y = A x in float64 from the (R, S, bm, bk) tiles, through the dense
    matrix the tiles pack (duplicate column blocks add)."""
    r, s, bm, bk = blocks.shape
    a = np.zeros((r * bm, x.shape[0]))
    for i in range(r):
        for j in range(s):
            a[i * bm : (i + 1) * bm, cb[i, j] * bk : (cb[i, j] + 1) * bk] += blocks[i, j]
    return a @ x.astype(np.float64)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_jax_study_interpret(jax_study, variant):
    blocks, blocks_t, cb, x = spmv_bench.make_data(16, S, BM, BK, seed=1)
    want = _jax(jax_study, variant, blocks, blocks_t, cb, x, 8)
    got = _port(variant, blocks, blocks_t, cb, x, 8)
    assert got.dtype == np.float32 and got.shape == (16 * BM,)
    assert _rel(got, want.astype(np.float64)) <= F32_TOL
    assert _rel(got, _dense64(blocks, cb, x)) <= F32_TOL


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("r, G, s, bm, bk", [(16, 8, 3, 16, 8), (12, 8, 3, 16, 8), (12, 5, 5, 8, 6), (9, 16, 2, 4, 12),
                                              (1, 1, 1, 1, 1)])
def test_plain_float64_matches_dense(variant, r, G, s, bm, bk):
    blocks, blocks_t, cb, x = spmv_bench.make_data(r, s, bm, bk, seed=r + s, dtype=np.float64)
    got = _port(variant, blocks, blocks_t, cb, x, G)
    assert got.dtype == np.float64
    assert _rel(got, _dense64(blocks, cb, x)) <= F64_TOL


def test_r6_jax_grid_leaves_the_tail_and_the_port_writes_it(jax_study):
    """R6, a fault of the reference: with R = 12 and G = 8 the Pallas grid
    has 12 // 8 = 1 step, so row blocks 8..11 are never written and read
    back non-finite through the interpreter.  The port's variants write
    every row block."""
    r, G = 12, 8
    blocks, blocks_t, cb, x = spmv_bench.make_data(r, S, BM, BK, seed=2)
    want = _dense64(blocks, cb, x)
    for variant in VARIANTS:
        jax_y = _jax(jax_study, variant, blocks, blocks_t, cb, x, G)
        head = (r // G) * G * BM
        assert _rel(jax_y[:head], want[:head]) <= F32_TOL, variant
        assert not np.isfinite(jax_y[head:]).any(), variant
        assert _rel(_port(variant, blocks, blocks_t, cb, x, G), want) <= F32_TOL, variant


def test_check_lines_on_the_cpu():
    lines = spmv_bench.check(r=16, s=S, bm=BM, bk=BK, G=8, device="cpu")
    assert [line.split(":")[0] for line in lines] == [f"{v} R={r} G=8" for r in (16, 20) for v in VARIANTS]
    for line in lines:
        assert float(line.rsplit("=", 1)[1]) <= F32_TOL, line


def test_wrappers_validate_and_count_no_cpu_launches():
    blocks, blocks_t, cb, x = (torch.from_numpy(a) for a in spmv_bench.make_data(4, S, BM, BK))
    before = (spmv_bench.spmv_v2.launches, spmv_bench.spmv_v2.vpu_launches, spmv_bench.spmv_v3.launches)
    spmv_bench.spmv_v2(blocks, cb, x, G=3, vpu=True)
    spmv_bench.spmv_v3(blocks_t, cb, x, G=3)
    assert (spmv_bench.spmv_v2.launches, spmv_bench.spmv_v2.vpu_launches, spmv_bench.spmv_v3.launches) == before
    with pytest.raises(ValueError, match="G"):
        spmv_bench.spmv_v2(blocks, cb, x, G=0)
    with pytest.raises(ValueError, match="col_blocks"):
        spmv_bench.spmv_v3(blocks_t, cb[:, :2], x)
    with pytest.raises(ValueError, match="width"):
        spmv_bench.spmv_v2(blocks, cb, x[:-1])
    with pytest.raises(ValueError, match="4-d"):
        spmv_bench.spmv_v3(blocks_t[0], cb, x)


def test_main_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        spmv_bench.main(device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            spmv_bench.check(r=8, s=1, bm=4, bk=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_on_cuda(cuda, variant):
    gen = torch.Generator(device=cuda).manual_seed(0)
    # The last two cases gather x in pieces in the VPU form (one tile row's
    # segment is over its 32 KB piece budget), the last with bk not a
    # multiple of the vector width.
    cases = [(torch.float32, 516, 8, 128, 128, 8, 1e-5), (torch.float32, 37, 5, 16, 6, 4, 1e-5),
             (torch.float32, 3, 2, 8, 8, 8, 1e-5), (torch.float64, 61, 5, 16, 6, 8, 1e-12),
             (torch.float64, 64, 8, 128, 128, 8, 1e-12), (torch.float64, 5, 3, 8, 4100, 8, 1e-12),
             (torch.float32, 4, 3, 8, 8201, 8, 1e-5)]
    for dtype, r, s, bm, bk, G, tol in cases:
        blocks = torch.randn((r, s, bm, bk), generator=gen, device=cuda, dtype=dtype)
        blocks_t = blocks.permute(0, 2, 1, 3).contiguous()
        c_rows = max(r * bm // bk, 1)
        cb = torch.randint(0, c_rows, (r, s), generator=gen, device=cuda, dtype=torch.int32)
        x = torch.randn(c_rows * bk, generator=gen, device=cuda, dtype=dtype)
        if variant == "v3":
            fn, ref, tiles, kw, counter = spmv_bench.spmv_v3, spmv_bench.spmv_v3_reference, blocks_t, {}, "launches"
        else:
            vpu = variant == "v2vpu"
            fn, ref, tiles, kw = spmv_bench.spmv_v2, spmv_bench.spmv_v2_reference, blocks, {"vpu": vpu}
            counter = "vpu_launches" if vpu else "launches"
        # col_blocks outside the x table read zeros: the plain version
        # reads them from a table padded with zero rows.
        cb_out = cb.clone()
        cb_out[::3, -1] = c_rows + 2
        x_pad = torch.cat([x, x.new_zeros(3 * bk)])
        for c, x_ref in ((cb, x), (cb_out, x_pad)):
            before = getattr(fn, counter)
            got = fn(tiles, c, x, G=G, **kw)
            again = fn(tiles, c, x, G=G, **kw)
            want = ref(tiles, c, x_ref, G=G, **kw)
            torch.cuda.synchronize()
            assert getattr(fn, counter) == before + 2
            rel = float((got.double() - want.double()).abs().max() / want.double().abs().max())
            assert rel <= tol, (dtype, r, s, bm, bk, G, rel)
            assert torch.equal(got, again), (dtype, r, s, bm, bk, G)
    if variant == "v2vpu":
        _vpu_form_rounds_each_product(cuda)


def _vpu_form_rounds_each_product(cuda):
    """The rounding trap: on tiles whose rows cancel
    (``make_cancelling_data``), the VPU form keeps the plain version's
    separately rounded products, the same bits on repeat, while the dot
    form's FMA chain, which a VPU form with contracted products would
    become, misses them by far more than the tolerance."""
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        blocks, _, cb, x = (torch.from_numpy(a).to(cuda) for a in spmv_bench.make_cancelling_data(dtype=dtype))
        want = spmv_bench.spmv_v2_reference(blocks, cb, x, vpu=True).double()
        got = spmv_bench.spmv_v2(blocks, cb, x, vpu=True)
        again = spmv_bench.spmv_v2(blocks, cb, x, vpu=True)
        dot = spmv_bench.spmv_v2(blocks, cb, x)
        torch.cuda.synchronize()
        scale = want.abs().max()
        assert float((got.double() - want).abs().max() / scale) <= tol, dtype
        assert torch.equal(got, again), dtype
        assert float((dot.double() - want).abs().max() / scale) > 100 * tol, dtype
