"""The kernel studies of the PyTorch port (``lanczos_tpu_torch.experiments``):
the CGS-pass variants E2a-c and the in-place row write E3, their plain
versions against the JAX package's study scripts in ``experiments/`` (run
as they stand, with the Pallas interpreter) and against numpy float64,
the studies' check lines against the scripts' correctness sections, and —
on a CUDA device — each kernel against its plain version."""

import functools
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from lanczos_tpu_torch.experiments import (  # noqa: E402
    _cgs_variants,
    _timing,
    bcgs_k2_tiny,
    bcgs_kernel,
    bcgs_kernel2,
    bcgs_kernel3,
    carry_copy_bench,
)

REPO = Path(__file__).resolve().parents[1]
CAP, N = 130, 4096
F32_TOL = 1e-6  # relative to max |v|: float32 rounding of a pass at n = 4096
F64_TOL = 1e-12


@pytest.fixture(scope="module")
def jax_studies():
    """The JAX study modules, with ``pallas_call`` in interpret mode for
    this module's tests.  Importing them enables the JAX package's
    persistent compilation cache; the two settings it changes are put
    back, so the rest of the worker compiles as before."""
    jax = pytest.importorskip("jax")
    from jax.experimental import pallas

    settings = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {name: getattr(jax.config, name) for name in settings}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO))
        mp.setattr(pallas, "pallas_call", functools.partial(pallas.pallas_call, interpret=True))
        try:
            from experiments import carry_copy_bench as cc
            from experiments import pallas_bcgs_kernel as v1
            from experiments import pallas_bcgs_kernel2 as v2
            from experiments import pallas_bcgs_kernel3 as v3
        finally:
            for name, value in saved.items():
                jax.config.update(name, value)
        yield SimpleNamespace(jnp=jax.numpy, v1=v1, v2=v2, v3=v3, cc=cc)


def _data(cap, n, dtype, seed, strong=True):
    """Unit rows and a vector from ``default_rng(seed)``; with ``strong``
    the vector carries 100 times the sum of the first eight rows."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((cap, n))
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    v = rng.standard_normal(n)
    if strong:
        v += basis[:8].sum(axis=0) * 100.0
    return basis.astype(dtype), v.astype(dtype)


def _cgs64(basis, v, k):
    b, vv = basis.astype(np.float64), v.astype(np.float64)
    return vv - (b[:k] @ vv) @ b[:k]


def _mgs64(basis, v, k, chunk):
    b, w = basis.astype(np.float64), v.astype(np.float64)
    for c0 in range(0, k, chunk):
        rows = b[c0 : min(c0 + chunk, k)]
        w = w - (rows @ w) @ rows
    return w


def _dist(a, b, v):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / np.abs(v).max()


@pytest.mark.parametrize("k", [3, 64, 128])
def test_e2b_plain_matches_jax_v2_and_float64_cgs(jax_studies, k):
    jnp = jax_studies.jnp
    basis, v = _data(CAP, N, np.float32, seed=k)
    want = np.asarray(jax_studies.v2.make_pass(64, 2048, CAP)(jnp.asarray(v), jnp.asarray(basis), k))
    got = bcgs_kernel2.cgs_single_pass(torch.from_numpy(v), torch.from_numpy(basis), k).numpy()
    assert _dist(got, want, v) <= F32_TOL
    assert _dist(got, _cgs64(basis, v, k), v) <= F32_TOL
    assert _dist(want, _cgs64(basis, v, k), v) <= F32_TOL


def test_e2b_plain_float64_matches_numpy():
    basis, v = _data(CAP, N, np.float64, seed=5)
    for k in (0, 1, 64, 129, CAP):
        got = bcgs_kernel2.cgs_single_pass(torch.from_numpy(v), torch.from_numpy(basis), k).numpy()
        assert _dist(got, _cgs64(basis, v, k), v) <= F64_TOL, k


@pytest.mark.parametrize("k", [3, 100])
def test_e2c_shadow_bits_and_plain_match_jax_v3(jax_studies, k):
    jnp = jax_studies.jnp
    basis, v = _data(CAP, N, np.float32, seed=20 + k)
    shadow = bcgs_kernel3.make_shadow(torch.from_numpy(basis))
    jax_shadow = jnp.asarray(basis).astype(jnp.bfloat16)
    np.testing.assert_array_equal(shadow.view(torch.int16).numpy(), np.asarray(jax_shadow).view(np.int16))
    want = np.asarray(jax_studies.v3.make_pass(64, 2048, CAP)(jnp.asarray(v), jax_shadow, jnp.asarray(basis), k))
    got = bcgs_kernel3.cgs_shadow_pass(torch.from_numpy(v), shadow, torch.from_numpy(basis), k).numpy()
    assert _dist(got, want, v) <= F32_TOL


@pytest.mark.parametrize("chunk", [32, 64])
def test_e2a_plain_matches_float64_block_mgs(jax_studies, chunk):
    jnp = jax_studies.jnp
    basis, v = _data(CAP, N, np.float32, seed=chunk)
    one_pass = jax_studies.v1.make_pass(chunk, 2048)
    for k in (3, 50, 64, 67, 128):
        got = bcgs_kernel.bcgs_mgs_pass(torch.from_numpy(v), torch.from_numpy(basis), k, chunk).numpy()
        assert _dist(got, _mgs64(basis, v, k, chunk), v) <= F32_TOL, k
        if k <= chunk:  # one chunk: where the Pallas kernel computes block MGS
            want = np.asarray(one_pass(jnp.asarray(v), jnp.asarray(basis), k))
            assert _dist(got, want, v) <= F32_TOL, k


def test_jax_v1_interpret_projects_only_the_last_chunk(jax_studies):
    """A fact about the reference, not the port: once k > chunk, the JAX
    study's v1 kernel run through the Pallas interpreter returns v minus
    the last chunk's projection alone, measured against the original v
    (every chunk's phase 0 copies the original v into the aliased output).
    The port computes block MGS, as the study's docstring says v1 does."""
    jnp = jax_studies.jnp
    basis, v = _data(CAP, N, np.float32, seed=7, strong=False)
    for chunk, k in ((32, 50), (64, 67), (64, 128)):
        c0 = (k - 1) // chunk * chunk
        last_only = _cgs64(basis[c0:], v, k - c0)
        jax_v1 = np.asarray(jax_studies.v1.make_pass(chunk, 2048)(jnp.asarray(v), jnp.asarray(basis), k))
        port = bcgs_kernel.bcgs_mgs_pass(torch.from_numpy(v), torch.from_numpy(basis), k, chunk).numpy()
        assert _dist(jax_v1, last_only, v) <= F32_TOL
        assert _dist(port, last_only, v) > 1e-3
        assert _dist(port, _mgs64(basis, v, k, chunk), v) <= F32_TOL


def test_e3_plain_matches_row_set_pallas(jax_studies):
    jnp = jax_studies.jnp
    rng = np.random.default_rng(3)
    cap1 = 96
    buf = rng.standard_normal((cap1, N)).astype(np.float32)
    w = rng.standard_normal(N).astype(np.float32)
    for k in (0, 37, cap1 - 1):
        want = np.asarray(jax_studies.cc.row_set_pallas(jnp.asarray(buf), jnp.asarray(k, jnp.int32), jnp.asarray(w)))
        out = torch.from_numpy(buf.copy())
        got = carry_copy_bench.row_set(out, torch.tensor([k], dtype=torch.int32), torch.from_numpy(w))
        assert got is out
        np.testing.assert_array_equal(got.numpy(), want)


def test_e3_out_of_range_k_writes_nothing_and_bad_k_raises():
    rng = np.random.default_rng(4)
    buf = torch.from_numpy(rng.standard_normal((16, 256)))
    w = torch.from_numpy(rng.standard_normal(256))
    launches = carry_copy_bench.row_set.launches
    for k in (-1, 16, 1000):
        out = carry_copy_bench.row_set(buf.clone(), torch.tensor([k], dtype=torch.int32), w)
        assert torch.equal(out, buf), k
    # The CPU route is the plain version's bits, in float32 and float64.
    for b, ww in ((buf, w), (buf.float(), w.float())):
        for k in (0, 15, -1, 16):
            kt = torch.tensor([k], dtype=torch.int32)
            out = b.clone()
            assert carry_copy_bench.row_set(out, kt, ww) is out
            assert torch.equal(out, carry_copy_bench.row_set_reference(b.clone(), kt, ww)), (b.dtype, k)
    assert carry_copy_bench.row_set.launches == launches  # the CPU takes the plain version
    with pytest.raises(ValueError):
        carry_copy_bench.row_set(buf.clone(), torch.tensor([1]), w)  # int64
    with pytest.raises(ValueError):
        carry_copy_bench.row_set(buf.clone(), torch.tensor(1, dtype=torch.int32), w)  # not one element
    # The wrapper's other refusals: w's shape, mixed devices, a device that
    # is neither CPU nor CUDA, and (before the library is built or loaded)
    # a dtype the kernel does not take.
    k = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="w"):
        carry_copy_bench.row_set(buf.clone(), k, w[:-1])
    with pytest.raises(ValueError, match="one device"):
        carry_copy_bench.row_set(buf.clone(), k.to("meta"), w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        carry_copy_bench.row_set(buf.to("meta"), k.to("meta"), w.to("meta"))
    for dtypes in ((torch.float16, torch.float16), (torch.float32, torch.float64)):
        with pytest.raises(NotImplementedError, match="float32/float64"):
            carry_copy_bench._row_set_fn(*dtypes)


def _lines(lines, pattern):
    """{label: numbers} of each line, the label being what precedes ':'."""
    out = {}
    for line in lines:
        label, rest = line.split(":", 1)
        out[label] = [float(x) for x in re.findall(pattern, rest)]
    return out


_NUM = r"[0-9.]+e[+-][0-9]+"


def _jax_v1_section(st, basis, v):
    # experiments/pallas_bcgs_kernel.py main(), the correctness section, at this size.
    from lanczos_tpu.core import linalg

    jnp = st.jnp
    b, vv = jnp.asarray(basis), jnp.asarray(v)
    lines = []
    for chunk, bn in [(64, 2048)]:
        pallas_pass = st.v1.make_pass(chunk, bn)
        for k in (3, 64, 100, 256):
            ref = linalg.orthogonalize_bcgs_dyn(vv, b, k, passes=1, chunk=chunk)
            got = pallas_pass(vv, b, k)
            err = float(jnp.max(jnp.abs(ref - got)) / jnp.max(jnp.abs(ref)))
            lines.append(f"chunk={chunk} bn={bn} k={k}: rel err vs XLA = {err:.2e}")
    return lines


def _jax_v2_section(st, basis, v):
    # experiments/pallas_bcgs_kernel2.py main(), the correctness section at
    # HIGHEST precision (DEFAULT is the TPU's bf16 MXU, which the port lacks).
    from lanczos_tpu.core import linalg

    jnp = st.jnp
    b, vv = jnp.asarray(basis), jnp.asarray(v)
    vmax = float(jnp.max(jnp.abs(vv)))
    p = st.v2.make_pass(64, 2048, basis.shape[0], st.v2.HIGH)
    lines = []
    for k in (3, 100, 256):
        got = p(vv, b, k)
        ref = linalg.orthogonalize_bcgs_dyn(vv, b, jnp.asarray(k, jnp.int32), passes=1)
        lines.append(f"prec=HIGH k={k}: rel err vs XLA chunk loop = {float(jnp.max(jnp.abs(got - ref))) / vmax:.2e}")
    return lines


def _jax_v3_section(st, basis, v):
    # experiments/pallas_bcgs_kernel3.py main(), the correctness section.
    from lanczos_tpu.core import linalg

    jnp = st.jnp
    b, vv = jnp.asarray(basis), jnp.asarray(v)

    def overlap(w, k):
        c = jnp.max(jnp.abs(jnp.matmul(b[:k], w, precision=st.v3.HIGH)))
        return float(c / jnp.linalg.norm(w))

    p = st.v3.make_pass(64, 2048, basis.shape[0])
    lines = []
    for k in (3, 100, 256):
        got = p(vv, b.astype(jnp.bfloat16), b, k)
        ref = linalg.orthogonalize_bcgs_dyn(vv, b, jnp.asarray(k, jnp.int32), passes=1, use_pallas=True)
        lines.append(f"k={k}: overlap after v3 pass = {overlap(got, k):.2e}  after f32 pass = {overlap(ref, k):.2e}")
    return lines


@pytest.mark.parametrize("study", ["bcgs_kernel", "bcgs_kernel2", "bcgs_kernel3"])
def test_check_lines_match_jax_correctness_section(jax_studies, study):
    # The scripts' own data rule (make_data) at n = 4096; cap 257 as the
    # scripts use it, so their live counts up to 256 apply.
    cap, n = 257, N
    port_study = {"bcgs_kernel": bcgs_kernel, "bcgs_kernel2": bcgs_kernel2, "bcgs_kernel3": bcgs_kernel3}[study]
    port = _lines(port_study.check(n=n, cap=cap, device="cpu"), _NUM)
    basis, v = _cgs_variants.make_data(cap, n, strong=study != "bcgs_kernel")
    section = {"bcgs_kernel": _jax_v1_section, "bcgs_kernel2": _jax_v2_section, "bcgs_kernel3": _jax_v3_section}[study]
    jax_lines = _lines(section(jax_studies, basis, v), _NUM)
    assert list(port) == list(jax_lines)  # the same cases, in the same order
    for label, nums in port.items():
        if study == "bcgs_kernel":
            k, chunk = int(label.rsplit("k=", 1)[1]), 64
            vs_cgs, vs_plain = nums
            assert vs_plain == 0.0  # the CPU check runs the plain version
            want = np.abs(_mgs64(basis, v, k, chunk) - _cgs64(basis, v, k)).max() / np.abs(_cgs64(basis, v, k)).max()
            assert vs_cgs == pytest.approx(want, rel=2e-2, abs=1e-6)  # block MGS against classical GS
            if k <= chunk:  # one chunk, where the Pallas kernel computes block MGS
                assert jax_lines[label][0] <= F32_TOL
        elif study == "bcgs_kernel2":
            assert nums[0] <= F32_TOL and jax_lines[label][0] <= F32_TOL
        else:
            np.testing.assert_allclose(nums, jax_lines[label], rtol=2e-2)


def test_k2_tiny_probe_matches_jax_v2(jax_studies):
    jnp = jax_studies.jnp
    n, cap, k = N, 257, 100
    got = bcgs_k2_tiny.probe(device="cpu", n=n, cap=cap, k=k)["rel_err_vs_f64_cgs"]
    # pallas_bcgs_k2_tiny.py's own inputs at n = 4096, through the JAX v2 kernel
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((cap, n)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    v = rng.standard_normal(n).astype(np.float32)
    v += basis[:8].sum(axis=0) * 100.0
    jax_got = np.asarray(jax_studies.v2.make_pass(64, 2048, cap)(jnp.asarray(v), jnp.asarray(basis), k))
    assert got <= F32_TOL
    assert _dist(jax_got, _cgs64(basis, v, k), v) <= F32_TOL


def test_timed_entry_points_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        _timing.marginal(lambda r: None, 1, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        carry_copy_bench.run_variant("A", 16, 128, device="cpu")
    for study in (bcgs_kernel, bcgs_kernel2, bcgs_kernel3, bcgs_k2_tiny, carry_copy_bench):
        with pytest.raises(RuntimeError, match="CUDA"):
            study.main(device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            bcgs_kernel2.check(n=64, cap=8)
        with pytest.raises(RuntimeError, match="CUDA"):
            bcgs_k2_tiny.probe(n=64, cap=8, k=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["e2a", "e2b", "e2c", "e3"])
def test_kernel_matches_plain_on_cuda(cuda, kernel):
    gen = torch.Generator(device=cuda).manual_seed(0)
    if kernel == "e3":
        buf = torch.randn((64, 70001), generator=gen, device=cuda)
        w = torch.randn(70001, generator=gen, device=cuda)
        for k in (0, 63, 64, -1):
            kt = torch.tensor([k], dtype=torch.int32, device=cuda)
            before = carry_copy_bench.row_set.launches
            got = carry_copy_bench.row_set(buf.clone(), kt, w)
            assert carry_copy_bench.row_set.launches == before + 1
            assert torch.equal(got, carry_copy_bench.row_set_reference(buf.clone(), kt, w))
        _e3_in_graph_matches_plain(cuda, gen)
        return
    for dtype, n, tol in ((torch.float32, 70001, 1e-5), (torch.float32, 65536, 1e-5), (torch.float64, 9000, 1e-12)):
        if kernel == "e2c" and dtype == torch.float64:
            continue
        basis = torch.randn((70, n), generator=gen, device=cuda, dtype=dtype)
        basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
        v = torch.randn(n, generator=gen, device=cuda, dtype=dtype)
        shadow = bcgs_kernel3.make_shadow(basis)
        if kernel == "e2b":
            _e2b_matches_plain_on_both_routes(gen, dtype, n, tol)
        for k in (1, 31, 32, 33, 70):
            if kernel == "e2a":
                _e2a_matches_plain_on_both_routes(v, basis, k, tol)
                continue
            if kernel == "e2b":
                cases = [(bcgs_kernel2.cgs_single_pass, bcgs_kernel2.cgs_single_pass_reference, (basis, k))]
            else:
                cases = [(bcgs_kernel3.cgs_shadow_pass, bcgs_kernel3.cgs_shadow_pass_reference, (shadow, basis, k))]
            for fn, ref, args in cases:
                got = fn(v.clone(), *args)
                want = ref(v, *args)
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                assert rel <= tol, (dtype, n, k, args[-1], rel)


def _e2a_matches_plain_on_both_routes(v, basis, k, tol):
    """E2a on both routes for v at chunks 1, 8, 32 and k: within ``tol`` of
    the plain version, the same bits on repeat, each pass one counted
    launch."""
    n = basis.shape[1]
    for route in _cgs_variants.ROUTES:
        for chunk in (1, 8, 32, k):
            before = bcgs_kernel.bcgs_mgs_pass.launches
            got = bcgs_kernel.bcgs_mgs_pass(v.clone(), basis, k, chunk, route=route)
            again = bcgs_kernel.bcgs_mgs_pass(v.clone(), basis, k, chunk, route=route)
            assert bcgs_kernel.bcgs_mgs_pass.launches == before + 2
            want = bcgs_kernel.bcgs_mgs_pass_reference(v, basis, k, chunk)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= tol, (basis.dtype, n, k, chunk, route, rel)
            assert torch.equal(got, again), (basis.dtype, n, k, chunk, route)


def _e2b_matches_plain_on_both_routes(gen, dtype, n, tol, cap=600):
    """E2b, E2a's kernel at chunk = k, on both routes for v, for k up to a
    cap past the 512 coefficients the kernel stages at a time: within
    ``tol`` of the plain version and the same bits on repeat, each pass
    one counted launch; the default route's bits without ``route``."""
    basis = torch.randn((cap, n), generator=gen, device=gen.device, dtype=dtype)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    v = torch.randn(n, generator=gen, device=gen.device, dtype=dtype)
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    default = _cgs_variants.mgs_plan(n, basis.element_size(), sms).route
    for k in (1, 3, 100, 512, 513, cap):
        want = bcgs_kernel2.cgs_single_pass_reference(v, basis, k)
        before = bcgs_kernel2.cgs_single_pass.launches
        wrapped = bcgs_kernel2.cgs_single_pass(v.clone(), basis, k)
        for route in _cgs_variants.ROUTES:
            got = bcgs_kernel2.cgs_single_pass(v.clone(), basis, k, route=route)
            again = bcgs_kernel2.cgs_single_pass(v.clone(), basis, k, route=route)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= tol, (dtype, n, k, route, rel)
            assert torch.equal(got, again), (dtype, n, k, route)
            if route == default:
                assert torch.equal(wrapped, got), (dtype, n, k)
        assert bcgs_kernel2.cgs_single_pass.launches == before + 1 + 2 * len(_cgs_variants.ROUTES)


def _e3_in_graph_matches_plain(cuda, gen, calls=16):
    """E3 captured in a CUDA graph with k a device word the graph advances,
    replayed from a start that takes k out of [0, cap1): the plain
    version's bits replayed eagerly."""
    cap1, n = 24, 70001
    buf = torch.randn((cap1, n), generator=gen, device=cuda)
    ws = torch.randn((calls, n), generator=gen, device=cuda)
    kd = torch.zeros(1, dtype=torch.int32, device=cuda)

    def body():
        for i in range(calls):
            carry_copy_bench.row_set(buf, kd, ws[i])
            kd.add_(1)

    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for start in (-4, cap1 - 8):
        kd.fill_(start)
        before = buf.clone()
        graph.replay()
        want, kr = before, torch.tensor([start], dtype=torch.int32, device=cuda)
        for i in range(calls):
            carry_copy_bench.row_set_reference(want, kr, ws[i])
            kr.add_(1)
        torch.cuda.synchronize()
        assert torch.equal(buf, want) and torch.equal(kd, kr), start
