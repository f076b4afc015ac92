#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from ``lanczos_tpu_torch/csrc``, holds each
against its plain PyTorch version, and drives the port's paths: through
``LambdaLanczos.run`` the main path (deflation driver -> fused engine over a
``BSROperator``, kernels K1 and K3) at n = 2**20, the same problem over a
``ShardedBSROperator`` in a one-rank NCCL process group (kernels K2 and K3),
the scalar thick-restart engine on the main path's operator, and the block
thick-restart engine (kernel K4)
on the JAX package's block flagship, a float32 DIA chain at n = 2**22; and
through ``filtered_lanczos`` the JAX package's Chebyshev flagship on the same
chain, once with the fused chain (kernel K5, and K3 in the thick engine) and
once with the default unfused chain.  The kernel studies of
``lanczos_tpu_torch.experiments`` run at their own sizes: the CGS-pass
variants (E2a block MGS, E2b single drain, E2c bf16 shadow) on a
(257, 2**22) basis beside K3, and the in-place row write (E3), eagerly
and inside a captured CUDA graph, with the Krylov-buffer carry variants,
and the SpMV study's three variants (E1)
beside K1 and K2 on its 64 Mi-nnz operator.  The ``Exponentiator`` runs
the reference's exponentiator zoo in float64, the JAX package's n = 2**20
chain evolution (``evolve`` through K3, and the Chebyshev propagator) and a
time grid over the main path's operator (K1).  The main path's K3 calls
are recorded, and phase ``k3_path`` replays the recorded k sequence and
sweeps K3 beside its bounds.  The launch counts are set to 0 just before each path and read
just after it.
Every phase prints one JSON line; any failure raises, so the script exits
non-zero and prints no result.  The last two lines are the kernel table and
the device line.  It needs a CUDA device and fails at once without one; it
imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
import warnings

K1_REPLACES = "lanczos_tpu/ops/pallas_spmv.py:195"
K2_REPLACES = "lanczos_tpu/ops/pallas_spmv.py:104"
K3_REPLACES = "lanczos_tpu/ops/pallas_cgs.py:212"
K4_REPLACES = "lanczos_tpu/ops/pallas_cgs.py:177"
K5_REPLACES = "lanczos_tpu/ops/pallas_cheby.py:191"
E2A_REPLACES = "experiments/pallas_bcgs_kernel.py:72"
E2B_REPLACES = "experiments/pallas_bcgs_kernel2.py:64"
E2C_REPLACES = "experiments/pallas_bcgs_kernel3.py:66"
E3_REPLACES = "experiments/carry_copy_bench.py:62"
E1_V2_REPLACES = "experiments/pallas_spmv_bench.py:73"  # spmv_v2, vpu=False and vpu=True
E1_V3_REPLACES = "experiments/pallas_spmv_bench.py:119"
SEED = 0
MAIN_N = 2**20  # main-path problem size
K3_N = 2**22  # width of the (257, n) basis in the K3 phase
# K3's one-call sweep in phase k3_path: k at each basis width.
K3_SWEEP = {2**20: (1, 2, 4, 8, 16, 32, 64, 128, 176, 256), 2**22: (1, 16, 64, 256)}
K4_N = 2**22  # width of the (258, n) basis in the K4 phase (the flagship's buffer)
FLAGSHIP_N = 2**22  # the block flagship's chain (experiments/tpu_flagship_block.py)
CHEBY_N = 2**22  # the Chebyshev flagship's chain (experiments/tpu_flagship_cheby.py)
CHEBY_DEGREE = 400
E2_N = 2**22  # width of the studies' (257, n) basis (experiments/pallas_bcgs_kernel*.py)
E2_TOL = 1e-5  # max-abs error over max |plain|, K3's bar
E2_OVERLAP_BAR = 1.2e-4  # what E2c's shadow may add to K3's overlap: the selective trigger (pallas_bcgs_kernel3.py:7-8)
K5_TOL = 1e-5  # max-abs error over max |plain| at degree <= 129 (tests/test_filtered.py:160-161)
K5_FLAGSHIP_TOL = 1e-4  # the same at the flagship's degree 400
BENCH_R = 512  # row blocks of the 64 Mi-nnz K1 and K2 cases (bm = bk = 128, S = 8)
K2_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-12}  # relative to max |plain|
E1_TOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}  # relative to max |plain|
EXPM_OVERLAP_BAR = 2.220446049250313e-14  # the reference's exponentiator bar, machine_eps(f64) * 1e2
EXPM_CHAIN_N = 2**20  # experiments/tpu_cheby_expm.py's chain
EVOLVE_ANGLE_BAR = 1e-5  # state angle after 100 f32 steps (the TPU run: 8.3e-7, BASELINE.md:280-284)
CHEBY_ANGLE_BAR = 1e-6  # state angle of the f32 Chebyshev chain (the TPU run: 3.0e-7)
EXPM_BSR_BAR = 1e-5  # f32 run_grid against the f64 one, relative 2-norm error
EXPM_BSR_MAX_ITER = 200  # the Krylov budget of the expm_bsr builds
# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (the kernels use plain FMAs).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: bytes
    over the data-sheet HBM rate or float32 operations over the data-sheet
    rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-300)


def phase_environment(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(f"float32 matmul precision is {torch.get_float32_matmul_precision()}, not 'highest'")
    emit({
        "phase": "environment", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "device_count": torch.cuda.device_count(),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32, "float32_matmul_precision": torch.get_float32_matmul_precision(),
    })


def phase_build():
    from lanczos_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib._name,
          "sources": [str(p.relative_to(_build.CSRC_DIR.parent.parent)) for p in _build.sources()]})


def _random_bsr(torch, dev, r, bm, s, bk, dtype, gen):
    blocks = torch.randn((r, bm, s, bk), generator=gen, device=dev, dtype=dtype)
    col_blocks = torch.randint(0, (r * bm) // bk, (r, s), generator=gen, device=dev, dtype=torch.int32)
    return blocks, col_blocks


def check_k1(torch, blocks, col_blocks, x, n, tol, label, timing=False, library=False):
    import torch.nn.functional as F

    from lanczos_tpu_torch.ops import spmv

    r, bm, s, bk = blocks.shape
    n_pad = r * bm

    def plain():
        return spmv.bsr_matvec_reference(blocks, col_blocks, F.pad(x, (0, n_pad - x.shape[0])), layout="rmsk")[:n]

    def kernel():
        return spmv.bsr_matvec(blocks, col_blocks, x, n_out=n)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"K1 {label}: relative error {rel:.3e} above {tol:.0e}")
    out = {"phase": "k1", "case": label, "dtype": str(blocks.dtype), "shape": [r, bm, s, bk], "n": n,
           "max_abs_err": err, "max_rel_err": rel, "tol": tol}
    if timing:
        item = blocks.element_size()
        bytes_moved = blocks.numel() * item + 2 * n_pad * item
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        stream_ms = cuda_ms(torch, lambda: torch.sum(blocks))  # a read-stream probe of the tiles
        # Each input read once (tiles, column indices, x), y written once.
        bound_ms, bound_by = bound(bytes_moved + col_blocks.numel() * 4, 2 * blocks.numel())
        out.update(ms=ms, plain_ms=plain_ms, gbps=bytes_moved / ms / 1e6, plain_gbps=bytes_moved / plain_ms / 1e6,
                   stream_gbps=blocks.numel() * item / stream_ms / 1e6, bound_ms=bound_ms, bound_by=bound_by)
        if library:
            # The library yardstick: a BSR tensor built once from the same
            # tiles, times x (cuSPARSE through PyTorch).
            values = blocks.permute(0, 2, 1, 3).reshape(r * s, bm, bk).contiguous()
            crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
            a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64), values, size=(n_pad, n_pad))
            xp = F.pad(x, (0, n_pad - x.shape[0]))
            lib_err, lib_rel = rel_err((a @ xp)[:n], got)
            if not lib_rel <= tol:
                raise AssertionError(f"K1 {label}: the sparse library product differs by {lib_rel:.3e}")
            out.update(library_ms=cuda_ms(torch, lambda: a @ xp), library_max_rel_err=lib_rel)
            del a, values
    emit(out)
    return out


def phase_k1(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for label, (r, bm, s, bk, n) in {
            "small": (4, 8, 3, 8, 30),
            "ragged": (37, 16, 5, 16, 37 * 16 - 5),
            "wide_s": (9, 16, 400, 16, 144),  # S*bk past one shared-memory piece in float64
            "bench_64Mi_nnz": (BENCH_R, 128, 8, 128, BENCH_R * 128),
        }.items():
            blocks, col_blocks = _random_bsr(torch, dev, r, bm, s, bk, dtype, gen)
            x = torch.randn(n, generator=gen, device=dev, dtype=dtype)
            check_k1(torch, blocks, col_blocks, x, n, tol, label, timing=label.startswith("bench"))
            del blocks, col_blocks, x
    torch.cuda.empty_cache()


def _random_basis(torch, dev, cap, n, dtype, gen):
    basis = torch.randn((cap, n), generator=gen, device=dev, dtype=dtype)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    return basis


def check_k3(torch, basis, v, k, tol, timing=False):
    from lanczos_tpu_torch.ops import cgs

    want = cgs.cgs_pass_reference(v, basis, k)
    got = cgs.cgs_pass(v.clone(), basis, k)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"K3 k={k}: relative error {rel:.3e} above {tol:.0e}")
    out = {"phase": "k3", "dtype": str(basis.dtype), "basis": list(basis.shape), "k": k,
           "max_abs_err": err, "max_rel_err": rel, "tol": tol}
    if timing:
        work = v.clone()
        rows = basis[:k]
        ms = cuda_ms(torch, lambda: cgs.cgs_pass(work, basis, k))
        plain_ms = cuda_ms(torch, lambda: cgs.cgs_pass_reference(v, basis, k))
        library_ms = cuda_ms(torch, lambda: v - torch.mv(rows.T, torch.mv(rows, v)))  # two torch.mv
        stream_ms = cuda_ms(torch, lambda: torch.sum(rows))
        n, item = basis.shape[1], basis.element_size()
        bytes_moved = 2 * k * n * item
        # Each input read once (the k live rows, v), v written once.
        bound_ms, bound_by = bound((k + 2) * n * item, 4 * k * n)
        out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, gbps=bytes_moved / ms / 1e6,
                   plain_gbps=bytes_moved / plain_ms / 1e6, stream_gbps=k * n * item / stream_ms / 1e6,
                   bound_ms=bound_ms, bound_by=bound_by)
    emit(out)
    return out


def phase_k3(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    basis = _random_basis(torch, dev, 257, K3_N, torch.float32, gen)
    v = torch.randn(K3_N, generator=gen, device=dev, dtype=torch.float32)
    for k in (1, 63, 64, 65, 128, 256, 257):
        check_k3(torch, basis, v, k, 1e-5, timing=True)
    del basis, v
    basis = _random_basis(torch, dev, 129, 70001, torch.float64, gen)
    v = torch.randn(70001, generator=gen, device=dev, dtype=torch.float64)
    for k in (1, 64, 129):
        check_k3(torch, basis, v, k, 1e-12)
    del basis, v
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording_k3(cgs):
    """Record the (cap, n, k, dtype) of every K3 call that launches (k > 0
    on a CUDA tensor) while the context is open, into the list it yields.
    The callers reach K3 through the module attribute ``cgs.cgs_pass``, so
    the recorder stands in for it there and hands every call on.  The
    wrapper counts its launches on that same attribute, so the recorder
    carries the count meanwhile and hands it back at the end."""
    real = cgs.cgs_pass
    seq = []

    def recorder(v, basis, k):
        if int(k) > 0 and v.device.type == "cuda":
            seq.append((basis.shape[0], basis.shape[1], int(k), str(basis.dtype)))
        return real(v, basis, k)

    recorder.launches = real.launches
    cgs.cgs_pass = recorder
    try:
        yield seq
    finally:
        cgs.cgs_pass = real
        real.launches = recorder.launches


def l2_flusher(torch, dev):
    """A function that pushes every line of the card's L2 out by reading a
    buffer of twice its size, leaving clean lines (what a K3 call on the
    main path finds: K1 streamed 1.6 GB of tiles between two calls)."""
    buf = torch.zeros(2 * torch.cuda.get_device_properties(dev).L2_cache_size // 4, device=dev)
    return lambda: torch.sum(buf)


def cuda_ms_cold(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` with L2 flushed before each call (the
    flush runs before the start event)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_replay(torch, cgs, ks, basis, v, flush) -> dict:
    """Milliseconds of the K3 calls at ``ks`` (in order) on ``basis`` and
    ``v``: ``ms``, one CUDA event pair around the whole replay (the median
    of five replays after one warm-up; back to back, a call may find rows
    of the one before in L2), and ``cold_ms``, the sum of the calls each
    timed with L2 flushed before it (the median of three replays)."""

    def replay():
        for k in ks:
            cgs.cgs_pass(v, basis, k)

    sums = []
    for _ in range(3):
        events = []
        for k in ks:
            flush()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cgs.cgs_pass(v, basis, k)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        sums.append(sum(a.elapsed_time(b) for a, b in events))
    return {"ms": cuda_ms(torch, replay, reps=5, warmup=1), "cold_ms": statistics.median(sums)}


def phase_k3_path(torch, dev, seq):
    """K3 as the main path ran it: the histogram of k over its launches
    (``seq``, recorded in phase main_path), the whole sequence replayed on
    a fresh (257, 2**20) float32 basis (or of the largest capacity in
    ``seq``) and timed as one sum, back to back and with L2 flushed before
    each call (:func:`k3_replay`); then K3 one call at a time over
    :data:`K3_SWEEP`, each held to its plain version (1e-5 relative), then
    timed back to back and cold beside its one-read bound (``bound()``),
    the two-read stream (2 k n values over a same-process ``torch.sum``
    read rate of the basis) and two ``torch.mv``."""
    from lanczos_tpu_torch.ops import cgs

    # The engine grows its buffer's capacity as k grows; K3 reads rows
    # [0, k) only, so one basis of the largest capacity stands for all.
    widths = {(n, dt) for _cap, n, _k, dt in seq}
    if widths != {(MAIN_N, "torch.float32")}:
        raise AssertionError(f"k3_path: the main path's K3 calls are on bases of (n, dtype) {widths}")
    n, dtype = MAIN_N, "torch.float32"
    caps = sorted({c for c, _n, _k, _dt in seq})
    cap = caps[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    hist = collections.Counter(k for _cap, _n, k, _dt in seq)
    sweep = {}
    replay = {}
    flush = l2_flusher(torch, dev)
    for width, ks in K3_SWEEP.items():
        basis = _random_basis(torch, dev, max(cap, 257), width, torch.float32, gen)
        v = torch.randn(width, generator=gen, device=dev)
        stream_gbps = basis.numel() * 4 / cuda_ms(torch, lambda: torch.sum(basis)) / 1e6
        if width == MAIN_N:  # K3 reads rows [0, k) only, so the basis's extra rows change nothing
            times = k3_replay(torch, cgs, [k for _c, _n, k, _d in seq], basis, v.clone(), flush)
            replay = {"replay_ms": times["ms"], "replay_cold_ms": times["cold_ms"],
                      "replay_one_read_bound_ms": sum(bound((k + 2) * n * 4, 4 * k * n)[0] for _c, _n, k, _d in seq),
                      "replay_two_read_stream_ms": sum(2 * k * n * 4 for _c, _n, k, _d in seq) / stream_gbps / 1e6}
        work = v.clone()
        for k in ks:
            rows = basis[:k]
            rel = rel_err(cgs.cgs_pass(v.clone(), basis, k), cgs.cgs_pass_reference(v, basis, k))[1]
            if not rel <= 1e-5:
                raise AssertionError(f"k3_path: K3 at n = {width}, k = {k}: relative error {rel:.3e} above 1e-05")
            bound_ms, bound_by = bound((k + 2) * width * 4, 4 * k * width)
            sweep[f"{width}_k{k}"] = {
                "n": width, "k": k, "max_rel_err": rel,
                "ms": cuda_ms(torch, lambda k=k: cgs.cgs_pass(work, basis, k)),
                "cold_ms": cuda_ms_cold(torch, lambda k=k: cgs.cgs_pass(work, basis, k), flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "two_read_stream_ms": 2 * k * width * 4 / stream_gbps / 1e6,
                "library_ms": cuda_ms(torch, lambda rows=rows: v - torch.mv(rows.T, torch.mv(rows, v))),
            }
        del basis, v, work
        torch.cuda.empty_cache()
    del flush
    emit({"phase": "k3_path", "basis": [cap, n], "caps": caps, "dtype": dtype, "launches": len(seq),
          "k_histogram": dict(sorted(hist.items())), "k_sum": sum(k for _c, _n, k, _d in seq), **replay,
          "sweep": sweep})
    return replay


def check_k4(torch, basis, vblk, k, tol):
    from lanczos_tpu_torch.ops import cgs

    want = cgs.cgs_pass_block_reference(vblk, basis, k)
    got = cgs.cgs_pass_block(vblk.clone(), basis, k)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"K4 b={vblk.shape[0]} k={k}: relative error {rel:.3e} above {tol:.0e}")
    out = {"phase": "k4", "dtype": str(basis.dtype), "basis": list(basis.shape), "b": vblk.shape[0], "k": k,
           "max_abs_err": err, "max_rel_err": rel, "tol": tol}
    emit(out)
    return out


def _k4_info(torch, dev, b, dtype, plan):
    """Registers, spills, shared memory and resident CTAs per SM of K4's
    width-b kernels at ``plan`` (``lt_cgs_block_info``)."""
    import ctypes

    from lanczos_tpu_torch import _build

    out = (ctypes.c_int * 8)()
    err = _build.library().lt_cgs_block_info(int(dtype == torch.float64), b, plan.cols, plan.stages, dev.index, out)
    _build.check(err, "lt_cgs_block_info")
    keys = ("project_registers", "project_local_bytes", "update_registers", "update_local_bytes",
            "project_smem_bytes", "update_smem_bytes", "project_ctas_per_sm", "update_ctas_per_sm")
    return dict(zip(keys, out))


def phase_k4(torch, dev):
    """K4 against its plain version on the flagship's (258, 2**22) f32
    buffer (every block width bucket, k around the ring's depth and the
    8-row reduction rounds, two runs bit for bit) and on a ragged f64
    basis; then its time at b = 3, k = 24, 96 and 255."""
    from lanczos_tpu_torch.ops import cgs

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = K4_N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    basis = _random_basis(torch, dev, 258, n, torch.float32, gen)
    for b in (1, 2, 3, 4, 5, 8, 16):
        stages = cgs.block_plan(n, b, 4, sms).stages
        vblk = torch.randn((b, n), generator=gen, device=dev, dtype=torch.float32)
        for k in sorted({1, 3, stages - 1, stages, stages + 1, 9, 129, 255, 258}):
            check_k4(torch, basis, vblk, k, 1e-5)
    repeat = {}
    for k in (24, 96, 255):
        vblk = torch.randn((3, n), generator=gen, device=dev, dtype=torch.float32)
        first = cgs.cgs_pass_block(vblk.clone(), basis, k)
        second = cgs.cgs_pass_block(vblk.clone(), basis, k)
        torch.cuda.synchronize()
        repeat[str(k)] = bool(torch.equal(first, second))
    if not all(repeat.values()):
        raise AssertionError(f"K4: two runs on the same inputs differ: {repeat}")

    b = 3
    plan = cgs.block_plan(n, b, 4, sms)
    info = _k4_info(torch, dev, b, torch.float32, plan)
    by_k = {}
    for k in (24, 96, 255):
        vblk = torch.randn((b, n), generator=gen, device=dev, dtype=torch.float32)
        timed = check_k4(torch, basis, vblk, k, 1e-5)
        rows = basis[:k]
        work = vblk.clone()
        ms = cuda_ms(torch, lambda: cgs.cgs_pass_block(work, basis, k))
        plain_ms = cuda_ms(torch, lambda: cgs.cgs_pass_block_reference(vblk, basis, k))
        library_ms = cuda_ms(torch, lambda: vblk - torch.matmul(torch.matmul(rows, vblk.T).T, rows))  # two torch.matmul
        stream_ms = cuda_ms(torch, lambda: torch.sum(rows))
        v1 = vblk[0].clone()
        k3_ms = cuda_ms(torch, lambda: cgs.cgs_pass(v1, basis, k))
        bytes_moved = 2 * k * n * 4 + 2 * b * n * 4
        stream_gbps = k * n * 4 / stream_ms / 1e6
        # Each input read once (the k live rows, the block), the block written once.
        bound_ms, bound_by = bound(k * n * 4 + 2 * b * n * 4, 4 * k * b * n)
        timed.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, gbps=bytes_moved / ms / 1e6,
                     plain_gbps=bytes_moved / plain_ms / 1e6, stream_gbps=stream_gbps,
                     stream_bound_ms=bytes_moved / stream_gbps / 1e6, k3_ms=k3_ms, b_times_k3_ms=b * k3_ms,
                     bound_ms=bound_ms, bound_by=bound_by, plan=plan._asdict(), ctas_per_sm=plan.grid / sms,
                     sms=sms, bits_equal_on_repeat=repeat[str(k)], **info)
        emit({"phase": "k4_timing", **{key: val for key, val in timed.items() if key != "phase"}})
        by_k[k] = timed
    del basis, vblk, work, rows

    basis = _random_basis(torch, dev, 129, 70001, torch.float64, gen)
    for b in (3, 16):
        vblk = torch.randn((b, 70001), generator=gen, device=dev, dtype=torch.float64)
        for k in (1, 7, 9, 64, 129):
            check_k4(torch, basis, vblk, k, 1e-12)
    del basis, vblk
    torch.cuda.empty_cache()
    return by_k[255]


def phase_e2(torch, dev):
    """The CGS variant studies (E2a block MGS, E2b single drain, E2c bf16
    shadow) at their own size, a (257, 2**22) float32 basis of unit rows and
    its bf16 shadow: each kernel against its plain version over the live
    counts, E2a twice bit for bit, E2b (E2a's kernel at chunk = k) at
    k = cap on both routes for v twice bit for bit, E2a's L2 route for v on
    a float64 (65, 2**22) basis (v's range does not fit in shared memory
    there), a ragged float64 case, E2b past 512 rows at a small width in
    float32 and float64, the studies' own check lines and float64 probe,
    the live-row overlaps of E2c and K3, then their times beside K3's and
    the two-``torch.mv`` pass."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.experiments import _cgs_variants
    from lanczos_tpu_torch.experiments import bcgs_k2_tiny
    from lanczos_tpu_torch.experiments import bcgs_kernel as v1
    from lanczos_tpu_torch.experiments import bcgs_kernel2 as v2
    from lanczos_tpu_torch.experiments import bcgs_kernel3 as v3
    from lanczos_tpu_torch.ops import cgs

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    v1.bcgs_mgs_pass.launches = v2.cgs_single_pass.launches = v3.cgs_shadow_pass.launches = 0

    def one_launch(wrapper, *args):
        """One pass, which must be one launch whatever its chunk count."""
        before = wrapper.launches
        out = wrapper(*args)
        if wrapper.launches != before + 1:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - before} launches for one pass")
        return out

    def checked(label, got, want, tol):
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} above {tol:.0e}")
        return err, rel

    basis = _random_basis(torch, dev, 257, E2_N, torch.float32, gen)
    shadow = v3.make_shadow(basis)
    v = torch.randn(E2_N, generator=gen, device=dev, dtype=torch.float32)
    worst = {"e2a": 0.0, "e2b": 0.0, "e2c": 0.0}
    for k in (1, 63, 64, 65, 100, 256, 257):
        rels = {}
        for chunk in (32, 64, 128):
            err, rels[f"e2a_chunk{chunk}"] = checked(f"e2a k={k} chunk={chunk}",
                                                     one_launch(v1.bcgs_mgs_pass, v.clone(), basis, k, chunk),
                                                     v1.bcgs_mgs_pass_reference(v, basis, k, chunk), E2_TOL)
            worst["e2a"] = max(worst["e2a"], err)
        err, rels["e2b"] = checked(f"e2b k={k}", one_launch(v2.cgs_single_pass, v.clone(), basis, k),
                                   v2.cgs_single_pass_reference(v, basis, k), E2_TOL)
        worst["e2b"] = max(worst["e2b"], err)
        err, rels["e2c"] = checked(f"e2c k={k}", one_launch(v3.cgs_shadow_pass, v.clone(), shadow, basis, k),
                                   v3.cgs_shadow_pass_reference(v, shadow, basis, k), E2_TOL)
        worst["e2c"] = max(worst["e2c"], err)
        emit({"phase": "e2", "dtype": "torch.float32", "basis": [257, E2_N], "k": k, "max_rel_err": rels, "tol": E2_TOL})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _cgs_variants.mgs_plan(E2_N, 4, sms)
    if plan.route != "smem":
        raise AssertionError(f"e2a: v's range at n = {E2_N} float32 should stay in shared memory, plan {plan}")
    repeat = e2a_repeat(torch, v1, v, basis, ((256, 64), (100, 32), (257, 257)))
    emit({"phase": "e2a_plan", "basis": [257, E2_N], "plan": plan._asdict(), "bits_equal_on_repeat": repeat,
          **e2a_info(torch, _build, _cgs_variants, dev, plan, torch.float32)})
    emit({"phase": "e2", "case": "e2b_routes", "dtype": "torch.float32", "basis": [257, E2_N], "tol": E2_TOL,
          "max_rel_err": e2b_routes(torch, v2, _cgs_variants, v, basis, (257,), E2_TOL),
          "bits_equal_on_repeat": True})

    # E2c's point: the overlap with the live rows left after one pass, with
    # v given strong live-row components (pallas_bcgs_kernel3.py:107).
    vs = v + basis[:8].sum(dim=0) * 100.0
    overlaps = {}
    for k in (3, 100, 256):
        after_v3 = v3.overlap(basis, v3.cgs_shadow_pass(vs.clone(), shadow, basis, k), k)
        after_k3 = v3.overlap(basis, cgs.cgs_pass(vs.clone(), basis, k), k)
        # The study's rows are random, not orthonormal, so both passes leave
        # an overlap of their own; the shadow may add less than the bar.
        if not abs(after_v3 - after_k3) <= E2_OVERLAP_BAR:
            raise AssertionError(f"e2c k={k}: live-row overlap {after_v3:.3e} after one pass, {after_k3:.3e} after K3")
        overlaps[str(k)] = {"after_v3_pass": after_v3, "after_k3_pass": after_k3}
    emit({"phase": "e2_overlap", "basis": [257, E2_N], "overlaps": overlaps, "bar": E2_OVERLAP_BAR})

    # The times at the studies' live counts.  GB/s on each kernel's own
    # bytes; the bound reads each input once (the k live rows, plus the
    # shadow's for E2c, and v) and writes v once.
    stream_gbps = 257 * E2_N * 4 / cuda_ms(torch, lambda: torch.sum(basis)) / 1e6
    timed = {}
    work = v.clone()
    for k in (64, 128, 256):
        rows = basis[:k]
        n = E2_N

        def two_mv_per_chunk(k=k):
            w = v
            for c0 in range(0, k, 64):
                r = basis[c0 : min(c0 + 64, k)]
                w = w - torch.mv(r.T, torch.mv(r, w))
            return w

        row = {
            "e2a": {"ms": cuda_ms(torch, lambda: v1.bcgs_mgs_pass(work, basis, k, 64)), "chunk": 64,
                    "bytes": 2 * k * n * 4, "bound": bound((k + 2) * n * 4, 4 * k * n),
                    "library_ms": cuda_ms(torch, two_mv_per_chunk),
                    "plain_ms": cuda_ms(torch, lambda: v1.bcgs_mgs_pass_reference(v, basis, k, 64))},
            "e2b": {"ms": cuda_ms(torch, lambda: v2.cgs_single_pass(work, basis, k)),
                    "bytes": 2 * k * n * 4, "bound": bound((k + 2) * n * 4, 4 * k * n),
                    "library_ms": cuda_ms(torch, lambda: v - torch.mv(rows.T, torch.mv(rows, v))),
                    "plain_ms": cuda_ms(torch, lambda: v2.cgs_single_pass_reference(v, basis, k))},
            # No PyTorch call takes a bf16 matrix against a float32 vector
            # with float32 accumulation, so E2c has no library time.
            "e2c": {"ms": cuda_ms(torch, lambda: v3.cgs_shadow_pass(work, shadow, basis, k)),
                    "bytes": k * n * 6, "bound": bound(k * n * 6 + 2 * n * 4, 4 * k * n), "library_ms": None,
                    "plain_ms": cuda_ms(torch, lambda: v3.cgs_shadow_pass_reference(v, shadow, basis, k))},
            "k3": {"ms": cuda_ms(torch, lambda: cgs.cgs_pass(work, basis, k)), "bytes": 2 * k * n * 4},
        }
        for entry in row.values():
            entry["gbps"] = entry["bytes"] / entry["ms"] / 1e6
            entry["stream_bound_ms"] = entry["bytes"] / stream_gbps / 1e6
            if "bound" in entry:
                entry["bound_ms"], entry["bound_by"] = entry.pop("bound")
        timed[k] = row
        emit({"phase": "e2_timing", "basis": [257, n], "k": k, "stream_gbps": stream_gbps, **row})
    del basis, shadow, v, vs, work, rows

    # E2a's L2 route: float64 at the study's width, where v's range does not
    # fit in shared memory beside the ring.
    plan = _cgs_variants.mgs_plan(E2_N, 8, sms)
    if plan.route != "l2":
        raise AssertionError(f"e2a: v's range at n = {E2_N} float64 should go through L2, plan {plan}")
    basis = _random_basis(torch, dev, 65, E2_N, torch.float64, gen)
    v = torch.randn(E2_N, generator=gen, device=dev, dtype=torch.float64)
    rels = {}
    for k in (1, 63, 64, 65):
        for chunk in (32, 64):
            err, rels[f"e2a_k{k}_chunk{chunk}"] = checked(f"e2a f64 L2 route k={k} chunk={chunk}",
                                                          one_launch(v1.bcgs_mgs_pass, v.clone(), basis, k, chunk),
                                                          v1.bcgs_mgs_pass_reference(v, basis, k, chunk), 1e-12)
            worst["e2a"] = max(worst["e2a"], err)
    repeat = e2a_repeat(torch, v1, v, basis, ((65, 32),))
    emit({"phase": "e2a_l2_route", "dtype": "torch.float64", "basis": [65, E2_N], "plan": plan._asdict(),
          "max_rel_err": rels, "tol": 1e-12, "bits_equal_on_repeat": repeat,
          **e2a_info(torch, _build, _cgs_variants, dev, plan, torch.float64)})
    del basis, v
    torch.cuda.empty_cache()

    # float64: a ragged width, every chunk.
    basis = _random_basis(torch, dev, 129, 70001, torch.float64, gen)
    v = torch.randn(70001, generator=gen, device=dev, dtype=torch.float64)
    rels = {}
    for k in (1, 64, 129):
        for chunk in (32, 64, 128):
            rels[f"e2a_k{k}_chunk{chunk}"] = checked(f"e2a f64 k={k} chunk={chunk}",
                                                     one_launch(v1.bcgs_mgs_pass, v.clone(), basis, k, chunk),
                                                     v1.bcgs_mgs_pass_reference(v, basis, k, chunk), 1e-12)[1]
        rels[f"e2b_k{k}"] = checked(f"e2b f64 k={k}", one_launch(v2.cgs_single_pass, v.clone(), basis, k),
                                    v2.cgs_single_pass_reference(v, basis, k), 1e-12)[1]
    rels.update({f"e2b_{key}": rel for key, rel in e2b_routes(torch, v2, _cgs_variants, v, basis, (129,),
                                                               1e-12).items()})
    emit({"phase": "e2", "dtype": "torch.float64", "basis": [129, 70001], "max_rel_err": rels, "tol": 1e-12})
    del basis, v

    # E2b past the 512 coefficients its kernel stages at a time, at a small
    # width, in float32 and float64 on both routes.
    for dtype, tol in ((torch.float32, E2_TOL), (torch.float64, 1e-12)):
        basis = _random_basis(torch, dev, 600, 70001, dtype, gen)
        v = torch.randn(70001, generator=gen, device=dev, dtype=dtype)
        emit({"phase": "e2", "case": "e2b_routes", "dtype": str(dtype), "basis": [600, 70001], "tol": tol,
              "max_rel_err": e2b_routes(torch, v2, _cgs_variants, v, basis, (513, 600), tol),
              "bits_equal_on_repeat": True})
        del basis, v
    torch.cuda.empty_cache()

    # The studies' own entry points on the card: their check lines at
    # n = 2**16, and the float64 ground-truth probe of pallas_bcgs_k2_tiny.py.
    lines = {name: study.check(n=2**16, device=dev) for name, study in (("bcgs_kernel", v1), ("bcgs_kernel2", v2),
                                                                        ("bcgs_kernel3", v3))}
    probe = bcgs_k2_tiny.probe(device=dev)
    if not probe["rel_err_vs_f64_cgs"] <= E2_TOL:
        raise AssertionError(f"bcgs_k2_tiny: E2b against float64 CGS {probe['rel_err_vs_f64_cgs']:.3e}")
    launches = {"e2a": v1.bcgs_mgs_pass.launches, "e2b": v2.cgs_single_pass.launches,
                "e2c": v3.cgs_shadow_pass.launches}
    if not all(launches.values()):
        raise AssertionError(f"e2: a kernel was never launched: {launches}")
    emit({"phase": "e2_studies", "check_lines": lines, "bcgs_k2_tiny": probe, "launches": launches})
    for name, row in timed[256].items():  # the kernels line: k = 256, with the largest error of any check
        if name in worst:
            row["max_abs_err"] = worst[name]
    return launches, timed[256]


def e1_v2_info(dev, plan, vpu: bool) -> dict:
    """Registers, local (spill) bytes, shared memory and resident CTAs per
    SM of E1's v2 kernel (float32, 16-byte loads; the VPU form where
    ``vpu``, else the dot form) at ``plan``, as the runtime reports them;
    fewer resident CTAs than the kernel's floor of four fail the run."""
    import ctypes

    from lanczos_tpu_torch import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.library().lt_spmv_v2_info(0, 1, int(vpu), plan.smem_bytes, dev.index, out), "e1 v2 info")
    if out[3] < 4:
        raise AssertionError(f"e1: {out[3]} v2 CTAs per SM resident at plan {plan} (vpu={vpu})")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2], "ctas_per_sm": out[3]}


def e2b_routes(torch, v2, cv, v, basis, ks, tol) -> dict:
    """E2b (E2a's kernel at chunk = k) on both routes for v, for each k:
    within ``tol`` of its plain version and twice bit for bit, the
    wrapper's result without a route the default route's bits, and each
    pass one counted launch, or the run fails.  Returns the relative errors
    by k and route."""
    n = basis.shape[1]
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    default = cv.mgs_plan(n, basis.element_size(), sms).route
    rels = {}
    before = v2.cgs_single_pass.launches
    for k in ks:
        want = v2.cgs_single_pass_reference(v, basis, k)
        wrapped = v2.cgs_single_pass(v.clone(), basis, k)
        for route in cv.ROUTES:
            got = v2.cgs_single_pass(v.clone(), basis, k, route=route)
            again = v2.cgs_single_pass(v.clone(), basis, k, route=route)
            torch.cuda.synchronize()
            label = f"k{k}_{route}"
            rels[label] = rel_err(got, want)[1]
            if not rels[label] <= tol:
                raise AssertionError(f"e2b {basis.dtype} {label}: relative error {rels[label]:.3e} above {tol:.0e}")
            if not torch.equal(got, again):
                raise AssertionError(f"e2b {basis.dtype} {label}: two runs on the same inputs differ")
            if route == default and not torch.equal(got, wrapped):
                raise AssertionError(f"e2b {basis.dtype} {label}: the wrapper's bits differ from its route's")
    made = len(ks) * (1 + 2 * len(cv.ROUTES))
    if v2.cgs_single_pass.launches - before != made:
        raise AssertionError(f"e2b: {v2.cgs_single_pass.launches - before} launches counted for {made} passes")
    return rels


def e2a_repeat(torch, v1, v, basis, cases) -> dict:
    """E2a twice on the same inputs for each (k, chunk): the same bits, or
    the run fails."""
    repeat = {}
    for k, chunk in cases:
        first = v1.bcgs_mgs_pass(v.clone(), basis, k, chunk)
        second = v1.bcgs_mgs_pass(v.clone(), basis, k, chunk)
        torch.cuda.synchronize()
        repeat[f"k{k}_chunk{chunk}"] = bool(torch.equal(first, second))
    if not all(repeat.values()):
        raise AssertionError(f"E2a: two runs on the same inputs differ: {repeat}")
    return repeat


def e2a_info(torch, _build, _cgs_variants, dev, plan, dtype) -> dict:
    """Registers, spills, shared memory and resident CTAs per SM of E2a's
    kernel at ``plan``, as the runtime reports them."""
    import ctypes

    out = (ctypes.c_int * 4)()
    _build.check(_build.library().lt_bcgs_ring_info(int(dtype == torch.float64), int(plan.route == "smem"), plan.cols,
                                                    plan.piece, plan.stages, dev.index, out), "e2a info")
    if out[3] < _cgs_variants.MGS_CTAS_PER_SM:
        raise AssertionError(f"e2a: {out[3]} CTAs per SM resident at plan {plan}")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2], "ctas_per_sm": out[3]}


def phase_e3(torch, dev):
    """The in-place row write (E3) against its plain version, bit for bit,
    on a (256, 2**20) float32 buffer; out-of-range k; its time beside
    ``index_copy_`` and ``copy_``, eagerly and inside a captured CUDA graph
    (phase ``e3_graph``); then the carry study's variants A, C, G, G_graph,
    H, I at cap1 = 256, n in (2**18, 2**20), with and without the
    reorthogonalization read, in microseconds per iteration."""
    from lanczos_tpu_torch.experiments import carry_copy_bench as cc

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cap1, n = 256, 2**20
    buf = torch.randn((cap1, n), generator=gen, device=dev)
    w = torch.randn(n, generator=gen, device=dev)
    for k in (0, 1, 127, 255, -1, 256, 1000):
        kt = torch.tensor([k], dtype=torch.int32, device=dev)
        before = cc.row_set.launches
        got = cc.row_set(buf.clone(), kt, w)
        if cc.row_set.launches != before + 1:
            raise AssertionError(f"E3 k={k}: {cc.row_set.launches - before} launches for one call")
        want = cc.row_set_reference(buf.clone(), kt, w)
        torch.cuda.synchronize()
        inside = 0 <= k < cap1
        others = torch.ones(cap1, dtype=torch.bool, device=dev)
        if inside:
            others[k] = False
        if not (torch.equal(got, want) and torch.equal(got[others], buf[others])
                and (not inside or torch.equal(got[k], w))):
            raise AssertionError(f"E3 k={k}: not the plain version's bits, or another row changed")
    kt = torch.tensor([cap1 // 2], dtype=torch.int32, device=dev)
    klong = kt.long()
    work = buf.clone()
    probe = torch.empty(n, device=dev)
    calls = {"row_set": lambda: cc.row_set(work, kt, w), "plain": lambda: cc.row_set_reference(work, kt, w),
             "index_copy_": lambda: work.index_copy_(0, klong, w[None]),
             "copy_": lambda: probe.copy_(w)}  # the same bytes as one plain device copy
    # One eager call's time is its host's launch path: CUDA events around
    # one call (the method of the other kernels) catch the host waking from
    # the previous sync and scatter by several µs, so E3's times are events
    # around runs of 100 back-to-back calls, per call; the single-call
    # figures and the host clock over 10**4 calls stand beside them.
    per_call = {name: cuda_ms_per_call(torch, fn) for name, fn in calls.items()}
    single = {name: cuda_ms(torch, fn) for name, fn in calls.items()}
    host_us = {name: host_us_per_call(torch, calls[name]) for name in ("row_set", "index_copy_", "copy_")}
    del buf, work, w, probe, calls
    torch.cuda.empty_cache()
    graph = e3_graph(torch, dev, cc, gen, cap1, n)
    bound_ms, bound_by = bound(2 * n * 4, 0)
    emit({"phase": "e3_graph", "buffer": [cap1, n], **graph, "bound_us": bound_ms * 1e3})
    graph = graph["us_per_call"]
    net_us = graph["row_set"] - graph["advance_only"]
    timed = {"phase": "e3", "buffer": [cap1, n], "max_abs_err": 0.0, "bitwise": True, "ms": per_call["row_set"],
             "plain_ms": per_call["plain"], "library_ms": per_call["index_copy_"], "copy_ms": per_call["copy_"],
             "stream_bound_ms": per_call["copy_"], "bound_ms": bound_ms, "bound_by": bound_by,
             "single_call_ms": single, "host_us_per_call": host_us,
             "graph_us_per_call": graph,
             "graph_net_us": net_us, "graph_net_bound_share": bound_ms * 1e3 / net_us,
             "graph_vs_copy": graph["row_set"] / graph["copy_"]}
    emit(timed)

    cc.row_set.launches = 0
    g_iterations = 0
    expected = 0
    us = {}
    for n in (2**18, 2**20):
        for cgs in (False, True):
            for name in cc.VARIANTS:
                out = cc.run_variant(name, cap1, n, K=8, cgs=cgs, device=dev)
                us[f"{name}_n{n}_cgs{int(cgs)}"] = out["us"]
                if name == "G":
                    g_iterations += out["iterations"]
                    if out["launches"] != out["iterations"]:
                        raise AssertionError(f"E3: {out['launches']} launches for {out['iterations']} G iterations")
                elif name == "G_graph" and out["launches"] != 3 + 40 + 200:  # the warm-up and both captures
                    raise AssertionError(f"E3: G_graph made {out['launches']} row_set calls, not 243")
                expected += out["launches"]
    launches = cc.row_set.launches
    if not launches == expected > g_iterations > 0:
        raise AssertionError(f"E3 launches {launches} against {expected} calls, {g_iterations} G iterations")
    emit({"phase": "e3_variants", "cap1": cap1, "us_per_iteration": us, "g_iterations": g_iterations,
          "launches": launches})
    torch.cuda.empty_cache()
    return launches, timed


def cuda_ms_per_call(torch, fn, calls: int = 100, reps: int = 20) -> float:
    """Median milliseconds per call of ``fn`` over runs of ``calls``
    back-to-back calls between two CUDA events."""
    return cuda_ms(torch, lambda: [fn() for _ in range(calls)], reps=reps) / calls


def host_us_per_call(torch, fn, reps: int = 10_000) -> float:
    """Host microseconds per call of ``fn`` by ``perf_counter`` over
    ``reps`` calls after a warm-up (the enqueue rate of an eager loop)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def e3_graph(torch, dev, cc, gen, cap1, n, calls: int = 64) -> dict:
    """E3 inside a captured CUDA graph: ``calls`` row writes, k a device
    word that the graph sets from ``k0`` and advances after every call,
    captured on the capturing stream.  Replayed from k0 = -8 and from
    k0 = cap1 - 32 (calls with k outside [0, cap1) among them), the buffer
    must hold the plain version's bits replayed eagerly; replayed from
    k0 = 0 it is timed beside the same calls of ``index_copy_`` and of
    ``copy_`` (a fixed row), and the advance alone, each captured the same
    way.  A capture that fails fails the run."""
    buf = torch.randn((cap1, n), generator=gen, device=dev)
    ws = torch.randn((calls, n), generator=gen, device=dev)
    k0 = torch.zeros(1, dtype=torch.int32, device=dev)
    kd = torch.zeros(1, dtype=torch.int32, device=dev)

    def body(write):
        kd.copy_(k0)
        for i in range(calls):
            write(i)
            kd.add_(1)

    writes = {
        "row_set": lambda i: cc.row_set(buf, kd, ws[i]),
        "index_copy_": lambda i: buf.index_copy_(0, kd.long(), ws[i][None]),
        "copy_": lambda i: buf[i].copy_(ws[i]),
        "advance_only": lambda i: None,
    }
    graphs = {}
    for name, write in writes.items():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
            body(write)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            body(write)

    checks = {}
    for start in (-8, cap1 - 32):
        before = buf.clone()
        k0.fill_(start)
        graphs["row_set"].replay()
        want, kr = before.clone(), torch.tensor([start], dtype=torch.int32, device=dev)
        for i in range(calls):
            cc.row_set_reference(want, kr, ws[i])
            kr.add_(1)
        torch.cuda.synchronize()
        checks[str(start)] = bool(torch.equal(buf, want) and torch.equal(kd, kr))
        if not checks[str(start)]:
            raise AssertionError(f"E3 in a graph from k0 = {start}: not the plain version's bits")
    k0.fill_(0)
    out = {name: cuda_ms(torch, graph.replay) * 1e3 / calls for name, graph in graphs.items()}
    del graphs, buf, ws
    torch.cuda.empty_cache()
    return {"calls": calls, "bitwise_by_k0": checks, "us_per_call": out}


def _chain_coo(np, n, potential):
    i = np.arange(n - 1)
    d = np.arange(n)
    rows = np.concatenate([i, i + 1, d])
    cols = np.concatenate([i + 1, i, d])
    vals = np.concatenate([-np.ones(2 * (n - 1)), potential])
    return rows, cols, vals


def phase_small_solves(torch, np, dev):
    import lanczos_tpu_torch as tl

    a = torch.tensor([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]], device=dev)
    eng = tl.LambdaLanczos(tl.DenseOperator(a), find_maximum=True)
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)
    val, vec = eng.run_one()
    if eng._resolve_mode() != "fused" or not abs(val - 4.0) <= 4.0 * eng.eps:
        raise AssertionError(f"3x3: {val} in mode {eng._resolve_mode()}")
    emit({"phase": "readme_3x3", "eigenvalue": val, "expected": 4.0, "mode": eng._resolve_mode(),
          "iteration_counts": eng.iteration_counts})

    n = 1024
    op = tl.BSROperator.from_coo(*_chain_coo(np, n, np.zeros(n)), n, bm=128, bk=128, dtype=torch.float32, device=dev)
    eng = tl.LambdaLanczos(op, find_maximum=False)
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)
    val, _ = eng.run_one()
    expected = -2.0 * np.cos(np.pi / (n + 1))
    if not abs(val - expected) <= 2.4e-4:
        raise AssertionError(f"chain n=1024: {val} vs {expected}")
    emit({"phase": "chain_1024", "eigenvalue": val, "expected": expected, "abs_err": abs(val - expected),
          "iteration_counts": eng.iteration_counts})


def _main_path_coo(np):
    """The main path's problem: the n = 2**20 hopping chain with a random
    on-site potential and three deep sites (three bound states below the
    band)."""
    n = MAIN_N
    rng = np.random.default_rng(SEED)
    pot = rng.uniform(0.0, 1.0, n)
    pot[[n // 4, n // 2, 3 * n // 4]] = [-4.0, -3.5, -3.0]
    return _chain_coo(np, n, pot)


def _main_path_engine(tl, torch, op):
    """LambdaLanczos over ``op`` as the main path configures it."""
    eng = tl.LambdaLanczos(op, num_eigs=3, find_maximum=False)
    eng.eps = 1e-6
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)  # same start every run
    # The three bound states are checked independently (scipy and
    # residuals), so the confirming deflation round — which would resolve
    # the gap-less band edge to eps — is skipped.
    eng.stop_when_full = True
    mode = eng._resolve_mode()
    if mode != "fused":
        raise AssertionError(f"mode='auto' resolved to {mode} on {op.device}")
    return eng


def phase_main_path(torch, np, dev):
    """n = 2**20 hopping chain with a random on-site potential and three deep
    sites (three bound states below the band), f32, three eigenpairs."""
    import scipy.sparse
    import scipy.sparse.linalg

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.core import tridiagonal
    from lanczos_tpu_torch.ops import cgs, spmv
    from lanczos_tpu_torch.solvers import lanczos_fused

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np)
    t0 = time.perf_counter()
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=128, bk=128, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    eng = _main_path_engine(tl, torch, op)
    mode = eng._resolve_mode()

    torch.cuda.reset_peak_memory_stats()
    spmv.bsr_matvec.launches = 0
    cgs.cgs_pass.launches = 0
    with recording_k3(cgs) as k3_seq:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches}
    if not (launches["k1"] > 0 and launches["k3"] > 0 and launches["k3"] == len(k3_seq)):
        raise AssertionError(f"main path did not launch both kernels: {launches}, {len(k3_seq)} K3 calls recorded")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    a = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    t0 = time.perf_counter()
    ref = np.sort(scipy.sparse.linalg.eigsh(a, k=3, which="SA")[0])
    scipy_s = time.perf_counter() - t0
    rel = np.abs(np.asarray(evals) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    if not (np.all(np.isfinite(evals)) and evecs.shape == (3, n) and bool(torch.isfinite(evecs).all())):
        raise AssertionError("non-finite or misshapen eigenpairs")
    if not np.all(rel <= 1e-5):
        raise AssertionError(f"eigenvalues {evals} vs scipy {ref}: relative error {rel}")
    if not max(residuals) <= 1e-3:
        raise AssertionError(f"residuals {residuals}")
    iters = sum(eng.iteration_counts)
    emit({"phase": "main_path", "n": n, "dtype": "float32", "mode": mode, "tiles": list(op.blocks.shape),
          "tile_gb": op.blocks.numel() * 4 / 1e9, "pack_s": pack_s, "eigenvalues": list(map(float, evals)),
          "scipy_eigsh": list(map(float, ref)), "max_rel_err": float(rel.max()), "residuals": residuals,
          "iteration_counts": eng.iteration_counts, "wall_s": wall, "iterations_per_s": iters / wall,
          "reorth_count": eng.stats.reorth_count, "launches": launches, "peak_device_gb": peak_gb,
          "scipy_s": scipy_s})

    # The kernels at the shapes the main path gives them.
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
    k1 = check_k1(torch, op.blocks, op.col_blocks, x, n, 1e-5, "main_path", timing=True, library=True)
    cap = 257
    basis = _random_basis(torch, dev, cap, n, torch.float32, gen)
    k3 = check_k3(torch, basis, x, 128, 1e-5, timing=True)
    del basis

    # Where an iteration's time goes: the fused build at a fixed 128 rows
    # (eps < 0 runs every check but never stops), with the check every 4
    # iterations (the default) and only at capacity, for both policies; and
    # the host check alone at k = 128.
    zero_defl = torch.zeros((0, n), device=dev)
    mask = torch.ones(0, device=dev)
    v0 = x / torch.linalg.vector_norm(x)
    rates = {}
    for policy in ("full", "selective"):
        for label, every in (("check_every_4", 4), ("check_at_capacity", 10**9)):
            lanczos_fused.fused_krylov(op, v0, zero_defl, mask, -1.0, 0.0, nroot=5, m_cap=16, find_maximum=False,
                                       check_every=every, reorth_policy=policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lanczos_fused.fused_krylov(op, v0, zero_defl, mask, -1.0, 0.0, nroot=5, m_cap=128, find_maximum=False,
                                       check_every=every, reorth_policy=policy)
            torch.cuda.synchronize()
            rates[f"{policy}_{label}"] = 128 / (time.perf_counter() - t0)
    alpha = torch.randn(128, dtype=torch.float32)
    beta = torch.rand(128, dtype=torch.float32)
    t0 = time.perf_counter()
    for _ in range(5):
        tridiagonal.extremal_eigenvalues_device(alpha, beta, 128, 5, False)
    check_ms = (time.perf_counter() - t0) / 5 * 1e3
    emit({"phase": "iteration_rates", "n": n, "rows": 128, "iterations_per_s": rates, "host_check_ms_k128_f32": check_ms})
    return launches, k1, k3, op, ref, eng.iteration_counts, k3_seq


def check_k2(torch, blocks, col_blocks, x, label):
    """K2 against its plain version on the same inputs, evaluated in float64
    (so the error is K2's own rounding), at K2_TOL; then its time beside the
    bound, the plain version, a read stream of its tiles and the
    ``torch.sparse_bsr_tensor`` product, whose values tensor is the rsmk
    tiles as they lie."""
    from lanczos_tpu_torch.ops import spmv

    r, s, bm, bk = blocks.shape
    c_rows = x.numel() // bk
    n_out = r * bm

    def kernel():
        return spmv.bsr_matvec_rsmk(blocks, col_blocks, x, col_bound=c_rows)

    def plain():
        return spmv.bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")

    got = kernel()
    want = spmv.bsr_matvec_reference(blocks.double(), col_blocks, x.double(), layout="rsmk")
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    tol = K2_TOL[str(blocks.dtype)]
    if not rel <= tol:
        raise AssertionError(f"K2 {label} {blocks.dtype}: relative error {rel:.3e} above {tol:.0e}")
    plain_err, plain_rel = rel_err(plain(), want)
    item = blocks.element_size()
    # What the kernel moves: the tiles and col_blocks once, the x segments
    # its row blocks gather (at most the table, read through L2), y once.
    bytes_moved = blocks.numel() * item + col_blocks.numel() * 4 + (x.numel() + n_out) * item
    ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
    stream_gbps = blocks.numel() * item / cuda_ms(torch, lambda: torch.sum(blocks)) / 1e6
    bound_ms, bound_by = bound(bytes_moved, 2 * blocks.numel())
    crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
    a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64), blocks.view(-1, bm, bk),
                                size=(n_out, c_rows * bk))
    try:
        lib_rel, library_ms, library_error = rel_err(a @ x, want)[1], cuda_ms(torch, lambda: a @ x), None
    except RuntimeError as e:  # the sparse library may refuse a case (non-square blocks); K2 is not affected
        lib_rel, library_ms, library_error = None, None, str(e)[:200]
    del a
    out = {"phase": "k2", "case": label, "dtype": str(blocks.dtype), "shape": [r, s, bm, bk], "x_rows": c_rows,
           "max_abs_err": err, "max_rel_err": rel, "tol": tol, "plain_max_rel_err": plain_rel,
           "library_max_rel_err": lib_rel, "library_error": library_error, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "gbps": bytes_moved / ms / 1e6, "stream_gbps": stream_gbps,
           "stream_bound_ms": bytes_moved / stream_gbps / 1e6, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(out)
    return out


def _random_rsmk(torch, dev, r, s, bm, bk, c_rows, dtype, gen):
    blocks = torch.randn((r, s, bm, bk), generator=gen, device=dev, dtype=dtype)
    col_blocks = torch.randint(0, c_rows, (r, s), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn(c_rows * bk, generator=gen, device=dev, dtype=dtype)
    return blocks, col_blocks, x


def phase_k2(torch, dev, op):
    """K2 on the 64 Mi-nnz case in f32 and f64, on the main path's operator
    in rsmk (the tiles of ``op``, the sharded main path's operator), on a
    footprint-shaped payload (x of fewer rows than R*bm/bk) and on
    rectangular tiles (bm = 64, bk = 128)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for dtype in (torch.float32, torch.float64):
        blocks, cb, x = _random_rsmk(torch, dev, BENCH_R, 8, 128, 128, BENCH_R, dtype, gen)
        check_k2(torch, blocks, cb, x, "bench_64Mi_nnz")
        del blocks, cb, x
    for label, (r, s, bm, bk, c_rows) in {"payload": (BENCH_R, 8, 128, 128, 100),
                                         "rect_bm64_bk128": (2048, 4, 64, 128, 1024)}.items():
        blocks, cb, x = _random_rsmk(torch, dev, r, s, bm, bk, c_rows, torch.float32, gen)
        check_k2(torch, blocks, cb, x, label)
        del blocks, cb, x
    x = torch.randn(op.n_padded, generator=gen, device=dev, dtype=torch.float32)
    main = check_k2(torch, op.blocks, op.col_blocks, x, "main_path")
    torch.cuda.empty_cache()
    return main


def phase_sharded_main_path(torch, np, dev, ref, main_iters):
    """The main path's problem over a ShardedBSROperator in a one-rank NCCL
    process group: the fused engine on the rank's slab (the whole vector),
    the all-gather and the all-reduces over NCCL, the local SpMV on K2."""
    import datetime
    import socket

    import torch.distributed as dist

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, spmv
    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    torch.cuda.set_device(0)
    with socket.socket() as sock:  # a free local port for the rendezvous
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    pmesh.initialize_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                                 timeout=datetime.timedelta(seconds=300))
    try:
        backend = str(dist.get_backend())
        mesh = pmesh.make_mesh()
        if backend != "nccl" or mesh.device != dev:
            raise AssertionError(f"process group on {backend} / {mesh.device}, not NCCL on {dev}")
        # The first collective creates the NCCL communicator: a one-off cost
        # of the process group, timed apart from the solve.
        t0 = time.perf_counter()
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        first_collective_s = time.perf_counter() - t0
        n = MAIN_N
        rows, cols, vals = _main_path_coo(np)
        t0 = time.perf_counter()
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=128, bk=128, dtype=torch.float32)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        eng = _main_path_engine(tl, torch, op)
        torch.cuda.reset_peak_memory_stats()
        spmv.bsr_matvec.launches = 0
        spmv.bsr_matvec_rsmk.launches = 0
        cgs.cgs_pass.launches = 0
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": spmv.bsr_matvec.launches, "k2": spmv.bsr_matvec_rsmk.launches, "k3": cgs.cgs_pass.launches}
        if not (launches["k2"] > 0 and launches["k1"] == 0 and launches["k3"] > 0):
            raise AssertionError(f"sharded main path: launches {launches} (K2 and K3 expected, no K1)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rel = np.abs(np.asarray(evals) - ref) / np.abs(ref)
        residuals = eng.residuals(evals, evecs)
        if not (np.all(np.isfinite(evals)) and evecs.shape == (3, n) and bool(torch.isfinite(evecs).all())):
            raise AssertionError("sharded main path: non-finite or misshapen eigenpairs")
        if not np.all(rel <= 1e-5):
            raise AssertionError(f"sharded main path: eigenvalues {evals} vs scipy {ref}: relative error {rel}")
        if not max(residuals) <= 1e-3:
            raise AssertionError(f"sharded main path: residuals {residuals}")
        iters = sum(eng.iteration_counts)
        emit({"phase": "sharded_main_path", "n": n, "dtype": "float32", "backend": backend, "world_size": mesh.size,
              "comm": op.comm, "mode": eng._resolve_mode(), "tiles": list(op.blocks.shape), "pack_s": pack_s,
              "first_collective_s": first_collective_s,
              "eigenvalues": list(map(float, evals)), "scipy_eigsh": list(map(float, ref)),
              "max_rel_err": float(rel.max()), "residuals": residuals, "iteration_counts": eng.iteration_counts,
              "main_path_iteration_counts": main_iters, "wall_s": wall, "iterations_per_s": iters / wall,
              "launches": launches, "peak_device_gb": peak_gb})
    finally:
        dist.destroy_process_group()
    return launches, op


def phase_thick_scalar(torch, np, op, ref):
    """The main path's operator through the scalar thick-restart engine: a
    128-row basis where the unrestarted solve needed 176 iterations."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, spmv

    eng = tl.LambdaLanczos(op, num_eigs=3, find_maximum=False)
    eng.restart_policy = "thick"
    eng.max_iteration = 128
    eng.eps = 1e-6
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)
    eng.stop_when_full = True  # the pairs are checked against scipy below
    torch.cuda.synchronize()
    spmv.bsr_matvec.launches = 0
    cgs.cgs_pass.launches = 0
    t0 = time.perf_counter()
    evals, evecs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches}
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"thick path did not launch both kernels: {launches}")
    rel = np.abs(np.asarray(evals) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    if not (np.all(np.isfinite(evals)) and bool(torch.isfinite(evecs).all()) and np.all(rel <= 1e-5)):
        raise AssertionError(f"thick: eigenvalues {evals} vs scipy {ref}: relative error {rel}")
    if not max(residuals) <= 1e-3:
        raise AssertionError(f"thick: residuals {residuals}")
    emit({"phase": "thick_scalar", "n": op.n, "dtype": "float32", "mode": eng._resolve_mode(), "max_iteration": 128,
          "eigenvalues": list(map(float, evals)), "max_rel_err": float(rel.max()), "residuals": residuals,
          "iteration_counts": eng.iteration_counts, "wall_s": wall,
          "iterations_per_s": sum(eng.iteration_counts) / wall, "launches": launches})


def phase_block_thick_flagship(torch, np, dev, n):
    """The JAX package's block flagship (experiments/tpu_flagship_block.py):
    -1 hopping chain as a float32 DIA operator, the three lowest eigenpairs
    of a 1e-12-close cluster with a width-3 block thick-restart engine."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs

    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    eng = tl.LambdaLanczos(op, num_eigs=3, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 256  # basis rows
    eng.restart_policy = "thick"
    eng.block_size = 3
    eng.eps = 5e-8
    eng.max_restarts = 24
    eng.thick_keep = 24
    rng = np.random.default_rng(SEED)  # distinct start rows, the same every run
    eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cgs.cgs_pass_block.launches = 0
    cgs.cgs_pass.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        evals, evecs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k4": cgs.cgs_pass_block.launches, "k3": cgs.cgs_pass.launches}
    if not launches["k4"] > 0:
        raise AssertionError(f"block flagship did not launch K4: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    exact = np.array([-2.0 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)])
    errs = np.abs(np.sort(np.asarray(evals)) - exact)
    residuals = eng.residuals(evals, evecs)
    if not (evecs.shape == (3, n) and bool(torch.isfinite(evecs).all()) and np.all(np.isfinite(residuals))):
        raise AssertionError(f"block flagship: misshapen or non-finite output, residuals {residuals}")
    if not np.all(errs <= 2e-6):
        raise AssertionError(f"block flagship: eigenvalues {evals} vs {exact}: errors {errs}")
    rows = (max(256 // 3, 2) + 1) * 3  # the ((cap_b + 1) b, n) basis buffer
    emit({"phase": "block_thick_flagship", "n": n, "dtype": "float32", "block_size": 3,
          "eigenvalues": list(map(float, evals)), "exact": exact.tolist(), "abs_errs": errs.tolist(),
          "residuals": residuals, "iteration_counts": eng.iteration_counts, "wall_s": wall,
          "block_steps_per_s": sum(eng.iteration_counts) / wall, "launches": launches, "peak_device_gb": peak_gb,
          "basis_buffer_gb": rows * n * 4 / 1e9, "warnings": [str(w.message)[:200] for w in caught]})
    return launches


def check_k5(torch, data, offsets, x, c, e, degree, tol):
    """K5 against its plain version on the same inputs; (max abs error,
    max abs error / max |plain|)."""
    from lanczos_tpu_torch.ops import cheby

    got = cheby.cheby_chain_apply(data, offsets, x, c, e, degree)
    want = cheby.cheby_chain_apply_reference(data, offsets, x, c, e, degree)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"K5 offsets={offsets} degree={degree}: relative error {rel:.3e} above {tol:.0e}")
    return err, rel


def _k5_info(torch, dev, plan, offs, w):
    """Registers, spills, threads, shared memory and resident CTAs per SM
    of the K5 kernel ``plan`` takes for the prescaled offsets ``offs``
    (``lt_cheby_chain_info``)."""
    import ctypes

    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.ops import cheby

    out = (ctypes.c_int * 5)()
    offs_c = (ctypes.c_int * len(offs))(*offs)
    err = _build.library().lt_cheby_chain_info(cheby.ROUTES.index(plan.route), offs_c, len(offs), w, plan.core,
                                                plan.halo, dev.index, out)
    _build.check(err, "lt_cheby_chain_info")
    return dict(zip(("registers", "local_bytes", "threads_per_cta", "smem_bytes", "ctas_per_sm"), out))


def _symmetric_rows(torch, offsets, n, gen):
    """Rows (in ``offsets`` order) of a random symmetric DIA operator with
    entries in [-1.8/k, 1.8/k] for k offsets: row +o holds u, row -o holds
    u shifted by o (A[i, i - o] = A[i - o, i])."""
    scale = 1.8 / len(offsets)
    rows = {}
    for o in sorted({abs(o) for o in offsets}):
        u = (torch.rand(n, generator=gen, device=gen.device) * 2 - 1) * scale
        rows[o] = u
        if o:
            rows[-o] = torch.cat([torch.zeros(o, device=u.device), u[:-o]])
    return torch.stack([rows[o] for o in offsets])


def phase_k5(torch, np, dev):
    """K5 against its plain version on a ragged n for narrow bands (the
    register route) and wide ones (the shared-memory route), at the degrees
    around one launch's steps and 400; then the Chebyshev flagship's filter
    apply (n = 2**22 chain, degree 400, window of
    from_interval(op, 400, -2, 2, 1e-5)), timed beside the plain version and
    the default unfused chain."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cheby
    from lanczos_tpu_torch.ops.filters import ChebyshevFilterOperator

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = 70001
    for offsets in ((-1, 1), (-1, 0, 1), (1, 1, 0), (-2, -1, 0, 1, 2), (-8, -3, 0, 3, 8), (-8, -3, 0, 5, 8)):
        # Rows in [-1.8/k, 1.8/k] keep the spectrum inside the [-1.95, 2.15]
        # window, so the chain does not grow and the relative bar is tight.
        # Degree 400 needs a real spectrum (complex eigenvalues grow like
        # rho**400 and overflow float32): symmetric rows, where the offsets
        # pair up.
        symmetric = sorted(offsets) == sorted(-o for o in offsets)
        data = _symmetric_rows(torch, offsets, n, gen) if symmetric else (
            (torch.rand((len(offsets), n), generator=gen, device=dev) * 2 - 1) * (1.8 / len(offsets)))
        x = torch.randn(n, generator=gen, device=dev)
        p = cheby.plan(n, cheby.prescale(data, offsets, 0.1, 2.05)[1])
        before = dict(cheby.cheby_chain_apply.launches_by_route)
        degrees = (1, 2, p.steps - 1, p.steps, p.steps + 1, 37) + ((CHEBY_DEGREE,) if symmetric else ())
        errs = {d: check_k5(torch, data, offsets, x, 0.1, 2.05, d, K5_FLAGSHIP_TOL if d == CHEBY_DEGREE else K5_TOL)[1]
                for d in degrees}
        routed = {r: cheby.cheby_chain_apply.launches_by_route[r] - before[r] for r in before}
        if routed[p.route] == 0 or sum(routed.values()) != routed[p.route]:
            raise AssertionError(f"K5 offsets={offsets}: launches {routed} off the planned {p.route} route")
        emit({"phase": "k5", "n": n, "offsets": list(offsets), "route": p.route, "steps_per_launch": p.steps,
              "max_rel_err_by_degree": {str(d): r for d, r in errs.items()}, "tol": K5_TOL,
              "tol_at_degree_400": K5_FLAGSHIP_TOL, "launches_by_route": routed})
        del data, x

    n, degree = CHEBY_N, CHEBY_DEGREE
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    fused = ChebyshevFilterOperator.from_interval(op, degree, -2.0, 2.0, 1e-5)
    fused.use_fused = True
    unfused = ChebyshevFilterOperator.from_interval(op, degree, -2.0, 2.0, 1e-5)
    unfused.use_fused = False
    x = torch.randn(n, generator=gen, device=dev)
    err, rel = check_k5(torch, op.data, op.offsets, x, fused.c, fused.e, degree, K5_FLAGSHIP_TOL)
    plain = cheby.cheby_chain_apply_reference(op.data, op.offsets, x, fused.c, fused.e, degree)
    unfused_err, unfused_rel = rel_err(unfused.matvec(x), plain)
    ms = cuda_ms(torch, lambda: fused.matvec(x))
    plain_ms = cuda_ms(torch, lambda: cheby.cheby_chain_apply_reference(op.data, op.offsets, x, fused.c, fused.e, degree),
                       reps=5, warmup=1)
    unfused_ms = cuda_ms(torch, lambda: unfused.matvec(x), reps=5, warmup=1)
    rows, offs = fused._prescaled
    ndiag, w = len(offs), max(abs(o) for o in offs)
    p = cheby.plan(n, offs)
    if p.route != "registers":
        raise AssertionError(f"the flagship's filter plans the {p.route} route, not the register route")
    n_launch = -(-degree // p.steps)
    window_cells = -(-n // p.core) * (p.core + 2 * p.halo)
    # What the kernel moves: each launch reads t, t_prev (not in the first)
    # and the rows over every window, and writes t and t_prev over the cores.
    kernel_bytes = 4 * (n_launch * (2 + ndiag) * window_cells - window_cells + n_launch * 2 * n)
    probe = torch.ones(kernel_bytes // 4, device=dev)  # a read stream of the kernel's byte count (past L2)
    stream_gbps = probe.numel() * 4 / cuda_ms(torch, lambda: torch.sum(probe)) / 1e6
    del probe
    # The function's least work: its inputs (the two stored rows, x) read
    # once and its output written once; 2 ndiag operations per cell and step
    # (ndiag products, ndiag - 1 sums, one difference or halving).
    bound_ms, bound_by = bound((len(op.offsets) + 2) * n * 4, 2 * ndiag * n * degree)
    out = {"phase": "k5_timing", "n": n, "degree": degree, "offsets": list(op.offsets), "c": fused.c, "e": fused.e,
           "route": p.route, "cells_per_thread": p.cells, "steps_per_launch": p.steps, "halo": p.halo,
           "core": p.core, "launches_per_apply": n_launch, **_k5_info(torch, dev, p, offs, w),
           "max_abs_err": err, "max_rel_err": rel, "tol": K5_FLAGSHIP_TOL,
           "unfused_max_rel_err_vs_plain": unfused_rel, "ms": ms, "ms_per_launch": ms / n_launch,
           "plain_ms": plain_ms, "unfused_ms": unfused_ms, "library_ms": None, "kernel_gb": kernel_bytes / 1e9,
           "stream_gbps": stream_gbps, "stream_bound_ms": kernel_bytes / stream_gbps / 1e6,
           "bound_ms": bound_ms, "bound_by": bound_by, "gflop": 2 * ndiag * n * degree / 1e9,
           "window_cells_per_step": window_cells}
    emit(out)
    del op, fused, unfused, x, plain, rows
    torch.cuda.empty_cache()
    return out


def phase_cheby_flagship(torch, np, dev, n):
    """The JAX package's Chebyshev flagship (experiments/tpu_flagship_cheby.py):
    the three lowest eigenpairs of the n = 2**22 float32 chain by
    filtered_lanczos at degree 400, mu 1e-5, window [-2, 2], B-space budget
    2 x 48 rows; first with the fused chain (K5), then with the default
    unfused chain."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, cheby

    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    exact = np.array([-2.0 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)])
    runs = {}
    for use_fused in (True, False):
        rng = np.random.default_rng(SEED)  # the same B-space starts in both runs

        def cfg(eng, use_fused=use_fused, rng=rng):
            eng.max_restarts = 2
            eng.max_iteration = 48
            eng.operator.use_fused = use_fused
            eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_).astype(np.float32)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cheby.cheby_chain_apply.launches = 0
        cheby.cheby_chain_apply.launches_by_route = dict.fromkeys(cheby.ROUTES, 0)
        cgs.cgs_pass.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vals, vecs, info = tl.filtered_lanczos(op, num_eigs=3, degree=CHEBY_DEGREE, mu=1e-5, lo=-2.0, hi=2.0,
                                                   configure=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k5": cheby.cheby_chain_apply.launches, "k3": cgs.cgs_pass.launches,
                    "k5_by_route": dict(cheby.cheby_chain_apply.launches_by_route)}
        errs = np.abs(np.sort(np.asarray(vals)) - exact)
        residuals = info["residuals"]
        label = "fused" if use_fused else "unfused"
        if use_fused and not (launches["k5_by_route"]["registers"] == launches["k5"] > 0 and launches["k3"] > 0):
            raise AssertionError(f"Chebyshev flagship did not launch K5 (register route) and K3: {launches}")
        if not use_fused and launches["k5"]:
            raise AssertionError(f"Chebyshev flagship's unfused run launched K5: {launches}")
        if not (vecs.shape == (3, n) and bool(torch.isfinite(vecs).all()) and np.all(np.isfinite(residuals))):
            raise AssertionError(f"Chebyshev flagship ({label}): misshapen or non-finite output, residuals {residuals}")
        if not np.all(errs <= 2e-6):
            raise AssertionError(f"Chebyshev flagship ({label}): eigenvalues {vals} vs {exact}: errors {errs}")
        runs[label] = {"phase": "cheby_flagship", "chain": label, "n": n, "dtype": "float32",
                       "degree": info["filter_degree"], "mu": info["mu"], "eigenvalues": list(map(float, vals)),
                       "exact": exact.tolist(), "abs_errs": errs.tolist(), "residuals": residuals,
                       "iteration_counts": info["iteration_counts"], "matvecs": info["matvecs"], "wall_s": wall,
                       "launches": launches, "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "warnings": [str(w.message)[:200] for w in caught]}
        emit(runs[label])
    emit({"phase": "cheby_flagship_walls", "fused_wall_s": runs["fused"]["wall_s"],
          "unfused_wall_s": runs["unfused"]["wall_s"],
          "unfused_over_fused": runs["unfused"]["wall_s"] / runs["fused"]["wall_s"]})
    return runs["fused"]["launches"]


def phase_e1(torch, dev):
    """The SpMV study's variants (E1: v2, v2 VPU form, v3) at its size, 64
    Mi stored nnz in float32 (R = 512, S = 8, 128 x 128 tiles, G = 8):
    each kernel against its plain version and twice bit for bit, on a tail
    case (R = 516, whose last CTA of v3 owns 4 row blocks)
    and in float64; the rounding trap (tile rows that cancel, where the VPU
    form's separately rounded products and an FMA chain differ); the VPU
    form's plan with its registers and spills (as the runtime reports
    them); the study's check lines and its
    marginal-method run of the whole variant set; then each kernel's time
    beside the plain version, the sparse library product, K1, K2 and a
    read stream of the tiles, by one call (the kernels line's figures) and
    per call over runs of 50 back-to-back calls."""
    import numpy as np

    from lanczos_tpu_torch.experiments import spmv_bench as sb
    from lanczos_tpu_torch.ops import spmv

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    sb.spmv_v2.launches = sb.spmv_v2.vpu_launches = sb.spmv_v3.launches = 0

    def operator(r, dtype):
        blocks = torch.randn((r, 8, 128, 128), generator=gen, device=dev, dtype=dtype) * 0.01
        cb = torch.randint(0, r, (r, 8), generator=gen, device=dev, dtype=torch.int32)
        x = torch.randn(r * 128, generator=gen, device=dev, dtype=dtype)
        return blocks, blocks.permute(0, 2, 1, 3).contiguous(), cb, x

    def variants(blocks, blocks_t):
        return {"spmv_v2": (sb.spmv_v2, sb.spmv_v2_reference, blocks, {}),
                "spmv_v2_vpu": (sb.spmv_v2, sb.spmv_v2_reference, blocks, {"vpu": True}),
                "spmv_v3": (sb.spmv_v3, sb.spmv_v3_reference, blocks_t, {})}

    worst = {}
    for label, r, dtype in (("tail_R516", 516, torch.float32), ("f64_R64", 64, torch.float64),
                            ("f64_tail_R68", 68, torch.float64)):
        blocks, blocks_t, cb, x = operator(r, dtype)
        rels = {}
        for name, (fn, ref, tiles, kw) in variants(blocks, blocks_t).items():
            got, want = fn(tiles, cb, x, G=8, **kw), ref(tiles, cb, x, G=8, **kw)
            again = fn(tiles, cb, x, G=8, **kw)
            torch.cuda.synchronize()
            err, rels[name] = rel_err(got, want)
            if not rels[name] <= E1_TOL[str(dtype)]:
                raise AssertionError(f"E1 {name} {label}: relative error {rels[name]:.3e} above "
                                     f"{E1_TOL[str(dtype)]:.0e}")
            if not torch.equal(got, again):
                raise AssertionError(f"E1 {name} {label}: two runs on the same inputs differ")
            if dtype == torch.float32:  # the kernels line reports float32 errors
                worst[name] = max(worst.get(name, 0.0), err)
        emit({"phase": "e1", "case": label, "dtype": str(dtype), "shape": [r, 8, 128, 128], "G": 8,
              "max_rel_err": rels, "tol": E1_TOL[str(dtype)], "bits_equal_on_repeat": True})
        del blocks, blocks_t, cb, x
    # The rounding trap: on tiles whose rows cancel, the VPU form keeps the
    # plain version's separately rounded products; the dot form's FMA
    # chain, which a VPU form with contracted products would become, misses
    # them by far more than the tolerance.
    trap = {}
    for dtype in (np.float32, np.float64):
        blocks, _, cb, x = (torch.from_numpy(a).to(dev) for a in sb.make_cancelling_data(r=64, dtype=dtype))
        label, tol = str(blocks.dtype), E1_TOL[str(blocks.dtype)]
        want = sb.spmv_v2_reference(blocks, cb, x, vpu=True)
        got, again, dot = (sb.spmv_v2(blocks, cb, x, vpu=vpu) for vpu in (True, True, False))
        torch.cuda.synchronize()
        trap[label] = {"vpu": rel_err(got, want)[1], "dot": rel_err(dot, want)[1], "tol": tol}
        if not (trap[label]["vpu"] <= tol and torch.equal(got, again)):
            raise AssertionError(f"E1 VPU form on cancelling tile rows, {label}: {trap}")
        if not trap[label]["dot"] > 100 * tol:
            raise AssertionError(f"E1 rounding trap: the dot form meets the VPU form's products, {trap}")
        del blocks, cb, x
    emit({"phase": "e1", "case": "rounding_trap", "shape": [64, 8, 128, 128], "max_rel_err": trap,
          "bits_equal_on_repeat": True})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = sb.vpu_plan(BENCH_R, 8, 128, 128, 4)
    for name, vpu in (("spmv_v2_vpu", True), ("spmv_v2", False)):
        emit({"phase": "e1_plan", "kernel": name, "shape": [BENCH_R, 8, 128, 128], "dtype": "torch.float32",
              "plan": plan._asdict(), "ctas_per_sm_of_grid": plan.ctas / sms, **e1_v2_info(dev, plan, vpu)})

    lines = sb.check(device=dev)  # the study's own check: R = 64 and 68
    if not all(float(line.rsplit("=", 1)[1]) <= E1_TOL["torch.float32"] for line in lines):
        raise AssertionError(f"E1 check lines: {lines}")

    blocks, blocks_t, cb, x = operator(BENCH_R, torch.float32)
    study = sb.run_study(blocks, blocks_t, cb, x, short=16, long=48, repeats=3)
    emit({"phase": "e1_study", "shape": [BENCH_R, 8, 128, 128], "check_lines": lines, "variants": study})

    item = blocks.element_size()
    tile_bytes = blocks.numel() * item
    # Each input read once (tiles, column indices, x), y written once.
    bytes_moved = tile_bytes + cb.numel() * 4 + 2 * x.numel() * item
    bound_ms, bound_by = bound(bytes_moved, 2 * blocks.numel())

    def per_call(fn):
        # Beside each one-call time (which also holds the host's enqueue of
        # a ~0.1 ms call): runs of back-to-back calls, the card kept busy.
        return cuda_ms_per_call(torch, fn, calls=50, reps=10)

    stream_ms = cuda_ms(torch, lambda: torch.sum(blocks))
    crow = torch.arange(0, BENCH_R * 8 + 1, 8, dtype=torch.int64, device=dev)
    a = torch.sparse_bsr_tensor(crow, cb.reshape(-1).to(torch.int64), blocks.view(-1, 128, 128),
                                size=(BENCH_R * 128, BENCH_R * 128))
    timed = {}
    for name, (fn, ref, tiles, kw) in variants(blocks, blocks_t).items():
        got, want = fn(tiles, cb, x, G=8, **kw), ref(tiles, cb, x, G=8, **kw)
        err, rel = rel_err(got, want)
        if not rel <= E1_TOL["torch.float32"]:
            raise AssertionError(f"E1 {name} at the study's size: relative error {rel:.3e}")
        call = functools.partial(fn, tiles, cb, x, G=8, **kw)
        plain = functools.partial(ref, tiles, cb, x, G=8, **kw)
        ms = cuda_ms(torch, call)
        timed[name] = {"max_abs_err": max(worst[name], err), "max_rel_err": rel, "ms": ms,
                       "plain_ms": cuda_ms(torch, plain), "library_ms": cuda_ms(torch, lambda: a @ x),
                       "bound_ms": bound_ms, "bound_by": bound_by, "gbps": bytes_moved / ms / 1e6,
                       "stream_bound_ms": stream_ms * bytes_moved / tile_bytes,
                       "ms_per_call": per_call(call), "plain_ms_per_call": per_call(plain),
                       "library_ms_per_call": per_call(lambda: a @ x)}
    lib_rel = rel_err(a @ x, sb.spmv_v2_reference(blocks, cb, x))[1]
    k1_ms = cuda_ms(torch, lambda: spmv.bsr_matvec(blocks_t, cb, x))
    k2_ms = cuda_ms(torch, lambda: spmv.bsr_matvec_rsmk(blocks, cb, x, col_bound=BENCH_R))
    per_call_ms = {"k1": per_call(lambda: spmv.bsr_matvec(blocks_t, cb, x)),
                   "k2": per_call(lambda: spmv.bsr_matvec_rsmk(blocks, cb, x, col_bound=BENCH_R)),
                   "stream": per_call(lambda: torch.sum(blocks))}
    launches = {"spmv_v2": sb.spmv_v2.launches, "spmv_v2_vpu": sb.spmv_v2.vpu_launches,
                "spmv_v3": sb.spmv_v3.launches}
    if not all(launches.values()):
        raise AssertionError(f"e1: a kernel was never launched: {launches}")
    ctas = {"spmv_v2": plan.ctas, "spmv_v2_vpu": plan.ctas, "spmv_v3": BENCH_R // 8}
    emit({"phase": "e1_timing", "shape": [BENCH_R, 8, 128, 128], "G": 8, "ctas": ctas, "kernels": timed,
          "k1_ms": k1_ms, "k2_ms": k2_ms, "k1_gbps": bytes_moved / k1_ms / 1e6, "k2_gbps": bytes_moved / k2_ms / 1e6,
          "stream_gbps": tile_bytes / stream_ms / 1e6, "library_max_rel_err": lib_rel, "launches": launches,
          "ms_per_call_of_50": per_call_ms})
    del blocks, blocks_t, cb, x, a
    torch.cuda.empty_cache()
    return launches, timed


def _overlap_err(np, truth, out) -> float:
    t = np.asarray(truth, np.complex128).ravel()
    o = np.asarray(out, np.complex128).ravel()
    return float(abs(1.0 - abs(np.vdot(t, o)) / (np.linalg.norm(t) * np.linalg.norm(o))))


def _to_np(np, *parts):
    """A host complex128 array from a tensor, or from its real and
    imaginary tensors."""
    out = parts[0].double().cpu().numpy().astype(np.complex128)
    if len(parts) == 2:
        out = out + 1j * parts[1].double().cpu().numpy()
    return out


def phase_expm_zoo(torch, np, dev):
    """The reference's exponentiator zoo (test/exponentiator_test.cpp) in
    float64 on the card, as experiments/tpu_exponentiator_zoo.py runs it:
    the 3 x 3 matrix at a = 3 against its eigendecomposition (Krylov and
    Taylor), the n = 100 ring at a = 3i with complex input through
    run_split, and the ring at a = 0; each below the reference's overlap
    bar."""
    import lanczos_tpu_torch as tl

    m = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    u1 = np.array([[1 / np.sqrt(3), -1 / np.sqrt(2), -1 / np.sqrt(6)], [1 / np.sqrt(3), 0.0, 2 / np.sqrt(6)],
                   [1 / np.sqrt(3), 1 / np.sqrt(2), -1 / np.sqrt(6)]])
    vin = np.array([1.0, 0.0, 0.0])
    truth1 = u1 @ (np.diag(np.exp(3.0 * np.array([4.0, 1.0, 1.0]))) @ (u1.T @ vin))
    n = 100
    h = np.zeros((n, n))
    i = np.arange(n - 1)
    h[i, i + 1] = h[i + 1, i] = -1.0
    h[0, n - 1] = h[n - 1, 0] = -1.0
    k = 2 * np.pi / n * np.arange(n)
    u2 = np.exp(1j * np.outer(np.arange(n), k)) / np.sqrt(n)
    vin2 = np.zeros(n, np.complex128)
    vin2[0] = vin2[-1] = 1 + 2j
    vin2[50] = 8 + 2j
    vin2 /= np.linalg.norm(vin2)
    truth2 = u2 @ (np.diag(np.exp(3.0j * -2.0 * np.cos(k))) @ (u2.conj().T @ vin2))

    ex = tl.Exponentiator(torch.tensor(m, device=dev))
    ex2 = tl.Exponentiator(torch.tensor(h, device=dev))
    ex2z = tl.Exponentiator(torch.tensor(h, device=dev))
    ex2z.full_orthogonalize = True
    results = {}
    t0 = time.perf_counter()
    out, it = ex.run(3.0, vin)
    results["dense3_krylov"] = {"err": _overlap_err(np, truth1, _to_np(np, out)), "iters": it,
                                "device": str(out.device)}
    out, it = ex.taylor_run(3.0, vin)
    results["dense3_taylor"] = {"err": _overlap_err(np, truth1, _to_np(np, out)), "iters": it}
    (o_re, o_im), its = ex2.run_split(3.0j, vin2.real, vin2.imag)
    results["ring100_krylov_split"] = {"err": _overlap_err(np, truth2, _to_np(np, o_re, o_im)), "iters": list(its)}
    (z_re, z_im), its = ex2z.run_split(0.0, vin2.real, vin2.imag)
    results["ring100_zero_a"] = {"err": _overlap_err(np, vin2, _to_np(np, z_re, z_im)), "iters": list(its)}
    wall = time.perf_counter() - t0
    worst = max(r["err"] for r in results.values())
    if not worst < EXPM_OVERLAP_BAR:
        raise AssertionError(f"expm zoo: worst overlap error {worst:.3e} against {EXPM_OVERLAP_BAR:.3e}: {results}")
    emit({"phase": "expm_zoo", "dtype": "float64", "results": results, "worst": worst, "bar": EXPM_OVERLAP_BAR,
          "wall_s": wall})


def phase_expm_chain(torch, np, dev):
    """experiments/tpu_cheby_expm.py's scenario at full size: the n = 2**20
    float32 DIA chain, v0 its k = 3 analytic eigenvector, total time 50:
    ``evolve`` for 100 steps of exp(-0.5i H) at krylov_dim 12 (K3 in every
    build), counted host waits; one Chebyshev chain for t = 50 on [-2, 2];
    a 10-snapshot Chebyshev grid.  Each against the exact phase of the
    eigenvector, by state angle."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs

    n, k_mode, a_step, steps = EXPM_CHAIN_N, 3, -0.5j, 100
    lam = -2.0 * np.cos(k_mode * np.pi / (n + 1))
    j = np.arange(1, n + 1, dtype=np.float64)
    v0 = (np.sqrt(2.0 / (n + 1)) * np.sin(k_mode * np.pi * j / (n + 1))).astype(np.float32)
    ref = v0.astype(np.float64) / np.linalg.norm(v0.astype(np.float64))
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    ex = tl.Exponentiator(op)
    v_re = torch.from_numpy(v0).to(dev)
    v_im = torch.zeros_like(v_re)

    def angle(a_total, o_re, o_im):
        out = _to_np(np, o_re, o_im)
        out /= np.linalg.norm(out)
        truth = np.exp(a_total * lam) * ref
        ip = np.vdot(truth, out)
        return float(np.linalg.norm(out - (ip / abs(ip)) * truth))

    def counted_evolve(n_steps):
        """evolve with PyTorch's sync debug mode on: the result, the wall
        time, and where each host wait for the device was issued."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = ex.evolve(a_step, v_re, v_im, n_steps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        waits = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
        return out, time.perf_counter() - t0, waits

    counted_evolve(1)  # warm-up: the first complex128 batched products initialize the library
    _, _, waits_1 = counted_evolve(1)
    cgs.cgs_pass.launches = 0
    (re, im), evolve_s, waits = counted_evolve(steps)
    k3 = cgs.cgs_pass.launches
    evolve_angle = angle(a_step * steps, re, im)
    if not (k3 > 0 and evolve_angle <= EVOLVE_ANGLE_BAR):
        raise AssertionError(f"evolve: K3 launches {k3}, angle {evolve_angle:.3e} against {EVOLVE_ANGLE_BAR:.0e}")
    if len(waits) != len(waits_1):  # the host waits after the last step only, however many steps
        raise AssertionError(f"evolve: host waits {waits} in {steps} steps, {waits_1} in one")

    cheby_s = []
    for _ in range(2):  # the first call (cold) and the second (warm), as the JAX study times them
        t0 = time.perf_counter()
        (c_re, c_im), terms = ex.run_chebyshev(a_step * steps, v_re, v_im, lo=-2.0, hi=2.0)
        torch.cuda.synchronize()
        cheby_s.append(time.perf_counter() - t0)
    cheby_angle = angle(a_step * steps, c_re, c_im)
    ts = [a_step * steps * (q + 1) / 10.0 for q in range(10)]
    t0 = time.perf_counter()
    (g_re, g_im), grid_terms = ex.run_chebyshev_grid(ts, v_re, v_im, lo=-2.0, hi=2.0)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_angles = [angle(t, g_re[q], g_im[q]) for q, t in enumerate(ts)]
    if not (cheby_angle <= CHEBY_ANGLE_BAR and max(grid_angles) <= CHEBY_ANGLE_BAR):
        raise AssertionError(f"Chebyshev chain: angle {cheby_angle:.3e}, grid angles {grid_angles}")
    if not (g_re.shape == (10, n) and bool(torch.isfinite(g_re).all() and torch.isfinite(g_im).all())):
        raise AssertionError("Chebyshev grid: misshapen or non-finite output")
    emit({"phase": "expm_chain", "n": n, "dtype": "float32", "k_mode": k_mode, "a_step": str(a_step), "steps": steps,
          "krylov_dim": 12, "evolve_s": evolve_s, "evolve_ms_per_step": evolve_s / steps * 1e3,
          "evolve_angle": evolve_angle, "evolve_k3_launches": k3, "evolve_host_waits": waits,
          "evolve_host_waits_one_step": waits_1,
          "cheby_cold_s": cheby_s[0], "cheby_warm_s": cheby_s[1], "cheby_terms": terms, "cheby_angle": cheby_angle,
          "grid_s": grid_s,
          "grid_terms": grid_terms, "grid_angles": grid_angles,
          "bars": {"evolve": EVOLVE_ANGLE_BAR, "chebyshev": CHEBY_ANGLE_BAR}})
    return {"k3": k3}


def phase_expm_bsr(torch, np, dev, op):
    """run_grid over the main path's BSROperator (n = 2**20, float32) with
    a in (-0.1, -0.5, -1) from a seeded unit vector, against the same run
    on a float64 copy of the tiles.  Both builds run K1 and stop at eps
    1e-12 (float32) or the float64 default; a has a real part, where the
    reference's stop test never fires (R7), so the budget
    EXPM_BSR_MAX_ITER also bounds a regression."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import spmv

    a_list = [-0.1, -0.5, -1.0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    v = torch.randn(op.n, generator=gen, device=dev, dtype=torch.float32)
    v /= torch.linalg.vector_norm(v)
    op64 = tl.BSROperator(op.blocks.double(), op.col_blocks, op.n)
    runs = {}
    for label, operator, vec in (("float32", op, v), ("float64", op64, v.double())):
        ex = tl.Exponentiator(operator)
        ex.max_iteration = EXPM_BSR_MAX_ITER
        if label == "float32":
            ex.eps = 1e-12
        ex.run_grid(a_list, vec)  # warm-up
        torch.cuda.synchronize()
        spmv.bsr_matvec.launches = 0
        t0 = time.perf_counter()
        outs, iters = ex.run_grid(a_list, vec)
        torch.cuda.synchronize()
        runs[label] = {"outs": outs, "iters": iters, "ms": (time.perf_counter() - t0) * 1e3,
                       "k1_launches": spmv.bsr_matvec.launches, "eps": ex.eps}
    del op64
    f32, f64 = runs["float32"], runs["float64"]
    errs = [float(torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want))
            for got, want in zip(f32["outs"], f64["outs"])]
    if not (f32["k1_launches"] > 0 and f64["k1_launches"] > 0):
        raise AssertionError(f"expm_bsr: K1 launches {f32['k1_launches']} / {f64['k1_launches']}")
    if not max(f32["iters"], f64["iters"]) < EXPM_BSR_MAX_ITER:
        raise AssertionError(f"expm_bsr: no convergence in {EXPM_BSR_MAX_ITER} iterations "
                             f"({f32['iters']}, {f64['iters']})")
    if not (f32["outs"].shape == (3, op.n) and bool(torch.isfinite(f32["outs"]).all()) and max(errs) <= EXPM_BSR_BAR):
        raise AssertionError(f"expm_bsr: float32 against float64 relative errors {errs} (bar {EXPM_BSR_BAR:.0e})")
    emit({"phase": "expm_bsr", "n": op.n, "tiles": list(op.blocks.shape), "a": a_list,
          "rel_err_f32_vs_f64": errs, "bar": EXPM_BSR_BAR,
          **{f"{label}_{key}": val for label, r in runs.items() for key, val in r.items() if key != "outs"}})
    return {"k1": f32["k1_launches"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the GPU and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        """Run one phase and keep its wall time for the done line."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("environment", phase_environment, torch)
    timed("build", phase_build)
    timed("k1", phase_k1, torch, dev)
    timed("k3", phase_k3, torch, dev)
    k4 = timed("k4", phase_k4, torch, dev)
    e2_launches, e2 = timed("e2", phase_e2, torch, dev)
    e3_launches, e3 = timed("e3", phase_e3, torch, dev)
    e1_launches, e1 = timed("e1", phase_e1, torch, dev)
    timed("expm_zoo", phase_expm_zoo, torch, np, dev)
    timed("expm_chain", phase_expm_chain, torch, np, dev)
    timed("small_solves", phase_small_solves, torch, np, dev)
    launches, k1, k3, op, ref, main_iters, k3_seq = timed("main_path", phase_main_path, torch, np, dev)
    timed("thick_scalar", phase_thick_scalar, torch, np, op, ref)
    timed("expm_bsr", phase_expm_bsr, torch, np, dev, op)
    del op
    torch.cuda.empty_cache()
    timed("k3_path", phase_k3_path, torch, dev, k3_seq)
    sharded_launches, sharded_op = timed("sharded_main_path", phase_sharded_main_path, torch, np, dev, ref, main_iters)
    k2 = timed("k2", phase_k2, torch, dev, sharded_op)
    del sharded_op
    torch.cuda.empty_cache()
    flagship = timed("block_thick_flagship", phase_block_thick_flagship, torch, np, dev, FLAGSHIP_N)
    torch.cuda.empty_cache()
    k5 = timed("k5", phase_k5, torch, np, dev)
    cheby_launches = timed("cheby_flagship", phase_cheby_flagship, torch, np, dev, CHEBY_N)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "phase_seconds": seconds})

    def entry(name, source, replaces, n_launches, timed):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n_launches,
                "max_abs_err": timed["max_abs_err"], "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                "library_ms": timed["library_ms"], "lib_ms": timed["library_ms"]}  # lib_ms: the same, short name

    # launches: K1 and K3 from the main path's run, K2 from the sharded main
    # path's, K4 from the block flagship's, K5 from the Chebyshev
    # flagship's fused run and E2a-c and E3 from the study phases e2 and e3
    # (the paths that run them).  No single PyTorch call computes a
    # Chebyshev chain, so K5's library time is null; its k5_timing line has
    # the unfused chain's.  E2a-c are timed at k = 256 on (257, 2**22), E2a
    # at chunk 64 with a library time of two torch.mv per chunk (a sequence
    # of calls, no single one); none takes a bf16 matrix against a float32
    # vector with float32 accumulation, so E2c's is null.  E3's library
    # call is index_copy_ with k on the device; its entry adds the time per
    # call inside a captured CUDA graph (phase e3_graph), and its launches
    # count each captured call once (a replay launches without a call).  E1's launches are phase
    # e1's (its checks, the study's run and the timing) at the study's
    # 64 Mi-nnz operator; its library call is the BSR tensor product; its
    # entries add the time per call over runs of 50 back-to-back calls
    # (ms_per_call) beside the one-call ms.
    emit({"kernels": [
        entry("bsr_matvec", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1_REPLACES, launches["k1"], k1),
        entry("bsr_matvec_rsmk", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K2_REPLACES, sharded_launches["k2"], k2),
        entry("cgs_pass", "lanczos_tpu_torch/csrc/cgs.cu", K3_REPLACES, launches["k3"], k3),
        entry("cgs_pass_block", "lanczos_tpu_torch/csrc/cgs_block.cu", K4_REPLACES, flagship["k4"], k4),
        entry("cheby_chain_apply", "lanczos_tpu_torch/csrc/cheby_chain.cu", K5_REPLACES, cheby_launches["k5"], k5),
        entry("bcgs_mgs_pass", "lanczos_tpu_torch/csrc/bcgs_ring.cu", E2A_REPLACES, e2_launches["e2a"], e2["e2a"]),
        entry("cgs_single_pass", "lanczos_tpu_torch/csrc/bcgs_ring.cu", E2B_REPLACES, e2_launches["e2b"], e2["e2b"]),
        entry("cgs_shadow_pass", "lanczos_tpu_torch/csrc/cgs_variants.cu", E2C_REPLACES, e2_launches["e2c"], e2["e2c"]),
        {**entry("row_set", "lanczos_tpu_torch/csrc/row_set.cu", E3_REPLACES, e3_launches, e3),
         "graph_us_per_call": e3["graph_us_per_call"]["row_set"]},
        *({**entry(name, "lanczos_tpu_torch/csrc/spmv_variants.cu", replaces, e1_launches[name], e1[name]),
           "ms_per_call": e1[name]["ms_per_call"]}
          for name, replaces in (("spmv_v2", E1_V2_REPLACES), ("spmv_v2_vpu", E1_V2_REPLACES),
                                 ("spmv_v3", E1_V3_REPLACES))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
