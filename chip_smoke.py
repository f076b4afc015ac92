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
time grid over the main path's operator (K1), where ``run`` also runs in
both build modes (hybrid and fused) and ``run_batch`` runs beside single
runs; phase ``expm_small`` sets the two modes side by side on the main
path's chain cut to smaller widths.  The main path's K3 calls
are recorded, and phase ``k3_path`` replays the recorded k sequence and
sweeps K3 beside its bounds.  The precise tier runs on float64 bases from
float32 storage: ``pv_main_path`` is the main path with
``precise_vectors`` (kernel K1x, the float32 tiles against a float64
vector, with K3 and K6 in float64), ``sharded_pv`` the same over the
one-rank NCCL operator (K1x's rsmk form), ``pv_thick`` and
``pv_block_thick`` the JAX package's bounded-basis precise solve of an
n = 2**20 degenerate chain (K3, K4 in float64), ``precise_filter`` the
precise filtered solve with refined vectors and ``expm_precise`` the
precise evolution and Chebyshev chain at n = 2**20; phase ``k1x`` holds
K1x and its twin against their plain versions and scipy.  ROADMAP item 13:
phases ``k2c`` and ``k4c`` hold K2's and K4's complex instances against
their plain versions and time them, ``block_hermitian`` runs the block
thick engine on complex input (K4 complex64 and complex128), and
``sharded_engines`` runs, in the one-rank NCCL world of
``sharded_main_path``, the thick, block-thick, checkpointed, complex
(K2 complex) and precise thick solves over the main path's sharded
operator, and ``filtered_lanczos`` and the Exponentiator over a sharded
DIA chain (``lanczos_tpu_torch.parallel.engine_set``, the set that
``python3 -m lanczos_tpu_torch.parallel.multichip --ranks 4 --engines``
runs on four cards).  In the same world, phase ``grid_mesh`` runs the main path's
chain over a 1 x 1 ``GridMesh``'s combined axes (a ShardedDIAOperator) and
its n = 32768 construction stored dense through ``shard_dense_operator_2d``
(K3 and K6), each beside its unsharded solve.  Phase ``pack_bsr`` times the
host's numpy and native BSR packers once each on the main path's problem
and checks that they give the same tiles, and phase
``samples`` runs the port's twelve samples on the card and holds their
printed errors to their bars.  bfloat16 tiles (the JAX package's
``BSROperator(dtype=bfloat16)``): phase ``bf16_main_path`` runs the main
path's problem packed in bfloat16 through ``LambdaLanczos(op,
dtype=torch.float32)`` (K1's bfloat16 instance, no float32 K1 launch),
with ``precise_vectors`` (K1x bfloat16 x float64) and one
``Exponentiator.run``, against scipy on the rounded entries; its one-rank
NCCL twin (K2 bfloat16, K1x-rsmk bfloat16 x float64) runs in
``sharded_main_path``'s world as ``bf16_sharded``; phases ``k1bf16`` and
``k2bf16`` hold the four bfloat16 instances against their plain versions
and their float32-tile twins, each rmsk instance against its rsmk twin bit
for bit, and time them; ``k1bf16`` first prints K1x bfloat16's plans,
registers and spills (line ``bf16x64_plan``).  The launch counts are set to 0 just before
each path and read just after it.
Every phase prints one JSON line; any failure raises, so the script exits
non-zero and prints no result.  The last two lines are the kernel table and
the device line.  It needs a CUDA device and fails at once without one; it
imports no JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
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
# K6 replaces no pallas_call: the JAX fused engine's check is XLA ops in its device loop.
K6_REPLACES = ("lanczos_tpu/core/tridiagonal.py:322 extremal_eigenvalues_device "
               "(XLA ops in the fused loop, no pallas_call)")
# K1x replaces no pallas_call: the JAX package's precise BSR product is XLA ops.
K1X_REPLACES = ("lanczos_tpu/ops/operators.py:484 BSROperator.matvec_df "
                "(XLA ops, no pallas_call)")
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
EXPM_MODE_TOL = {"float32": 1e-6, "float64": 1e-12}  # fused against hybrid run, relative 2-norm
EXPM_BATCH_ROWS = 4  # seeded unit rows of the run_batch check, beside one zero row
# Widths of the expm_small cells (the main path's chain cut to them; 100 is
# the reference zoo's ring) and their scalar, one unit time step: 12-13
# iterations, inside the fused build's first stage of 16.
EXPM_SMALL_NS = (100, 2**12, 2**16, 2**18)
EXPM_SMALL_A = -1j
EXPM_SMALL_REPS = 15  # timed runs a mode in each expm_small cell (a few ms each; the host clock spreads)
HOST_TRIDIAG_M = 128  # the size of the host tridiagonal solves timed by backend
# The precise tier (ROADMAP item 10): K1x's bar against its plain version
# and a float64 scipy product, relative to max |y| (float64 rounding of a
# few hundred products a row); the JAX package's accuracy bars of each
# precise path (BASELINE.md), as ISSUE 13 set them.
K1X_TOL = 1e-13
PV_MAIN_BAR = 1e-11  # pv_main_path eigenvalues against scipy eigsh on the same float32 entries
PV_THICK_N, PV_THICK_NB = 2**20, 128  # bench.py sec_pv_thick: the block-diagonal chain
PV_THICK_BAR = 1e-10
PRECISE_FILTER_N = 4000  # bench.py sec_precise_filter
PRECISE_FILTER_BAR, PRECISE_FILTER_RES_BAR = 1e-12, 1e-10
EXPM_PRECISE_N = 2**20  # bench.py sec_expm_evolve_precise and sec_expm_cheby
EVOLVE_PRECISE_BAR, CHEBY_PRECISE_BAR = 1e-10, 1e-12
# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (the kernels use plain FMAs).
# Complex Hermitian input (ROADMAP item 11): K1's, K1x's and K3's complex
# instances against their plain versions, relative to max |y| (complex64 at
# K1's float32 bar, complex128 at its float64 one, K1x's at K1X_TOL).
K1C_TOL = {"complex64": 1e-5, "complex128": 1e-12, "complex64x128": K1X_TOL}
K3C_TOL = {"complex64": 1e-5, "complex128": 1e-12}
HERM_MAIN_BAR, HERM_RES_BAR, HERM_OVERLAP_BAR = 1e-5, 1e-3, 1e-4  # main_path's bars; 1 - |<U v, v'>|
HOF_ALPHA = 0.25  # Harper-Hofstadter flux per plaquette, q = 4
HOF_L, HOF_L_PRECISE = 64, 256  # lattice sides of the facade's complex64 and complex128 solves
HOF_C64_BAR, HOF_C128_BAR, HOF_SIGMA_BAR = 1e-5, 1e-11, 1e-10
HOF_SIGMA = -1.85  # inside the spectrum, in the gap between its first two bands
# The complex64 solves' tolerance: at 1e-6 the fused engine's float32 check
# stalls on the lowest band's clustered Ritz values (2540 iterations in a
# round, 85 s on the H100, against 128-284 at 1e-5), with the same values.
HOF_C64_TOL = 1e-5
HERM_EVOLVE_BAR, HERM_CHEBY_BAR, HERM_PRECISE_BAR = EVOLVE_ANGLE_BAR, CHEBY_ANGLE_BAR, 1e-12
# bfloat16 tiles (ROADMAP queue 2): K1 and K2 bfloat16 against their plain
# versions and their float32-tile twins over the widened tiles, relative to
# max |y| (float32 sums in another order), K1x's at K1X_TOL; the bfloat16
# main path's bars are the main path's (values against scipy on the rounded
# entries, residuals), its precise run's PV_MAIN_BAR; its Exponentiator run
# against float32 tiles holding the same values, as a state angle.
BF16_TOL = 1e-5
BF16_MAIN_BAR, BF16_RES_BAR, BF16_EXPM_ANGLE_BAR = 1e-5, 1e-3, 1e-5
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12  # float64 outside the tensor cores (the same data sheet)


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


def bound(bytes_moved: float, flops: float, flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: bytes
    over the data-sheet HBM rate or operations over the data-sheet rate of
    their type (float32 by default), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), in float64 (complex128
    for complex tensors)."""
    import torch

    wide = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    err = float((got.to(wide) - want.to(wide)).abs().max())
    return err, err / max(float(want.to(wide).abs().max()), 1e-300)


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
    """The CUDA library (one nvcc per source, in parallel) and, beside it on
    a thread, the g++ host library of the native tridiagonal backends."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native_build.shared_object_path)
        lib = _build.library()
        host_lib = host.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib._name, "host_library": str(host_lib),
          "sources": [str(p.relative_to(_build.CSRC_DIR.parent.parent))
                      for p in (*_build.sources(), native_build.SOURCE)]})


def phase_host_tridiagonal(np):
    """The host tridiagonal backends on the card's host: ``auto`` must
    resolve to the port's native library, as in the JAX package; the
    eigensolve and the extremal eigenvalues of a seeded, strongly coupled
    m = 128 tridiagonal (extended eigenvectors, as a Lanczos build gives;
    the bisection backend's recurrence misses the vectors of near-equal
    eigenvalues) by each backend, against numpy, by host clock."""
    from lanczos_tpu_torch.core import tridiagonal

    resolved = tridiagonal._resolve_backend("auto")
    if resolved != "native":
        raise AssertionError(f"tridiag_backend 'auto' resolved to {resolved!r}, not 'native'")
    m, reps = HOST_TRIDIAG_M, 20
    rng = np.random.default_rng(SEED + 11)
    alpha, beta = 0.3 * rng.standard_normal(m), rng.uniform(0.5, 1.0, m - 1)
    exact = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1))
    tol = 1e-12 * np.abs(exact).max()

    def host_ms(fn):
        out = fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    results = {}
    for backend in ("native", "bisect", "lapack"):
        (w, z), eigh_ms = host_ms(lambda: tridiagonal.eigh_tridiagonal_host(alpha, beta, backend=backend))
        ext, ext_ms = host_ms(lambda: tridiagonal.extremal_eigvals_host(alpha, beta, 3, False, backend=backend))
        t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
        residual = float(np.abs(t @ z.T - z.T * w).max())
        if not (np.abs(w - exact).max() <= tol and np.abs(ext - exact[:3]).max() <= tol and residual <= 1e-10):
            raise AssertionError(f"host tridiagonal {backend}: eigenvalue error {np.abs(w - exact).max():.3e}, "
                                 f"extremal {np.abs(ext - exact[:3]).max():.3e}, residual {residual:.3e}")
        results[backend] = {"eigh_ms": eigh_ms, "extremal3_ms": ext_ms, "max_eig_err": float(np.abs(w - exact).max()),
                            "max_residual": residual}
    emit({"phase": "host_tridiagonal", "auto": resolved, "m": m, "reps": reps, "host_ms": results,
          "unconverged_total": tridiagonal.unconverged_total()})


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


# K6's cases: (size, cap, nroot) at random tridiagonals, each dtype and
# both ends; caps above size leave rows the check must not read.
# The shared-memory route ends at 3600 rows in float32 and 1800 in float64;
# past 752 rows (f32) a CTA's dynamic and static shared memory exceed the
# default 48 KB.
K6_CASES = ((3, 3, 5), (17, 20, 3), (64, 64, 5), (128, 128, 5), (176, 256, 3), (256, 256, 5), (600, 640, 3),
            (760, 800, 2), (1024, 1024, 5), (1800, 1800, 2), (1801, 1850, 1), (3600, 3600, 1), (3601, 3601, 2))
K6_TIMED = (128, 5)  # K6's timed case: the check at k = 128 with 5 roots, float32


def _k6_tridiagonal(np, rng, cap, size):
    """alpha N(0, 1), beta U(0.1, 1) with a few exact zeros inside the live
    block, and garbage past it."""
    alpha = rng.standard_normal(cap)
    beta = rng.uniform(0.1, 1.0, cap)
    if size > 4:
        beta[rng.choice(size - 1, max(1, size // 40), replace=False)] = 0.0
    alpha[size:] = 1e30
    beta[size:] = -7.0
    return alpha, beta


def k6_flops(size, nroot, rounds, points=15):
    """Floating-point operations of one K6 multisection: per round and
    cut, the rows' set-up (a subtraction and a square) and each scan step's
    products (8 multiplications, 4 additions and 4 divisions a row), the
    work of these inputs (no early exit)."""
    steps = []
    s = 1
    while s < size:
        steps.append(size - s)
        s *= 2
    return rounds * nroot * points * (2 * size + 16 * sum(steps)), len(steps)


def phase_k6(torch, np, dev):
    """K6 (the fused engine's convergence check, csrc/sturm_check.cu)
    against its plain version on the same device tensors, bit for bit, in
    both modes: the multisection (extremal_eigenvalues_device) over
    K6_CASES in float32 and float64, both ends, on both routes; the check
    (convergence_check) with a breakdown, with eps = 0 (the screen alone),
    converging and not.  Then the timed case beside the plain version on
    the card and on the host CPU."""
    import scipy.linalg

    from lanczos_tpu_torch.core import tridiagonal
    from lanczos_tpu_torch.ops import sturm_check

    rng = np.random.default_rng(SEED + 12)
    cases, routes, worst = 0, collections.Counter(), 0.0
    for dtype in (torch.float32, torch.float64):
        for size, cap, nroot in K6_CASES:
            alpha_np, beta_np = _k6_tridiagonal(np, rng, cap, size)
            alpha = torch.tensor(alpha_np, dtype=dtype, device=dev)
            beta = torch.tensor(beta_np, dtype=dtype, device=dev)
            routes[sturm_check.plan(size, nroot, alpha.element_size()).route] += 1
            exact = scipy.linalg.eigvalsh_tridiagonal(alpha.double().cpu().numpy()[:size],
                                                      beta.double().cpu().numpy()[: size - 1])
            for fm in (False, True):
                launches = sturm_check.sturm_check.launches
                got = tridiagonal.extremal_eigenvalues_device(alpha, beta, size, nroot, fm)
                want = tridiagonal.extremal_eigenvalues_reference(alpha, beta, size, nroot, fm)
                torch.cuda.synchronize()
                if sturm_check.sturm_check.launches != launches + 1:
                    raise AssertionError("K6 multisection: not one launch")
                err = float((got.double() - want.double()).abs().max())
                if not (err == 0.0 and torch.equal(got, want)):
                    raise AssertionError(f"K6 {dtype} size={size} cap={cap} nroot={nroot} max={fm}: "
                                         f"max abs error {err} against its plain version")
                k = min(nroot, size)
                ref = exact[::-1][:k] if fm else exact[:k]
                scale = np.abs(alpha_np[:size]).sum() + 2 * np.abs(beta_np[: size - 1]).sum()
                tol = (1e-4 if dtype == torch.float32 else 1e-12) * scale
                if not np.abs(got.double().cpu().numpy()[:k] - ref).max() <= tol:
                    raise AssertionError(f"K6 {dtype} size={size}: {got[:k].tolist()} against eigvalsh {ref}")
                worst = max(worst, err)
                cases += 1

    # The check: both sides from the same buffers and previous estimate.
    checks = []
    for dtype in (torch.float32, torch.float64):
        cap, nroot = 256, 3
        alpha_np, beta_np = _k6_tridiagonal(np, rng, cap, cap)
        beta_np[beta_np == 0.0] = 0.5
        alpha = torch.tensor(alpha_np, dtype=dtype, device=dev)
        beta = torch.tensor(beta_np, dtype=dtype, device=dev)
        eps_m = float(torch.finfo(dtype).eps)
        settled = tridiagonal.extremal_eigenvalues_reference(alpha[:176], beta[:176], 176, nroot, False)
        broken = beta.clone()
        broken[150] = 0.1 * eps_m
        for label, b, screened, k, eps, prev, have_prev in (
            ("not_converged", beta, 172, 176, 1e-6, torch.full((nroot,), float("inf"), dtype=dtype, device=dev), True),
            ("converged", beta, 172, 176, 1e-6, settled.clone(), True),
            ("no_previous", beta, 172, 176, 1e-6, settled.clone(), False),
            ("benchmark_eps", beta, 172, 176, -1.0, settled.clone(), True),
            ("breakdown", broken, 140, 176, 1e-6, settled.clone(), True),
            ("screen_only", broken, 140, 176, 0.0, settled.clone(), True),
            ("screen_clean", beta, 140, 176, 0.0, settled.clone(), True),
        ):
            kw = dict(screened=screened, k=k, nroot=nroot, find_maximum=False, eps=eps,
                      breakdown_eps=eps_m * 10.0, have_prev=have_prev)
            prev_k6, prev_plain = prev.clone(), prev.clone()
            launches = sturm_check.sturm_check.launches
            got = tridiagonal.convergence_check(alpha, b, prev_k6, **kw).tolist()
            want = tridiagonal.convergence_check_reference(alpha, b, prev_plain, **kw).tolist()
            if sturm_check.sturm_check.launches != launches + 1:
                raise AssertionError(f"K6 check {label}: not one launch")
            if got != want or not torch.equal(prev_k6, prev_plain):
                raise AssertionError(f"K6 check {label} {dtype}: {got} / {prev_k6.tolist()} against the plain "
                                     f"{want} / {prev_plain.tolist()}")
            checks.append({"case": label, "dtype": str(dtype), "stop_itern": got})
    expect = {"not_converged": [0, 0], "converged": [2, 176], "no_previous": [0, 0], "benchmark_eps": [0, 0],
              "breakdown": [1, 151], "screen_only": [1, 151], "screen_clean": [0, 0]}
    for c in checks:
        if c["stop_itern"] != expect[c["case"]]:
            raise AssertionError(f"K6 check {c}: expected {expect[c['case']]}")

    # The timed case: one launch, the bound's ops beside it, the plain
    # version on the card and on the host CPU.
    size, nroot = K6_TIMED
    alpha_np, beta_np = _k6_tridiagonal(np, rng, size, size)
    alpha = torch.tensor(alpha_np, dtype=torch.float32, device=dev)
    beta = torch.tensor(beta_np, dtype=torch.float32, device=dev)
    rounds = tridiagonal._rounds(torch.float32, None, 15)
    _, limit = tridiagonal._limit(alpha, beta, size)
    kernel = functools.partial(sturm_check.sturm_check, alpha, beta, limit, size=size, nroot=nroot,
                               find_maximum=False, rounds=rounds)
    got = kernel()
    want = tridiagonal.extremal_eigenvalues_reference(alpha, beta, size, nroot, False)
    max_abs_err = float((got - want).abs().max())
    if max_abs_err != 0.0:
        raise AssertionError(f"K6 timed case: max abs error {max_abs_err}")
    ms = cuda_ms(torch, kernel)
    ms_per_call = cuda_ms_per_call(torch, kernel, calls=20, reps=5)  # back to back: the host's launch path hidden
    # One PyTorch kernel before and after K6's launches tells a window that
    # traced nothing (no CUPTI tracing on the machine: the device time is not
    # measured and the CUDA-event times above stand alone) from one that
    # traced the card and missed K6 (a failure).
    marker = torch.zeros(1, device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for _ in range(10):
            kernel()
        marker.add_(1)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k6_events = [e for e in device_events if "sturm_check_kernel" in e.name]
    device_ms_reason = None
    if not device_events:
        device_ms, device_ms_reason = None, "the profiler recorded no CUDA kernel event (no CUPTI tracing)"
    elif len(k6_events) != 10:
        raise AssertionError(f"the profiler saw {len(k6_events)} K6 launches of 10 among {len(device_events)} "
                             "CUDA events")
    else:
        device_ms = statistics.median((e.time_range.end - e.time_range.start) / 1e3 for e in k6_events)
    with_limit_ms = cuda_ms(torch, lambda: tridiagonal.extremal_eigenvalues_device(alpha, beta, size, nroot, False))
    plain_ms = cuda_ms(torch, lambda: tridiagonal.extremal_eigenvalues_reference(alpha, beta, size, nroot, False),
                       reps=5, warmup=1)
    alpha_h, beta_h = alpha.cpu(), beta.cpu()
    tridiagonal.extremal_eigenvalues_reference(alpha_h, beta_h, size, nroot, False)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        tridiagonal.extremal_eigenvalues_reference(alpha_h, beta_h, size, nroot, False)
        host.append((time.perf_counter() - t0) * 1e3)
    # The whole device check as the engine runs it (the bound's ops, one
    # launch, the eight-byte read), by host clock on an idle device.
    prev = torch.full((nroot,), float("inf"), device=dev)
    eps_m = float(torch.finfo(torch.float32).eps)
    check = functools.partial(tridiagonal.convergence_check, alpha, beta, prev, screened=size - 4, k=size,
                              nroot=nroot, find_maximum=False, eps=1e-6, breakdown_eps=10 * eps_m, have_prev=True)
    check().tolist()
    full = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check().tolist()
        full.append((time.perf_counter() - t0) * 1e3)
    flops, steps = k6_flops(size, nroot, rounds)
    bytes_moved = (2 * size + 1 + nroot) * 4
    bound_ms, bound_by = bound(bytes_moved, flops)
    out = {"phase": "k6", "cases": cases, "routes": dict(routes), "max_abs_err_all": worst, "checks": checks,
           "timed": {"size": size, "nroot": nroot, "dtype": "float32", "rounds": rounds, "points": 15},
           "max_abs_err": max_abs_err, "ms": ms, "ms_per_call": ms_per_call, "device_ms": device_ms,
           "device_ms_reason": device_ms_reason, "profiled_cuda_events": len(device_events),
           "with_limit_ms": with_limit_ms, "plain_ms": plain_ms,
           "plain_host_cpu_ms": statistics.median(host), "device_check_ms": statistics.median(full),
           "flops": flops, "bytes": bytes_moved, "bound_ms": bound_ms, "bound_by": bound_by,
           "dependent_steps": rounds * steps, "library_ms": None}
    emit(out)
    return out


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

    def recorder(v, basis, k, reduce=None):
        if int(k) > 0 and v.device.type == "cuda":
            seq.append((basis.shape[0], basis.shape[1], int(k), str(basis.dtype)))
        return real(v, basis, k, reduce)

    recorder.launches = real.launches
    cgs.cgs_pass = recorder
    try:
        yield seq
    finally:
        cgs.cgs_pass = real
        real.launches = recorder.launches


@contextlib.contextmanager
def counting_checks():
    """Count the fused engine's convergence checks while the context is
    open: K6 launches (from 0), the host reads of the checks' decisions and
    their bytes; and refuse a CUDA tensor at the checks' plain versions (a
    check on the card must be K6).  Yields a dict filled on exit."""
    from lanczos_tpu_torch.core import tridiagonal
    from lanczos_tpu_torch.ops import sturm_check
    from lanczos_tpu_torch.solvers import lanczos_fused

    stats = {"k6_launches": 0, "checks": 0, "bytes_read": []}
    read, refs = lanczos_fused._read_decision, {}

    def counted_read(out):
        stats["checks"] += 1
        stats["bytes_read"].append(out.numel() * out.element_size())
        return read(out)

    def guarded(name):
        fn = getattr(tridiagonal, name)

        def plain(alpha, *args, **kwargs):
            if alpha.device.type == "cuda":
                raise AssertionError(f"a CUDA tensor reached {name} on the main path")
            return fn(alpha, *args, **kwargs)
        refs[name] = fn
        return plain

    for name in ("convergence_check_reference", "extremal_eigenvalues_reference"):
        setattr(tridiagonal, name, guarded(name))
    lanczos_fused._read_decision = counted_read
    sturm_check.sturm_check.launches = 0
    try:
        yield stats
    finally:
        stats["k6_launches"] = sturm_check.sturm_check.launches
        lanczos_fused._read_decision = read
        for name, fn in refs.items():
            setattr(tridiagonal, name, fn)
        b = stats["bytes_read"]
        stats["bytes_read_per_check"] = max(b) if b else 0
        del stats["bytes_read"]


def check_stats(stats) -> dict:
    """The counts of :func:`counting_checks`, held to one K6 launch and one
    read of at most 16 bytes per check."""
    if not (stats["checks"] > 0 and stats["k6_launches"] == stats["checks"] and stats["bytes_read_per_check"] <= 16):
        raise AssertionError(f"checks {stats}: expected one K6 launch and one read of <= 16 bytes per check")
    return stats


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
    code = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}[dtype]
    err = _build.library().lt_cgs_block_info(code, b, plan.cols, plan.stages, dev.index, out)
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


def _main_path_coo(np, n=MAIN_N):
    """The main path's problem (``multichip.main_path_coo``): the n = 2**20
    hopping chain with a random on-site potential and three deep sites
    (three bound states below the band); ``n`` cuts it."""
    from lanczos_tpu_torch.parallel.multichip import main_path_coo

    return main_path_coo(n)


def _main_path_engine(tl, torch, op, dtype=None):
    """LambdaLanczos over ``op`` as the main path configures it
    (``multichip.main_path_engine``; vectors in ``dtype``: the operator's
    by default, float32 for bfloat16 tiles)."""
    from lanczos_tpu_torch.parallel.multichip import main_path_engine

    return main_path_engine(op, dtype)


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
    with recording_k3(cgs) as k3_seq, counting_checks() as checks:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches, "k6": checks["k6_launches"]}
    if not (launches["k1"] > 0 and launches["k3"] > 0 and launches["k3"] == len(k3_seq)):
        raise AssertionError(f"main path did not launch both kernels: {launches}, {len(k3_seq)} K3 calls recorded")
    check_stats(checks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Where the solve waits for the device (a second, untimed run under
    # the sync debug mode): the checks' reads and the rounds' Ritz reads.
    _, waits = host_waits(torch, eng.run)

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
          "reorth_count": eng.stats.reorth_count, "launches": launches, "checks": checks,
          "host_waits": len(waits), "host_wait_sites": dict(collections.Counter(waits)),
          "peak_device_gb": peak_gb, "scipy_s": scipy_s})

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
        tridiagonal.extremal_eigenvalues_reference(alpha, beta, 128, 5, False)
    check_ms = (time.perf_counter() - t0) / 5 * 1e3
    # The same check on the card as the engine runs it: the bound's torch
    # ops, one K6 launch and the eight-byte read, by host clock.
    alpha, beta = alpha.to(dev), beta.to(dev)
    prev = torch.full((5,), float("inf"), device=dev)
    kw = dict(screened=124, k=128, nroot=5, find_maximum=False, eps=1e-6, breakdown_eps=1.2e-6, have_prev=True)
    lanczos_fused._read_decision(tridiagonal.convergence_check(alpha, beta, prev, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lanczos_fused._read_decision(tridiagonal.convergence_check(alpha, beta, prev, **kw))
    device_ms = (time.perf_counter() - t0) / 20 * 1e3
    emit({"phase": "iteration_rates", "n": n, "rows": 128, "iterations_per_s": rates, "host_check_ms_k128_f32": check_ms,
          "device_check_ms_k128_f32": device_ms})
    return launches, k1, k3, op, ref, eng.iteration_counts, k3_seq, (evecs, wall)


def phase_operators(torch, np, dev, ref):
    """The main path's problem (n = 2**20, float32, fused, three pairs)
    through the plain-PyTorch operators: ``CSROperator.from_scipy`` of its
    scipy matrix (its matvec against scipy's in float64, and bit for bit
    on repeat: a fixed sum order), ``SumOperator`` of a DIA hopping term
    and a COO potential, and ``ScaledOperator`` of the CSR operator (2 A +
    1); each solve within 1e-5 of scipy's ``eigsh``.  Then a
    ``CheckpointedRun`` over the CSR operator, one pair a deflated
    restart, stopped after its first restart and resumed from its file:
    the uninterrupted run's eigenvalues and counts."""
    import tempfile

    import scipy.sparse

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs
    from lanczos_tpu_torch.solvers import lanczos as tlz
    from lanczos_tpu_torch.utils import checkpoint

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np)
    mat = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    csr = tl.CSROperator.from_scipy(mat, dtype=torch.float32, device=dev)
    x = np.random.default_rng(SEED + 13).standard_normal(n)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    y, y2 = csr.matvec(xt), csr.matvec(xt)
    want = mat @ x.astype(np.float32).astype(np.float64)
    matvec_rel = float(np.abs(y.double().cpu().numpy() - want).max() / np.abs(want).max())
    if not (torch.equal(y, y2) and matvec_rel <= 1e-6):
        raise AssertionError(f"CSR matvec: relative error {matvec_rel:.2e}, repeat equal {torch.equal(y, y2)}")
    matvec_ms = cuda_ms(torch, lambda: csr.matvec(xt))

    pot = vals[2 * (n - 1):]
    dia = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, dtype=torch.float32, device=dev)
    coo = tl.COOOperator.from_arrays(np.arange(n), np.arange(n), pot.astype(np.float32), n, device=dev)
    cases = {"csr": (csr, 1.0, 0.0), "sum_dia_coo": (tl.SumOperator([dia, coo]), 1.0, 0.0),
             "scaled_csr": (tl.ScaledOperator(csr, 2.0, 1.0), 2.0, 1.0)}
    solves = {}
    for label, (op, scale, shift) in cases.items():
        eng = _main_path_engine(tl, torch, op)
        cgs.cgs_pass.launches = 0
        with counting_checks() as checks:
            t0 = time.perf_counter()
            evals, evecs = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_stats(checks)
        got = (np.asarray(evals) - shift) / scale
        rel = np.abs(got - ref) / np.abs(ref)
        residuals = eng.residuals(evals, evecs)
        if not (np.all(np.isfinite(evals)) and np.all(rel <= 1e-5) and max(residuals) <= 1e-3 * scale):
            raise AssertionError(f"operators {label}: eigenvalues {got} vs scipy {ref} ({rel}), residuals {residuals}")
        solves[label] = {"eigenvalues": list(map(float, evals)), "max_rel_err": float(rel.max()),
                         "residuals": residuals, "iteration_counts": eng.iteration_counts, "wall_s": wall,
                         "k3_launches": cgs.cgs_pass.launches, "k6_launches": checks["k6_launches"]}

    def checkpoint_engine():
        eng = _main_path_engine(tl, torch, csr)
        eng.num_eigs_per_iteration = 1  # one pair a deflated restart: three restarts
        return eng

    class Interrupt(Exception):
        pass

    driver = tlz.deflation_driver

    def one_round(*args, after_round, **kwargs):
        def save_then_stop(manager, counts, finished):
            after_round(manager, counts, finished)
            raise Interrupt
        return driver(*args, after_round=save_then_stop, **kwargs)

    whole = checkpoint_engine()
    vals_whole, _ = whole.run()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/main_path_csr.npz"
        tlz.deflation_driver = one_round
        try:
            checkpoint.CheckpointedRun(checkpoint_engine(), path).run()
            raise AssertionError("the interrupted run was not interrupted")
        except Interrupt:
            pass
        finally:
            tlz.deflation_driver = driver
        saved, saved_counts = checkpoint.load_state(path, device=dev)
        resumed = checkpoint_engine()
        t0 = time.perf_counter()
        vals_resumed, vecs_resumed = checkpoint.CheckpointedRun(resumed, path).run()
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
    rel = np.abs(np.asarray(vals_resumed) - ref) / np.abs(ref)
    if not (len(saved) == 1 and saved_counts == whole.iteration_counts[:1]
            and resumed.iteration_counts == whole.iteration_counts and np.all(rel <= 1e-5)
            and np.array_equal(np.asarray(vals_resumed), np.asarray(vals_whole))):
        raise AssertionError(f"checkpointed run: saved {len(saved)} pairs / {saved_counts}, resumed "
                             f"{resumed.iteration_counts} {vals_resumed} against {whole.iteration_counts} {vals_whole}")
    out = {"phase": "operators", "n": n, "dtype": "float32", "csr_matvec_max_rel_err": matvec_rel,
           "csr_matvec_ms": matvec_ms, "solves": solves,
           "checkpoint": {"saved_pairs": len(saved), "saved_counts": saved_counts,
                          "resumed_counts": resumed.iteration_counts, "whole_counts": whole.iteration_counts,
                          "eigenvalues": list(map(float, vals_resumed)), "max_rel_err": float(rel.max()),
                          "resume_wall_s": resume_wall}}
    emit(out)
    return out


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


def phase_sharded_main_path(torch, np, dev, ref, main_iters, pv_ref, thick, herm, chain, bf16):
    """The main path's problem over a ShardedBSROperator in a one-rank NCCL
    process group: the fused engine on the rank's slab (the whole vector),
    the all-gather and the all-reduces over NCCL, the local SpMV on K2;
    then, in the same group, with ``precise_vectors`` (:func:`sharded_pv`,
    its own line and seconds), and every other engine over row slabs
    (:func:`sharded_engines`, its own lines and seconds), the 2-D mesh
    (:func:`grid_mesh`), the bfloat16 main path (:func:`sharded_bf16`) and
    the port's dryrun (:func:`phase_multichip`)."""
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
        with counting_checks() as checks:
            t0 = time.perf_counter()
            evals, evecs = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"k1": spmv.bsr_matvec.launches, "k2": spmv.bsr_matvec_rsmk.launches, "k3": cgs.cgs_pass.launches,
                    "k6": checks["k6_launches"]}
        if not (launches["k2"] > 0 and launches["k1"] == 0 and launches["k3"] > 0):
            raise AssertionError(f"sharded main path: launches {launches} (K2 and K3 expected, no K1)")
        check_stats(checks)
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
              "launches": launches, "checks": checks, "peak_device_gb": peak_gb})
        t0 = time.perf_counter()
        pv = sharded_pv(torch, np, op, pv_ref)
        pv["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv["engines"] = sharded_engines(torch, np, mesh, op, ref, thick, herm, pv_ref, chain)
        pv["engines_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grid_mesh(torch, np, dev, ref)
        pv["grid_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv["bf16"] = sharded_bf16(torch, np, mesh, bf16)
        pv["bf16_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_multichip()
        pv["multichip_seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return launches, op, pv


def phase_multichip():
    """Phase ``multichip``, in the one-rank NCCL world of
    ``sharded_main_path``: the port's ``dryrun_multichip``, the JAX
    package's dryrun regimes with their shapes, seeds and bars (3 and 6 need
    an even world above one rank and are skipped, as the JAX dryrun skips
    them on one device).  It raises on a missed bar.  Its four-card run is
    ``python3 -m lanczos_tpu_torch.parallel.multichip --ranks 4 [--full]``."""
    from lanczos_tpu_torch.parallel import multichip

    t0 = time.perf_counter()
    records = multichip.dryrun_multichip(1, emit=None)
    emit({"phase": "multichip", "world": 1, "seconds": time.perf_counter() - t0, "regimes": records})


GRID_DENSE_N = 32768  # the main path's chain stored dense: 4.3 GB of float32


def _grid_solve(torch, tl, cgs, op):
    """The main path's engine over ``op``, its launches counted from 0:
    ``(values, vectors, engine, wall s, launches)``."""
    eng = _main_path_engine(tl, torch, op)
    cgs.cgs_pass.launches = 0
    with counting_checks() as checks:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_stats(checks)
    return evals, evecs, eng, wall, {"k3": cgs.cgs_pass.launches, "k6": checks["k6_launches"]}


def grid_mesh(torch, np, dev, ref):
    """Phase ``grid_mesh``, in the one-rank NCCL world of
    ``sharded_main_path``: a 1 x 1 GridMesh (``make_multislice_mesh``) on
    the card.  (a) The main path's chain (f32, three pairs, eps 1e-6) as a
    ShardedDIAOperator over the grid's combined axes, beside the unsharded
    DIAOperator solve, against the main path's scipy values at its bar.
    (b) The main path's construction at n = 32768 stored dense on the card
    through ``shard_dense_operator_2d``, beside the unsharded DenseOperator
    solve, against ``scipy.linalg.eigh_tridiagonal``.  K3 and K6 counted
    from 0 for each solve.  One card holds only a 1 x 1 grid (NCCL puts no
    two ranks on one device), so batched slices and a 2 x 2 grid run in the
    CPU tests' gloo worlds only."""
    import scipy.linalg

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, spmv
    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedDIAOperator

    grid = pmesh.make_multislice_mesh(1)
    if grid.shape != (1, 1) or grid.combined.device != dev:
        raise AssertionError(f"grid {grid.shape} on {grid.combined.device}")
    out = {"phase": "grid_mesh", "grid": list(grid.shape), "device": str(dev),
           "not_on_the_card": "batched slices and a 2 x 2 grid need several ranks; one card holds one NCCL rank, so "
                              "they run in the CPU tests' gloo worlds only"}

    def held(evals, evecs, eng, want, label):
        rel = np.abs(np.asarray(evals) - want) / np.abs(want)
        residuals = eng.residuals(evals, evecs)
        if not (np.all(np.isfinite(evals)) and bool(torch.isfinite(evecs).all()) and np.all(rel <= 1e-5)
                and max(residuals) <= 1e-3):
            raise AssertionError(f"grid_mesh {label}: {evals} vs {want} (relative {rel}), residuals {residuals}")
        return float(rel.max()), residuals

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np, n)
    diags = [np.full(n, -1.0), vals[2 * (n - 1):], np.full(n, -1.0)]
    cases = {"combined_dia": ShardedDIAOperator.from_diagonals([-1, 0, 1], diags, n, grid.combined, dtype=torch.float32),
             "dia": tl.DIAOperator.from_diagonals([-1, 0, 1], diags, n, dtype=torch.float32, device=dev)}
    for label, op in cases.items():
        spmv.bsr_matvec.launches = 0
        evals, evecs, eng, wall, launches = _grid_solve(torch, tl, cgs, op)
        rel, residuals = held(evals, evecs, eng, ref, label)
        if launches["k3"] == 0 or launches["k6"] == 0 or spmv.bsr_matvec.launches:
            raise AssertionError(f"grid_mesh {label}: launches {launches}, K1 {spmv.bsr_matvec.launches}")
        out[label] = {"n": n, "eigenvalues": list(map(float, evals)), "max_rel_err": rel, "residuals": residuals,
                      "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches": launches}
    del cases, op, evecs
    torch.cuda.empty_cache()

    m = GRID_DENSE_N
    rows, cols, vals = _main_path_coo(np, m)
    pot = vals[2 * (m - 1):]
    want = scipy.linalg.eigh_tridiagonal(pot, -np.ones(m - 1), eigvals_only=True, select="i", select_range=(0, 2))
    a = torch.zeros((m, m), dtype=torch.float32, device=dev)
    a[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)] = torch.from_numpy(vals).to(dev, torch.float32)
    t0 = time.perf_counter()
    op2d = pmesh.shard_dense_operator_2d(a, grid)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    # The grid column's first collective creates its NCCL communicator: a
    # one-off cost of the process group, timed apart from the solve.
    t0 = time.perf_counter()
    op2d.matvec(torch.zeros(op2d.n_local, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    first_collective_s = time.perf_counter() - t0
    for label, op in (("dense_2d", op2d), ("dense", tl.DenseOperator(a, device=dev))):
        evals, evecs, eng, wall, launches = _grid_solve(torch, tl, cgs, op)
        rel, residuals = held(evals, evecs, eng, want, label)
        if launches["k3"] == 0 or launches["k6"] == 0:
            raise AssertionError(f"grid_mesh {label}: launches {launches}")
        out[label] = {"n": m, "gb": m * m * 4 / 1e9, "eigenvalues": list(map(float, evals)),
                      "eigh_tridiagonal": list(map(float, want)), "max_rel_err": rel, "residuals": residuals,
                      "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches": launches}
    out["dense_2d"]["shard_s"] = shard_s
    out["dense_2d"]["first_collective_s"] = first_collective_s
    del a, op2d, op, evecs
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_pack_bsr(np):
    """The COO -> BSR packing of the main path's problem on the host, timed
    once each: the numpy packer (``_pack_bsr``, which ``BSROperator.from_coo``
    uses) in the kernel's layout, and the host library's ``pack_bsr`` (the
    JAX package's name; its tiles, not yet placed in a layout).  The numpy
    packer's tiles, gathered in block-id order, must be ``pack_bsr``'s bit
    for bit."""
    from lanczos_tpu_torch.native import host_kernels
    from lanczos_tpu_torch.ops.operators import _pack_bsr

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np, n)
    if not host_kernels.available():
        raise AssertionError("the host library did not build")
    t0 = time.perf_counter()
    blocks, col_blocks = _pack_bsr(rows, cols, vals, n, 128, 128, np.float32, "rmsk")
    t1 = time.perf_counter()
    ids, tiles = host_kernels.pack_bsr(rows, cols, vals, n // 128, 128, 128, dtype=np.float32)
    t2 = time.perf_counter()
    rb = ids // (n // 128)
    slot = np.arange(ids.shape[0]) - np.concatenate([[0], np.cumsum(np.bincount(rb, minlength=n // 128))])[rb]
    equal = (np.array_equal(col_blocks[rb, slot], ids % (n // 128))
             and blocks.transpose(0, 2, 1, 3)[rb, slot].tobytes() == tiles.tobytes())
    if not equal:
        raise AssertionError("pack_bsr: the numpy packer's tiles are not the host library's")
    emit({"phase": "pack_bsr", "n": n, "nnz": int(rows.shape[0]), "dtype": "float32", "tiles": int(ids.shape[0]),
          "numpy_pack_ms": (t1 - t0) * 1e3, "native_pack_bsr_ms": (t2 - t1) * 1e3, "equal": True})


SAMPLE_TIMEOUT_S = 180
SAMPLE_WORKERS = 4  # samples run side by side on the card, each in its own process


def phase_samples():
    """The port's twelve samples (``lanczos_tpu_torch/samples``) on the
    card: each ``python -m lanczos_tpu_torch.samples.<name>`` with
    ``LT_SAMPLE_DEVICE=cuda``, ``SAMPLE_WORKERS`` at a time, under a
    ``SAMPLE_TIMEOUT_S`` timeout; every ``error`` line it prints is held to
    ``lanczos_tpu_torch.samples.BARS``."""
    import os
    from pathlib import Path

    from lanczos_tpu_torch.samples import BARS, SAMPLES, printed_errors

    root = Path(__file__).resolve().parent
    env = dict(os.environ, LT_SAMPLE_DEVICE="cuda", PYTHONPATH=str(root))

    def run(name):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"lanczos_tpu_torch.samples.{name}"], cwd=root, env=env,
                              capture_output=True, text=True, timeout=SAMPLE_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(SAMPLE_WORKERS) as pool:
        runs = dict(zip(SAMPLES, pool.map(run, SAMPLES)))
    out, failed = {}, []
    for name, (proc, wall) in runs.items():
        errors = printed_errors(proc.stdout)
        over = {k: v for k, v in errors.items() if not v <= BARS[name].get(k, -1.0)}
        ok = proc.returncode == 0 and set(errors) == set(BARS[name]) and not over
        out[name] = {"rc": proc.returncode, "wall_s": wall, "errors": errors, "bars": BARS[name]}
        if not ok:
            failed.append(name)
            print(f"sample {name} rc={proc.returncode} over={over}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
    emit({"phase": "samples", "device": "cuda", "workers": SAMPLE_WORKERS, "samples": out})
    if failed:
        raise AssertionError(f"samples failed on the card: {failed}")


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
    with counting_checks() as checks:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches, "k6": checks["k6_launches"]}
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"thick path did not launch both kernels: {launches}")
    check_stats(checks)
    rel = np.abs(np.asarray(evals) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    if not (np.all(np.isfinite(evals)) and bool(torch.isfinite(evecs).all()) and np.all(rel <= 1e-5)):
        raise AssertionError(f"thick: eigenvalues {evals} vs scipy {ref}: relative error {rel}")
    if not max(residuals) <= 1e-3:
        raise AssertionError(f"thick: residuals {residuals}")
    emit({"phase": "thick_scalar", "n": op.n, "dtype": "float32", "mode": eng._resolve_mode(), "max_iteration": 128,
          "eigenvalues": list(map(float, evals)), "max_rel_err": float(rel.max()), "residuals": residuals,
          "iteration_counts": eng.iteration_counts, "wall_s": wall,
          "iterations_per_s": sum(eng.iteration_counts) / wall, "launches": launches, "checks": checks})
    return {"iteration_counts": eng.iteration_counts, "eigenvalues": np.asarray(evals), "wall_s": wall}


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
        out, waits = host_waits(torch, lambda: ex.evolve(a_step, v_re, v_im, n_steps))
        torch.cuda.synchronize()
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
    # The states phase sharded_engines holds its one-rank ShardedDIAOperator
    # to: 100 steps of exp(0.05i H) and the chain for exp(5i H).
    from lanczos_tpu_torch.parallel.engine_set import chain_states

    t0 = time.perf_counter()
    states = chain_states(ex, v_re, v_im, 100)
    states_s = time.perf_counter() - t0
    emit({"phase": "expm_chain", "n": n, "dtype": "float32", "k_mode": k_mode, "a_step": str(a_step), "steps": steps,
          "krylov_dim": 12, "evolve_s": evolve_s, "evolve_ms_per_step": evolve_s / steps * 1e3,
          "evolve_angle": evolve_angle, "evolve_k3_launches": k3, "evolve_host_waits": waits,
          "evolve_host_waits_one_step": waits_1,
          "cheby_cold_s": cheby_s[0], "cheby_warm_s": cheby_s[1], "cheby_terms": terms, "cheby_angle": cheby_angle,
          "grid_s": grid_s,
          "grid_terms": grid_terms, "grid_angles": grid_angles,
          "bars": {"evolve": EVOLVE_ANGLE_BAR, "chebyshev": CHEBY_ANGLE_BAR}, "sharded_reference_states_s": states_s,
          "evolve_100x0.05i_s": states["evolve_s"]})
    return {"k3": k3, "states": states, "v0": v0}


def host_waits(torch, fn):
    """``fn()`` under PyTorch's sync debug mode: its result and where
    (file:line) each host wait for the device was issued."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def expm_timed(torch, spmv, cgs, fn, reps: int = 3):
    """``fn()`` (an Exponentiator call) after a warm-up: its result, and
    wall ms of ``reps`` runs by host clock (each ending in a synchronize),
    K1 and K3 launches per run, and the host waits of one more run."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        spmv.bsr_matvec.launches = 0
        cgs.cgs_pass.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches}
    _, waits = host_waits(torch, fn)
    return out, {"ms": ms, "ms_median": statistics.median(ms), "k1_launches": launches["k1"],
                 "k3_launches": launches["k3"], "host_waits": len(waits), "host_wait_sites": dict(collections.Counter(waits))}


def phase_expm_bsr(torch, np, dev, op):
    """The Exponentiator over the main path's BSROperator (n = 2**20,
    float32) from a seeded unit vector, and over a float64 copy of its
    tiles.  Both builds run K1 and stop at eps 1e-12 (float32) or the
    float64 default; every a has a real part, where the reference's stop
    test never fires (R7), so the budget EXPM_BSR_MAX_ITER also bounds a
    regression.

    - ``run_grid`` with a in (-0.1, -0.5, -1), float32 against float64.
    - ``run(-0.5, v)`` in mode 'hybrid' (a host wait and a host eigensolve
      per iteration) and 'fused' (a host read per stage of 16, then 64, ...
      queued iterations), with and without full reorthogonalization (K3):
      the same iteration count, outputs within EXPM_MODE_TOL; iterations
      built (K1 launches) against used, host waits, wall ms.
    - ``run_batch(-0.5, V)``, V EXPM_BATCH_ROWS seeded unit rows and one
      zero row, float32: each row's count and output those of ``run`` on
      it, the zero row zeros with 1 iteration; wall ms against the single
      runs."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, spmv

    a_list, a_run = [-0.1, -0.5, -1.0], -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    v = torch.randn(op.n, generator=gen, device=dev, dtype=torch.float32)
    v /= torch.linalg.vector_norm(v)
    op64 = tl.BSROperator(op.blocks.double(), op.col_blocks, op.n)

    def engine(operator, label, mode="hybrid", full_orth=False):
        ex = tl.Exponentiator(operator, mode=mode)
        ex.max_iteration = EXPM_BSR_MAX_ITER
        ex.full_orthogonalize = full_orth
        if label == "float32":
            ex.eps = 1e-12
        return ex

    def rel(got, want):
        return float(torch.linalg.vector_norm(got.double() - want.double()) / torch.linalg.vector_norm(want.double()))

    runs, modes = {}, {}
    for label, operator, vec in (("float32", op, v), ("float64", op64, v.double())):
        ex = engine(operator, label)
        ex.run_grid(a_list, vec)  # warm-up
        torch.cuda.synchronize()
        spmv.bsr_matvec.launches = 0
        t0 = time.perf_counter()
        outs, iters = ex.run_grid(a_list, vec)
        torch.cuda.synchronize()
        runs[label] = {"outs": outs, "iters": iters, "ms": (time.perf_counter() - t0) * 1e3,
                       "k1_launches": spmv.bsr_matvec.launches, "eps": ex.eps}
        for full_orth in (False, True):
            pair = {}
            for mode in ("hybrid", "fused"):
                ex = engine(operator, label, mode, full_orth)
                (out, itern), rec = expm_timed(torch, spmv, cgs, lambda: ex.run(a_run, vec))
                pair[mode] = out
                modes[f"{label}_{'full_orth' if full_orth else 'no_orth'}_{mode}"] = {
                    "iterations": itern, "iterations_built": rec["k1_launches"], **rec}
            key = f"{label}_{'full_orth' if full_orth else 'no_orth'}"
            hyb, fus = modes[f"{key}_hybrid"], modes[f"{key}_fused"]
            err = rel(pair["fused"], pair["hybrid"])
            fus["rel_err_vs_hybrid"] = err
            if not (fus["iterations"] == hyb["iterations"] < EXPM_BSR_MAX_ITER and err <= EXPM_MODE_TOL[label]):
                raise AssertionError(f"expm_bsr {key}: fused {fus['iterations']} iterations against hybrid "
                                     f"{hyb['iterations']}, relative difference {err:.3e} (bar {EXPM_MODE_TOL[label]:.0e})")
            if not (hyb["k1_launches"] == hyb["iterations"] and fus["k1_launches"] >= fus["iterations"]):
                raise AssertionError(f"expm_bsr {key}: K1 launches {hyb['k1_launches']} / {fus['k1_launches']}")
            if full_orth and not (hyb["k3_launches"] > 0 and fus["k3_launches"] > 0):
                raise AssertionError(f"expm_bsr {key}: full reorthogonalization launched K3 {hyb['k3_launches']} / "
                                     f"{fus['k3_launches']} times")
            if not bool(torch.isfinite(pair["fused"]).all()):
                raise AssertionError(f"expm_bsr {key}: non-finite fused output")
    del op64
    f32, f64 = runs["float32"], runs["float64"]
    errs = [rel(got, want) for got, want in zip(f32["outs"], f64["outs"])]
    if not (f32["k1_launches"] > 0 and f64["k1_launches"] > 0):
        raise AssertionError(f"expm_bsr: K1 launches {f32['k1_launches']} / {f64['k1_launches']}")
    if not max(f32["iters"], f64["iters"]) < EXPM_BSR_MAX_ITER:
        raise AssertionError(f"expm_bsr: no convergence in {EXPM_BSR_MAX_ITER} iterations "
                             f"({f32['iters']}, {f64['iters']})")
    if not (f32["outs"].shape == (3, op.n) and bool(torch.isfinite(f32["outs"]).all()) and max(errs) <= EXPM_BSR_BAR):
        raise AssertionError(f"expm_bsr: float32 against float64 relative errors {errs} (bar {EXPM_BSR_BAR:.0e})")

    # run_batch against the single runs of its rows.
    rows = torch.randn(EXPM_BATCH_ROWS, op.n, generator=gen, device=dev, dtype=torch.float32)
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    batch = torch.cat([rows, torch.zeros_like(rows[:1])])
    ex_batch = engine(op, "float32")
    (b_out, b_iters), batch_rec = expm_timed(torch, spmv, cgs, lambda: ex_batch.run_batch(a_run, batch))
    singles = []
    for i in range(EXPM_BATCH_ROWS):
        one = {}
        for mode in ("hybrid", "fused"):
            ex = engine(op, "float32", mode)
            (out, itern), rec = expm_timed(torch, spmv, cgs, lambda: ex.run(a_run, rows[i]), reps=1)
            one[mode] = {"iterations": itern, "ms": rec["ms_median"], "rel_err": rel(b_out[i], out)}
        singles.append(one)
        if not all(r["iterations"] == int(b_iters[i]) and r["rel_err"] <= EXPM_MODE_TOL["float32"]
                   for r in one.values()):
            raise AssertionError(f"expm_bsr run_batch row {i}: {int(b_iters[i])} iterations against {one}")
    if not (int(b_iters[-1]) == 1 and not bool(b_out[-1].any()) and bool(torch.isfinite(b_out).all())):
        raise AssertionError(f"expm_bsr run_batch: zero row gave {int(b_iters[-1])} iterations, "
                             f"max |out| {float(b_out[-1].abs().max())}")
    emit({"phase": "expm_bsr", "n": op.n, "tiles": list(op.blocks.shape), "a": a_list,
          "rel_err_f32_vs_f64": errs, "bar": EXPM_BSR_BAR,
          **{f"{label}_{key}": val for label, r in runs.items() for key, val in r.items() if key != "outs"},
          "run_a": a_run, "modes": modes, "mode_bars": EXPM_MODE_TOL,
          "batch": {"rows": EXPM_BATCH_ROWS, "zero_rows": 1, "iterations": [int(x) for x in b_iters],
                    "iterations_built": batch_rec["k1_launches"], **batch_rec, "singles": singles,
                    "singles_ms": {mode: sum(o[mode]["ms"] for o in singles) for mode in ("hybrid", "fused")}}})
    return {"k1": f32["k1_launches"], "modes": modes}


def phase_expm_small(torch, np, dev):
    """Where each Exponentiator mode wins: ``run(EXPM_SMALL_A, v)`` over the
    main path's chain (random potential, three deep sites) cut to the
    widths EXPM_SMALL_NS, float32 BSR tiles (K1), from a seeded unit vector
    at eps 1e-12, where the hybrid build's host round trip per iteration
    is a growing share of an iteration as n falls.  Three runs a cell:
    hybrid; fused with the default first stage of 16; fused with a first
    stage of the hybrid's count (``initial_buffer_size``, which a caller
    that steps an evolution can set from its first step).  Each fused run
    must take the hybrid's count, with an output within
    EXPM_MODE_TOL['float32'] of it; wall ms by host clock (EXPM_SMALL_REPS
    runs after a warm-up), host waits and iterations built (K1 launches)
    each."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs, spmv

    cells = {}
    for n in EXPM_SMALL_NS:
        rng = np.random.default_rng(SEED)
        pot = rng.uniform(0.0, 1.0, n)
        pot[[n // 4, n // 2, 3 * n // 4]] = [-4.0, -3.5, -3.0]
        op = tl.BSROperator.from_coo(*_chain_coo(np, n, pot), n, bm=128, bk=128, dtype=torch.float32, device=dev)
        v = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(SEED + 9), device=dev)
        v /= torch.linalg.vector_norm(v)

        def engine(mode, first_stage=None):
            ex = tl.Exponentiator(op, mode=mode)
            ex.eps, ex.max_iteration = 1e-12, EXPM_BSR_MAX_ITER
            if first_stage is not None:
                ex.initial_buffer_size = first_stage
            return ex

        ex = engine("hybrid")
        (want, itern), hyb = expm_timed(torch, spmv, cgs, lambda: ex.run(EXPM_SMALL_A, v), reps=EXPM_SMALL_REPS)
        cell = {"iterations": itern, "hybrid": hyb}
        for label, first_stage in (("fused", None), ("fused_stage_fit", itern)):
            ex = engine("fused", first_stage)
            (out, it_fused), rec = expm_timed(torch, spmv, cgs, lambda: ex.run(EXPM_SMALL_A, v), reps=EXPM_SMALL_REPS)
            err = float(torch.linalg.vector_norm(out - want) / torch.linalg.vector_norm(want))
            if not (it_fused == itern < EXPM_BSR_MAX_ITER and err <= EXPM_MODE_TOL["float32"]
                    and bool(torch.isfinite(out).all()) and rec["k1_launches"] >= itern):
                raise AssertionError(f"expm_small n={n} {label}: {it_fused} iterations against hybrid {itern}, "
                                     f"relative difference {err:.3e}, {rec['k1_launches']} K1 launches")
            cell[label] = {**rec, "iterations_built": rec["k1_launches"], "rel_err_vs_hybrid": err,
                           "over_hybrid": rec["ms_median"] / hyb["ms_median"]}
        if hyb["k1_launches"] != itern:
            raise AssertionError(f"expm_small n={n}: hybrid launched K1 {hyb['k1_launches']} times for {itern}")
        cells[str(n)] = cell
    emit({"phase": "expm_small", "a": str(EXPM_SMALL_A), "dtype": "float32", "cells": cells})


@contextlib.contextmanager
def recording_dtypes(module, name):
    """Count the calls of ``module.name`` (a kernel wrapper whose first
    argument is a tensor) by that tensor's dtype, for calls on CUDA
    tensors, while the context is open; yields the Counter.  Like
    :func:`recording_k3`, the recorder stands in for the wrapper on its
    module, carries its launch count meanwhile and hands it back."""
    real = getattr(module, name)
    seen = collections.Counter()

    def recorder(t, *args, **kwargs):
        if t.device.type == "cuda":
            seen[str(t.dtype)] += 1
        return real(t, *args, **kwargs)

    recorder.launches = real.launches
    setattr(module, name, recorder)
    try:
        yield seen
    finally:
        setattr(module, name, real)
        real.launches = recorder.launches


def _scipy_bsr(np, blocks, col_blocks, layout, n_cols):
    """The float64 scipy matrix of float32 BSR tiles, for an independent
    product on the host."""
    import scipy.sparse

    if layout == "rmsk":
        r, bm, s, bk = blocks.shape
        data = blocks.permute(0, 2, 1, 3).reshape(r * s, bm, bk)
    else:
        r, s, bm, bk = blocks.shape
        data = blocks.reshape(r * s, bm, bk)
    return scipy.sparse.bsr_matrix(
        (data.double().cpu().numpy(), col_blocks.reshape(-1).long().cpu().numpy(), np.arange(0, r * s + 1, s)),
        shape=(r * bm, n_cols))


def check_k1x(torch, np, blocks, col_blocks, x, n_out, layout, label, *, timing=False, scipy_y=None):
    """K1x (``layout='rmsk'``) or its rsmk twin on float32 tiles and a
    float64 ``x``: against the plain version (float64 accumulation on the
    card) and a float64 scipy product at K1X_TOL of max |y|, a bit-for-bit
    repeat, the launch plan beside the library's own, and with ``timing``
    its time beside the bound (float64 operations at the float64 rate),
    the plain version, K1 or K2 on the same tiles with a float32 x, a read
    stream of the tiles and ``torch.sparse_bsr_tensor`` over a float64
    copy of the tiles (the one PyTorch call for the same product; it reads
    twice the bytes)."""
    import ctypes

    import torch.nn.functional as F

    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.ops import spmv

    if layout == "rmsk":
        r, bm, s, bk = blocks.shape
        n_pad = r * bm
        x_read = x.numel()
        counter = spmv.bsr_matvec_f32x64

        def kernel():
            return spmv.bsr_matvec_f32x64(blocks, col_blocks, x, n_out)

        def f32_twin():
            return spmv.bsr_matvec(blocks, col_blocks, x32, n_out)

        def plain():
            return spmv.bsr_matvec_reference(blocks, col_blocks, F.pad(x, (0, n_pad - x.shape[0])), layout="rmsk")[:n_out]
    else:
        r, s, bm, bk = blocks.shape
        c_rows = x.numel() // bk
        x_read = x.numel()
        counter = spmv.bsr_matvec_rsmk_f32x64

        def kernel():
            return spmv.bsr_matvec_rsmk(blocks, col_blocks, x, n_out, col_bound=c_rows)

        def f32_twin():
            return spmv.bsr_matvec_rsmk(blocks, col_blocks, x32, n_out, col_bound=c_rows)

        def plain():
            return spmv.bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")[:n_out]
    x32 = x.float()
    before = counter.launches
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if counter.launches != before + 2 or got.dtype != torch.float64:
        raise AssertionError(f"K1x {layout} {label}: {counter.launches - before} launches, output {got.dtype}")
    repeat = bool(torch.equal(got, again))
    err, rel = rel_err(got, plain())
    out = {"phase": "k1x", "case": label, "layout": layout, "shape": list(blocks.shape), "n_out": n_out,
           "max_abs_err": err, "max_rel_err": rel, "tol": K1X_TOL, "bitwise_repeat": repeat}
    if scipy_y is not None:
        out["scipy_max_rel_err"] = rel_err(got.cpu(), torch.from_numpy(np.asarray(scipy_y)[:n_out]))[1]
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().lt_bsr_spmv_info(bm, s, bk, 8, info), "lt_bsr_spmv_info")
    out["plan"] = {"f64_x": spmv.plan(bm, s, bk, 8), "f32_x": spmv.plan(bm, s, bk, 4),
                   "library_f64_x": {"s_piece": info[0], "smem": info[1], "opt_in": bool(info[2]),
                                     "static_smem": info[3]}}
    p = out["plan"]
    if (p["f64_x"]["s_piece"], p["f64_x"]["smem"], p["f64_x"]["opt_in"]) != (info[0], info[1], bool(info[2])):
        raise AssertionError(f"K1x {label}: the Python plan {p['f64_x']} is not the kernel's {p['library_f64_x']}")
    if not (rel <= K1X_TOL and repeat and out.get("scipy_max_rel_err", 0.0) <= K1X_TOL):
        raise AssertionError(f"K1x {layout} {label}: {out}")
    if timing:
        tiles = blocks.numel() * 4
        # Each input read once (tiles, column indices, x), y written once;
        # one multiply and one add a stored value, in float64.
        bytes_moved = tiles + col_blocks.numel() * 4 + (x_read + n_out) * 8
        bound_ms, bound_by = bound(bytes_moved, 2 * blocks.numel(), F64_FLOPS)
        ms, plain_ms, f32_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain), cuda_ms(torch, f32_twin)
        stream_ms = cuda_ms(torch, lambda: torch.sum(blocks))
        values = (blocks.permute(0, 2, 1, 3) if layout == "rmsk" else blocks).reshape(r * s, bm, bk).double()
        crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
        n_cols = n_pad if layout == "rmsk" else x.numel()
        a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64), values, size=(r * bm, n_cols))
        xp = F.pad(x, (0, n_cols - x.shape[0]))
        lib_rel = rel_err((a @ xp)[:n_out], got)[1]
        library_ms = cuda_ms(torch, lambda: a @ xp)
        del a, values
        torch.cuda.empty_cache()
        out.update(ms=ms, plain_ms=plain_ms, f32_kernel_ms=f32_ms, library_ms=library_ms, library_max_rel_err=lib_rel,
                   bound_ms=bound_ms, bound_by=bound_by, gbps=bytes_moved / ms / 1e6,
                   stream_bound_ms=stream_ms * bytes_moved / tiles,
                   fraction_of_bound=bound_ms / ms)
    emit(out)
    return out


def phase_k1x(torch, np, dev):
    """K1x and its rsmk twin against their plain versions and scipy on
    seeded tiles: small, ragged, S*bk past one float64 x piece, a tile
    width (bk = 8192) whose float64 piece needs the shared-memory opt-in
    where the float32 plan's does not, and the 64 Mi-nnz case (timed)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    timed = {}
    for label, (r, bm, s, bk, n) in {
        "small": (4, 8, 3, 8, 30),
        "ragged": (37, 16, 5, 16, 37 * 16 - 5),
        "wide_s": (9, 16, 400, 16, 144),
        "smem_boundary_bk8192": (64, 128, 2, 8192, 64 * 128),
        "bench_64Mi_nnz": (BENCH_R, 128, 8, 128, BENCH_R * 128),
    }.items():
        blocks, cb = _random_bsr(torch, dev, r, bm, s, bk, torch.float32, gen)
        x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        xh = np.zeros(r * bm)
        xh[:n] = x.cpu().numpy()
        y_ref = _scipy_bsr(np, blocks, cb, "rmsk", r * bm) @ xh
        timed_case = label.startswith("bench")
        out = check_k1x(torch, np, blocks, cb, x, n, "rmsk", label, timing=timed_case, scipy_y=y_ref)
        if label.startswith("smem_boundary") and not (out["plan"]["f64_x"]["opt_in"]
                                                      and not out["plan"]["f32_x"]["opt_in"]):
            raise AssertionError(f"K1x {label}: not past the float32 plan's shared-memory boundary: {out['plan']}")
        del blocks, cb, x
        c_rows = (r * bm) // bk
        blocks, cb, x32 = _random_rsmk(torch, dev, r, s, bm, bk, c_rows, torch.float32, gen)
        x = x32.double()
        y_ref = _scipy_bsr(np, blocks, cb, "rsmk", c_rows * bk) @ x.cpu().numpy()
        out_r = check_k1x(torch, np, blocks, cb, x, r * bm, "rsmk", label, timing=timed_case, scipy_y=y_ref)
        if timed_case:
            timed = {"rmsk": out, "rsmk": out_r}
        del blocks, cb, x, x32
        torch.cuda.empty_cache()
    return timed


def _pv_counts(torch, stage):
    """Run ``stage()`` with the launch counts of K1, K1x (both forms, float32
    and bfloat16 tiles), K2 and K4 from 0, and K3 and K6 launches recorded
    by dtype; returns its result, the wall time and the counts."""
    from lanczos_tpu_torch.ops import cgs, spmv, sturm_check

    for fn in (spmv.bsr_matvec, spmv.bsr_matvec_f32x64, spmv.bsr_matvec_rsmk, spmv.bsr_matvec_rsmk_f32x64,
               spmv.bsr_matvec_bf16x64, spmv.bsr_matvec_rsmk_bf16x64, cgs.cgs_pass_block):
        fn.launches = 0
    with counting_checks() as checks, recording_dtypes(cgs, "cgs_pass") as k3, \
            recording_dtypes(cgs, "cgs_pass_block") as k4, recording_dtypes(sturm_check, "sturm_check") as k6:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = stage()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {"k1": spmv.bsr_matvec.launches, "k1x": spmv.bsr_matvec_f32x64.launches,
              "k2": spmv.bsr_matvec_rsmk.launches, "k1x_rsmk": spmv.bsr_matvec_rsmk_f32x64.launches,
              "k1x_bf16x64": spmv.bsr_matvec_bf16x64.launches,
              "k1x_rsmk_bf16x64": spmv.bsr_matvec_rsmk_bf16x64.launches,
              "k3_by_dtype": dict(k3), "k4_by_dtype": dict(k4), "k6_by_dtype": dict(k6), "checks": checks}
    return result, wall, counts


def _all_f64(counts, key):
    by = counts[key]
    return bool(by) and set(by) == {"torch.float64"}


def _pv_basis_gb(counts, n, first=64):
    """The float64 basis the fused engine grew to: stages of 16x(4^j)
    rows from ``initial_buffer_size`` up to the longest round."""
    cap = first
    while cap < max(counts):
        cap *= 4
    return (min(cap, n) + 1) * n * 8 / 1e9


def phase_pv_main_path(torch, np, dev, op):
    """The main path's problem with ``precise_vectors``: the fused engine
    over a float64 basis and the float32 tiles' ``matvec_f64`` (K1x, never
    a float64 copy of the tiles), K3 and K6 in float64, eps = 1e-12; the
    eigenvalues against scipy eigsh in float64 on the same float32
    entries.  K1x at the main path's tiles beside K1."""
    import scipy.sparse
    import scipy.sparse.linalg

    import lanczos_tpu_torch as tl

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np)
    a32 = scipy.sparse.coo_matrix((vals.astype(np.float32).astype(np.float64), (rows, cols)), shape=(n, n)).tocsr()
    t0 = time.perf_counter()
    ref32 = np.sort(scipy.sparse.linalg.eigsh(a32, k=3, which="SA", tol=0)[0])
    scipy_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    k1x = check_k1x(torch, np, op.blocks, op.col_blocks, x, n, "rmsk", "main_path", timing=True,
                    scipy_y=a32 @ x.cpu().numpy())
    del x
    torch.cuda.empty_cache()

    eng = _main_path_engine(tl, torch, op)
    eng.precise_vectors = True
    eng.eps = 1e-12
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    (evals, evecs), wall, counts = _pv_counts(torch, eng.run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err = np.abs(np.sort(np.asarray(evals)) - ref32)
    if not (counts["k1x"] > 0 and counts["k1"] == 0 and _all_f64(counts, "k3_by_dtype")
            and _all_f64(counts, "k6_by_dtype")):
        raise AssertionError(f"pv main path: launches {counts} (K1x, float64 K3 and K6 expected, no K1)")
    check_stats(counts["checks"])
    if not (evecs.shape == (3, n) and evecs.dtype == torch.float32 and bool(torch.isfinite(evecs).all())):
        raise AssertionError(f"pv main path: eigenvectors {evecs.dtype} {tuple(evecs.shape)}")
    if not np.all(err <= PV_MAIN_BAR):
        raise AssertionError(f"pv main path: eigenvalues {evals} vs scipy {ref32}: errors {err}")
    emit({"phase": "pv_main_path", "n": n, "storage": "float32", "basis": "float64", "eps": eng.eps,
          "eigenvalues": list(map(float, evals)), "scipy_eigsh_f32_entries": ref32.tolist(),
          "abs_errs": err.tolist(), "bar": PV_MAIN_BAR, "iteration_counts": eng.iteration_counts, "wall_s": wall,
          "iterations_per_s": sum(eng.iteration_counts) / wall, "launches": counts,
          "basis_gb": _pv_basis_gb(eng.iteration_counts, n), "tile_gb": op.blocks.numel() * 4 / 1e9,
          "peak_device_gb_over_start": peak_gb - base_gb, "residuals_f32_matvec": eng.residuals(evals, evecs),
          "scipy_s": scipy_s})
    return {"k1x": k1x, "launches": counts["k1x"], "ref32": ref32}


def _pv_block_chain(tl, np, dev, n, nb):
    off = np.ones(n - 1, np.float32)
    off[nb - 1::nb] = 0.0
    d = np.zeros((2, n), np.float32)
    d[0, 1:] = -off
    d[1, : n - 1] = -off
    return tl.DIAOperator.from_diagonals([-1, 1], d, n, device=dev)


def phase_pv_thick(torch, np, dev, block_size):
    """bench.py sec_pv_thick at full size: the n = 2**20 block-diagonal
    chain (copies of the 128-site chain, every eigenvalue of multiplicity
    8192) as float32 DIA, three lowest with ``precise_vectors`` and
    ``restart_policy='thick'`` in a 128-row basis at eps 1e-11; with
    ``block_size`` 3 the block thick engine (K4 in float64)."""
    import lanczos_tpu_torch as tl

    n, nb = PV_THICK_N, PV_THICK_NB
    op = _pv_block_chain(tl, np, dev, n, nb)
    eng = tl.LambdaLanczos(op, find_maximum=False, num_eigs=3)
    eng.precise_vectors = True
    eng.restart_policy = "thick"
    eng.max_iteration = 128
    eng.eps = 1e-11
    eng.eigenvalue_offset = -4.0
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)
    if block_size > 1:
        eng.block_size = block_size
        eng.max_restarts = 32
        rng = np.random.default_rng(SEED)  # distinct start rows, the same every run
        eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_).astype(np.float32)
    (evals, evecs), wall, counts = _pv_counts(torch, eng.run)
    truth = -2.0 * np.cos(np.pi / (nb + 1))
    err = np.abs(np.asarray(evals) - truth)
    name = "pv_thick" if block_size == 1 else "pv_block_thick"
    kernel_key = "k3_by_dtype" if block_size == 1 else "k4_by_dtype"
    if not _all_f64(counts, kernel_key):
        raise AssertionError(f"{name}: launches {counts} (float64 {kernel_key[:2].upper()} expected)")
    if not (evecs.shape == (3, n) and bool(torch.isfinite(evecs).all()) and np.all(err <= PV_THICK_BAR)):
        raise AssertionError(f"{name}: eigenvalues {evals} vs {truth}: errors {err}")
    emit({"phase": name, "n": n, "nb": nb, "block_size": block_size, "max_iteration": 128, "eps": eng.eps,
          "eigenvalues": list(map(float, evals)), "truth": truth, "abs_errs": err.tolist(), "bar": PV_THICK_BAR,
          "iteration_counts": eng.iteration_counts, "unconverged_rounds": eng.stats.unconverged_rounds,
          "wall_s": wall, "launches": counts})


def sharded_pv(torch, np, op, ref32):
    """The main path's problem with ``precise_vectors`` over the one-rank
    NCCL ShardedBSROperator ``op``: K1x's rsmk form as the local product,
    float64 slabs through the collectives; then K1x-rsmk on its tiles."""
    import lanczos_tpu_torch as tl

    eng = _main_path_engine(tl, torch, op)
    eng.precise_vectors = True
    eng.eps = 1e-12
    (evals, evecs), wall, counts = _pv_counts(torch, eng.run)
    err = np.abs(np.sort(np.asarray(evals)) - ref32)
    if not (counts["k1x_rsmk"] > 0 and counts["k2"] == 0 and counts["k1x"] == 0
            and _all_f64(counts, "k3_by_dtype")):
        raise AssertionError(f"sharded pv: launches {counts} (K1x-rsmk and float64 K3 expected, no K2)")
    if not (evecs.shape == (3, op.n) and np.all(err <= PV_MAIN_BAR)):
        raise AssertionError(f"sharded pv: eigenvalues {evals} vs scipy {ref32}: errors {err}")
    emit({"phase": "sharded_pv", "n": op.n, "world_size": op.mesh.size, "comm": op.comm,
          "eigenvalues": list(map(float, evals)), "abs_errs": err.tolist(), "bar": PV_MAIN_BAR,
          "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches": counts})
    gen = torch.Generator(device=op.device).manual_seed(SEED + 19)
    x = torch.randn(op.n_padded, generator=gen, device=op.device, dtype=torch.float64)
    timing = check_k1x(torch, np, op.blocks, op.col_blocks, x, op.blocks.shape[0] * op.bm, "rsmk", "main_path",
                       timing=True)
    return {"k1x_rsmk": timing, "launches": counts["k1x_rsmk"]}


def phase_precise_filter(torch, np, dev):
    """bench.py sec_precise_filter: the n = 4000 chain as float32 DIA, the
    three lowest by ``filtered_lanczos(precise=True)`` on [-2, 2] (the
    scout, the float64-basis B-space solve over the filter's float64 chain,
    the inverse map, then the refined vectors), against the analytic
    values and the host float64 stencil's residuals."""
    import lanczos_tpu_torch as tl

    n = PRECISE_FILTER_N
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    exact = np.array([-2.0 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)])
    walls = []
    for _ in range(2):  # cold, then warm
        (vals, vecs, info), wall, counts = _pv_counts(
            torch, lambda: tl.filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, precise=True))
        walls.append(wall)
    err = np.abs(np.asarray(vals) - exact)
    v = np.asarray(vecs, np.float64)
    av = np.zeros_like(v)
    av[:, 0] = -v[:, 1]
    av[:, -1] = -v[:, -2]
    av[:, 1:-1] = -(v[:, :-2] + v[:, 2:])
    res = np.linalg.norm(av - np.asarray(vals)[:, None] * v, axis=1)
    if not (np.all(err <= PRECISE_FILTER_BAR) and np.all(res <= PRECISE_FILTER_RES_BAR)):
        raise AssertionError(f"precise filter: errors {err}, residuals {res}")
    if not counts["k3_by_dtype"].get("torch.float64", 0) > 0:  # the scout's coarse pass runs K3 in float32
        raise AssertionError(f"precise filter: launches {counts} (float64 K3 expected)")
    emit({"phase": "precise_filter", "n": n, "eigenvalues": list(map(float, vals)), "abs_errs": err.tolist(),
          "bar": PRECISE_FILTER_BAR, "vector_residuals": res.tolist(), "residual_bar": PRECISE_FILTER_RES_BAR,
          "cold_s": walls[0], "warm_s": walls[1], "filter_degree": info["filter_degree"], "mu": info["mu"],
          "iteration_counts": info["iteration_counts"], "refine_sweeps": info.get("refine_sweeps"),
          "launches": counts})


def phase_expm_precise(torch, np, dev):
    """bench.py sec_expm_evolve_precise and sec_expm_cheby's precise chain
    at full size: the n = 2**20 chain as float32 DIA, a complex state from
    default_rng(7); ``evolve(0.05j, ..., 100, krylov_dim=16,
    precise=True)`` and ``run_chebyshev(5.0j, lo=-2, hi=2, precise=True)``,
    each against the DST-I truth by state angle."""
    from scipy.fft import dst

    import lanczos_tpu_torch as tl

    n, steps = EXPM_PRECISE_N, 100
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = -2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    coef = dst(v, type=1, norm="ortho")
    truth = dst(np.exp(5.0j * lam) * coef, type=1, norm="ortho")  # 100 steps of 0.05 and the chain's t = 5
    tn = truth / np.linalg.norm(truth)

    def angle(o_re, o_im):
        out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
        on = out / np.linalg.norm(out)
        ip = np.vdot(tn, on)
        return float(np.linalg.norm(on - (ip / abs(ip)) * tn))

    ex = tl.Exponentiator(op)
    ex.evolve(0.05j, v.real, v.imag, 1, krylov_dim=16, precise=True)  # warm-up
    (re, im), evolve_s, counts = _pv_counts(
        torch, lambda: ex.evolve(0.05j, v.real, v.imag, steps, krylov_dim=16, precise=True))
    evolve_angle = angle(re, im)
    if not (evolve_angle <= EVOLVE_PRECISE_BAR and _all_f64(counts, "k3_by_dtype") and re.dtype == np.float64):
        raise AssertionError(f"precise evolve: angle {evolve_angle:.3e}, launches {counts}, {re.dtype}")
    cheby_s = []
    for _ in range(2):
        ((c_re, c_im), terms), wall, _c = _pv_counts(
            torch, lambda: ex.run_chebyshev(5.0j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True))
        cheby_s.append(wall)
    cheby_angle = angle(c_re, c_im)
    if not cheby_angle <= CHEBY_PRECISE_BAR:
        raise AssertionError(f"precise Chebyshev chain: angle {cheby_angle:.3e}")
    emit({"phase": "expm_precise", "n": n, "storage": "float32", "steps": steps, "krylov_dim": 16,
          "evolve_s": evolve_s, "evolve_ms_per_step": evolve_s / steps * 1e3, "evolve_angle": evolve_angle,
          "evolve_bar": EVOLVE_PRECISE_BAR, "evolve_launches": counts, "cheby_cold_s": cheby_s[0],
          "cheby_warm_s": cheby_s[1], "cheby_terms": terms, "cheby_ms_per_term": cheby_s[1] / terms * 1e3,
          "cheby_angle": cheby_angle, "cheby_bar": CHEBY_PRECISE_BAR})


# ---- complex Hermitian input: K1, K1x and K3 complex, engines, facade -------


def check_k1c(torch, np, blocks, col_blocks, x, n, label, *, timing=False, f32_blocks=None):
    """One complex instance of K1 (complex64 or complex128 tiles against x
    of their dtype) or K1x (complex64 tiles against a complex128 x) on
    ``rmsk`` tiles: against the plain version at K1C_TOL of max |y|, a
    bit-for-bit repeat, its launch count by dtype, and the launch plan
    against the library's; with ``timing`` its time beside the bound
    (complex multiply-adds: 8 real operations a stored value at the rate of
    the accumulator's type), the plain version, a read stream of the tiles,
    K1 float32 on ``f32_blocks`` (the same pattern) and the complex
    ``torch.sparse_bsr_tensor`` product, or null with its error where
    PyTorch refuses it."""
    import ctypes

    import torch.nn.functional as F

    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.ops import spmv

    r, bm, s, bk = blocks.shape
    n_pad = r * bm
    wide = x.dtype != blocks.dtype
    name = "complex64x128" if wide else str(blocks.dtype).replace("torch.", "")
    counter = (lambda: spmv.bsr_matvec_c64x128.launches) if wide else (
        lambda: spmv.bsr_matvec.launches_by_dtype[blocks.dtype])

    def kernel():
        return spmv.bsr_matvec(blocks, col_blocks, x, n_out=n)

    def plain():
        return spmv.bsr_matvec_reference(blocks, col_blocks, F.pad(x, (0, n_pad - x.shape[0])), layout="rmsk")[:n]

    before = counter()
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if counter() != before + 2 or got.dtype != x.dtype:
        raise AssertionError(f"K1 {name} {label}: {counter() - before} launches, output {got.dtype}")
    repeat = bool(torch.equal(got, again))
    err, rel = rel_err(got, plain())
    item = x.element_size()
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().lt_bsr_spmv_info(bm, s, bk, item, info), "lt_bsr_spmv_info")
    plan = spmv.plan(bm, s, bk, item)
    out = {"phase": "k1c", "kernel": name, "case": label, "shape": [r, bm, s, bk], "n": n, "max_abs_err": err,
           "max_rel_err": rel, "tol": K1C_TOL[name], "bitwise_repeat": repeat, "plan": plan,
           "library_plan": {"s_piece": info[0], "smem": info[1], "opt_in": bool(info[2])}}
    if (plan["s_piece"], plan["smem"], plan["opt_in"]) != (info[0], info[1], bool(info[2])):
        raise AssertionError(f"K1 {name} {label}: the Python plan {plan} is not the kernel's {out['library_plan']}")
    if not (rel <= K1C_TOL[name] and repeat):
        raise AssertionError(f"K1 {name} {label}: {out}")
    if timing:
        tiles = blocks.numel() * blocks.element_size()
        bytes_moved = tiles + col_blocks.numel() * 4 + (x.numel() + n) * item
        rate = F32_FLOPS if x.dtype == torch.complex64 else F64_FLOPS
        bound_ms, bound_by = bound(bytes_moved, 8 * blocks.numel(), rate)
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        stream_ms = cuda_ms(torch, lambda: torch.sum(torch.view_as_real(blocks)))
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gbps=bytes_moved / ms / 1e6,
                   stream_bound_ms=stream_ms * bytes_moved / tiles, fraction_of_bound=bound_ms / ms)
        if f32_blocks is not None:
            x32 = torch.randn(n, device=blocks.device)
            out["f32_kernel_ms"] = cuda_ms(torch, lambda: spmv.bsr_matvec(f32_blocks, col_blocks, x32, n_out=n))
        try:
            values = blocks.permute(0, 2, 1, 3).reshape(r * s, bm, bk).to(x.dtype)
            crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
            a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64), values, size=(n_pad, n_pad))
            xp = F.pad(x, (0, n_pad - x.shape[0]))
            out["library_max_rel_err"] = rel_err((a @ xp)[:n], got)[1]
            out["library_ms"] = cuda_ms(torch, lambda: a @ xp)
            del a, values
        except (RuntimeError, NotImplementedError, TypeError) as exc:  # PyTorch may refuse complex BSR on CUDA
            out["library_ms"], out["library_error"] = None, str(exc).splitlines()[0][:200]
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_k1c(torch, np, dev):
    """The three complex instances (K1 complex64 and complex128, K1x
    complex64 x complex128) against their plain versions on seeded tiles:
    small, ragged, S*bk past one x piece, and bk = 8192, where the complex
    x pieces need the shared-memory opt-in that the float32 one does not."""
    from lanczos_tpu_torch.ops import spmv

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for label, (r, bm, s, bk, n) in {
        "small": (4, 8, 3, 8, 30),
        "ragged": (37, 16, 5, 16, 37 * 16 - 5),
        "wide_s": (9, 16, 400, 16, 144),
        "smem_boundary_bk8192": (64, 128, 1, 8192, 64 * 128),
    }.items():
        for tile, xt in ((torch.complex64, torch.complex64), (torch.complex128, torch.complex128),
                         (torch.complex64, torch.complex128)):
            blocks, cb = _random_bsr(torch, dev, r, bm, s, bk, tile, gen)
            x = torch.randn(n, generator=gen, device=dev, dtype=xt)
            out = check_k1c(torch, np, blocks, cb, x, n, label)
            if label.startswith("smem") and not (out["plan"]["opt_in"] and not spmv.plan(bm, s, bk, 4)["opt_in"]):
                raise AssertionError(f"K1 complex {label}: not past the float32 plan's boundary: {out['plan']}")
            del blocks, cb, x
        torch.cuda.empty_cache()


def check_k3c(torch, basis, v, k, *, timing=False):
    """K3's complex instance: against the plain version (conjugated
    coefficients) at K3C_TOL, twice bit for bit, counted by dtype; with
    ``timing`` beside the bound (k live rows read twice, 8 real operations
    a value a sweep), the plain version, the read stream of the rows (twice
    for the two sweeps) and two ``torch.mv`` with the conjugate."""
    from lanczos_tpu_torch.ops import cgs

    name = str(basis.dtype).replace("torch.", "")
    want = cgs.cgs_pass_reference(v, basis, k)
    before = cgs.cgs_pass.launches_by_dtype[basis.dtype]
    got = cgs.cgs_pass(v.clone(), basis, k)
    again = cgs.cgs_pass(v.clone(), basis, k)
    torch.cuda.synchronize()
    if cgs.cgs_pass.launches_by_dtype[basis.dtype] != before + 2:
        raise AssertionError(f"K3 {name} k={k}: launches by dtype {dict(cgs.cgs_pass.launches_by_dtype)}")
    err, rel = rel_err(got, want)
    repeat = bool(torch.equal(got, again))
    out = {"phase": "k3c", "kernel": name, "basis": list(basis.shape), "k": k, "max_abs_err": err, "max_rel_err": rel,
           "tol": K3C_TOL[name], "bitwise_repeat": repeat}
    if not (rel <= K3C_TOL[name] and repeat):
        raise AssertionError(f"K3 {name}: {out}")
    if timing:
        work = v.clone()
        rows = basis[:k]
        n, item = basis.shape[1], basis.element_size()
        ms = cuda_ms(torch, lambda: cgs.cgs_pass(work, basis, k))
        plain_ms = cuda_ms(torch, lambda: cgs.cgs_pass_reference(v, basis, k))
        library_ms = cuda_ms(torch, lambda: v - torch.mv(rows.T, torch.mv(rows.conj(), v)))  # two torch.mv
        stream_ms = cuda_ms(torch, lambda: torch.sum(torch.view_as_real(rows)))
        rate = F32_FLOPS if basis.dtype == torch.complex64 else F64_FLOPS
        bound_ms, bound_by = bound((k + 2) * n * item, 16 * k * n, rate)
        out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   two_read_stream_ms=2 * stream_ms, gbps=2 * k * n * item / ms / 1e6,
                   fraction_of_bound=bound_ms / ms)
    emit(out)
    return out


def phase_k3c(torch, dev):
    """K3 complex64 and complex128 on a (257, 2**20) basis at k = 128
    (timed) and k = 1, 64, 257, and on a ragged (129, 70001) one."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    timed = {}
    for dtype in (torch.complex64, torch.complex128):
        basis = _random_basis(torch, dev, 257, MAIN_N, dtype, gen)
        v = torch.randn(MAIN_N, generator=gen, device=dev, dtype=dtype)
        for k in (1, 64, 128, 257):
            out = check_k3c(torch, basis, v, k, timing=k == 128)
            if k == 128:
                timed[dtype] = out
        del basis, v
        basis = _random_basis(torch, dev, 129, 70001, dtype, gen)
        v = torch.randn(70001, generator=gen, device=dev, dtype=dtype)
        for k in (1, 64, 129):
            check_k3c(torch, basis, v, k)
        del basis, v
        torch.cuda.empty_cache()
    return timed


def _gauge_chain(np):
    """The main path's chain with a gauge phase on every hop
    (``engine_set.gauge_chain`` at n = MAIN_N): the COO triplets
    (complex128), phi of the stored complex64 entries and their hops'
    magnitudes."""
    from lanczos_tpu_torch.parallel.engine_set import gauge_chain

    return gauge_chain(MAIN_N)


def _launch_counts(torch):
    """Zero the launch counts of K1 and K2 (by dtype), K1x (every form and
    tile dtype), K3 and K4 (by dtype) and K6 (``engine_set``)."""
    from lanczos_tpu_torch.parallel.engine_set import zero_launch_counts

    zero_launch_counts()


def _read_counts():
    from lanczos_tpu_torch.parallel.engine_set import launch_counts

    return launch_counts()


def phase_hermitian_main_path(torch, np, dev, op_real, ref, real_evecs, main_wall, main_iters):
    """The main path's problem with a gauge phase on every hop, stored as a
    complex64 BSR of the main path's pattern (R = 8192, S = 3, bm = bk =
    128), solved by ``LambdaLanczos(op, num_eigs=3, eps=1e-6).run()``
    through the fused engine: K1 and K3 complex64, K6 on real buffers.  Its
    spectrum is the real main path's, so ``ref`` (phase main_path's scipy
    values) is the reference; each vector against U times the real one.
    Then K1's and K1x's complex instances are timed on its tiles."""
    import lanczos_tpu_torch as tl

    n = MAIN_N
    rows, cols, vals, phi, _mags = _gauge_chain(np)
    t0 = time.perf_counter()
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=128, bk=128, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if not torch.equal(op.col_blocks, op_real.col_blocks):
        raise AssertionError("the complex operator's tile pattern is not the main path's")
    eng = tl.LambdaLanczos(op, num_eigs=3, find_maximum=False)
    eng.eps = 1e-6
    eng.init_vector = tl.fixed_seed_initializer(torch.complex64, seed=SEED)
    eng.stop_when_full = True
    if eng._resolve_mode() != "fused":
        raise AssertionError("mode='auto' did not resolve to the fused engine")
    _launch_counts(torch)
    with counting_checks() as checks:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counts()
    counts["k6"] = checks["k6_launches"]
    check_stats(checks)
    if not (counts["k1_by_dtype"].get("complex64", 0) > 0 and counts["k3_by_dtype"].get("complex64", 0) > 0
            and set(counts["k1_by_dtype"]) == {"complex64"} and set(counts["k3_by_dtype"]) == {"complex64"}):
        raise AssertionError(f"the complex main path did not run K1 and K3 complex64 alone: {counts}")
    rel = np.abs(np.asarray(evals) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    u = torch.exp(1j * torch.as_tensor(phi, device=dev)).to(torch.complex64)
    overlaps = [float(abs(torch.vdot(u * real_evecs[j].to(torch.complex64), evecs[j]))) for j in range(3)]
    if not (evecs.dtype == torch.complex64 and evecs.shape == (3, n) and bool(torch.isfinite(evecs).all())):
        raise AssertionError(f"misshapen or non-finite eigenvectors {evecs.dtype} {tuple(evecs.shape)}")
    if not (np.all(rel <= HERM_MAIN_BAR) and max(residuals) <= HERM_RES_BAR
            and min(overlaps) >= 1 - HERM_OVERLAP_BAR):
        raise AssertionError(f"complex main path: rel {rel}, residuals {residuals}, overlaps {overlaps}")
    iters = sum(eng.iteration_counts)
    counts["iteration_counts"] = eng.iteration_counts
    emit({"phase": "hermitian_main_path", "n": n, "dtype": "complex64", "tiles": list(op.blocks.shape),
          "tile_gb": op.blocks.numel() * 8 / 1e9, "pack_s": pack_s, "eigenvalues": list(map(float, evals)),
          "scipy_eigsh_real": list(map(float, ref)), "max_rel_err": float(rel.max()), "residuals": residuals,
          "overlaps_with_U_v_real": overlaps, "iteration_counts": eng.iteration_counts, "wall_s": wall,
          "iterations_per_s": iters / wall, "launches": counts, "checks": checks,
          "real_main_path": {"iteration_counts": main_iters, "wall_s": main_wall}})

    # K1's and K1x's complex instances on these tiles, beside K1 float32 on
    # the real main path's tiles of the same pattern.
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    timed = {}
    x = torch.randn(n, generator=gen, device=dev, dtype=torch.complex64)
    timed["complex64"] = check_k1c(torch, np, op.blocks, op.col_blocks, x, n, "hermitian_main_path", timing=True,
                                   f32_blocks=op_real.blocks)
    x = torch.randn(n, generator=gen, device=dev, dtype=torch.complex128)
    timed["complex64x128"] = check_k1c(torch, np, op.blocks, op.col_blocks, x, n, "hermitian_main_path", timing=True,
                                       f32_blocks=op_real.blocks)
    blocks128 = op.blocks.to(torch.complex128)
    timed["complex128"] = check_k1c(torch, np, blocks128, op.col_blocks, x, n, "hermitian_main_path_c128",
                                    timing=True, f32_blocks=op_real.blocks)
    del blocks128, x
    torch.cuda.empty_cache()
    return op, counts, timed


def _hofstadter_coo(np, L, alpha=HOF_ALPHA):
    """The Harper-Hofstadter square lattice, L x L, periodic, Landau gauge,
    t = 1, sites x + L*y: H[(x+1, y), (x, y)] = -1 and H[(x, y+1), (x, y)] =
    -exp(i 2 pi alpha x), with their conjugates."""
    x, y = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    x, y = x.ravel(), y.ravel()
    s = x + L * y
    sx = (x + 1) % L + L * y
    sy = x + L * ((y + 1) % L)
    hx = np.full(s.shape, -1.0 + 0j)
    hy = -np.exp(2j * np.pi * alpha * x)
    return (np.concatenate([sx, s, sy, s]), np.concatenate([s, sx, s, sy]),
            np.concatenate([hx, hx.conj(), hy, hy.conj()]))


def _harper_levels(np, L, q=4):
    """Every level of the L x L lattice at flux 1/q by Harper's reduction:
    for k_y = 2 pi m / L and k_x = 2 pi j / L (j < L/q), the q x q Bloch
    matrix with -2 cos(k_y + 2 pi x / q) on its diagonal, -1 between
    neighbours and the twist exp(i k_x q) on its wrap."""
    out = []
    for m in range(L):
        ky = 2 * np.pi * m / L
        for j in range(L // q):
            kx = 2 * np.pi * j / L
            mat = np.diag(-2.0 * np.cos(ky + 2 * np.pi * np.arange(q) / q)).astype(np.complex128)
            mat += np.diag(-np.ones(q - 1), 1) + np.diag(-np.ones(q - 1), -1)
            mat[q - 1, 0] += -np.exp(-1j * kx * q)
            mat[0, q - 1] += -np.exp(1j * kx * q)
            out.append(np.linalg.eigvalsh(mat))
    return np.sort(np.concatenate(out))


def phase_hermitian_facade(torch, np, dev):
    """``eigsh`` on the Harper-Hofstadter lattice (flux 1/4), held to
    Harper's reduction: k = 6 'SA' and 'BE' at L = 64 in complex64 (tol
    1e-5: K1 and K3 complex64), k = 6 'SA' with tol = 0 at L = 256 (the
    complex128 route over complex64 tiles: K1x complex and K3 complex128),
    and k = 2 nearest sigma = -1.85 (R4: shift-invert with the complex
    MINRES over complex128 tiles, K1 complex128)."""
    import lanczos_tpu_torch as tl

    out = {"phase": "hermitian_facade", "alpha": HOF_ALPHA}
    launches = {}

    def run(label, fn, want, bar):
        _launch_counts(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        rel = float(np.max(np.abs(np.asarray(w) - want) / np.abs(want)))
        out[label] = {"eigenvalues": list(map(float, w)), "harper": list(map(float, want)), "max_rel_err": rel,
                      "bar": bar, "wall_s": wall, "launches": counts}
        launches[label] = counts
        emit({"phase": "hermitian_facade_case", "case": label, **out[label]})
        if not rel <= bar:
            raise AssertionError(f"hermitian_facade {label}: {out[label]}")

    for L in (HOF_L, HOF_L_PRECISE):
        rows, cols, vals = _hofstadter_coo(np, L)
        ref = _harper_levels(np, L)
        op = tl.BSROperator.from_coo(rows, cols, vals, L * L, dtype=torch.complex64, device=dev)
        if L == HOF_L:
            run(f"SA_L{L}_complex64", lambda: tl.eigsh(op, k=6, which="SA", tol=HOF_C64_TOL,
                                                       return_eigenvectors=False), ref[:6], HOF_C64_BAR)
            run(f"BE_L{L}_complex64", lambda: tl.eigsh(op, k=6, which="BE", tol=HOF_C64_TOL,
                                                       return_eigenvectors=False),
                np.concatenate([ref[:3], ref[-3:]]), HOF_C64_BAR)
            op128 = tl.BSROperator.from_coo(rows, cols, vals, L * L, dtype=torch.complex128, device=dev)
            near = np.sort(ref[np.argsort(np.abs(ref - HOF_SIGMA))[:2]])
            run(f"sigma_L{L}_complex128", lambda: tl.eigsh(op128, k=2, sigma=HOF_SIGMA, return_eigenvectors=False),
                near, HOF_SIGMA_BAR)
            del op128
        else:
            run(f"SA_L{L}_tol0", lambda: tl.eigsh(op, k=6, which="SA", tol=0, return_eigenvectors=False),
                ref[:6], HOF_C128_BAR)
        del op
        torch.cuda.empty_cache()
    c64 = launches[f"SA_L{HOF_L}_complex64"]
    tight = launches[f"SA_L{HOF_L_PRECISE}_tol0"]
    sig = launches[f"sigma_L{HOF_L}_complex128"]
    if not (c64["k1_by_dtype"].get("complex64", 0) > 0 and c64["k3_by_dtype"].get("complex64", 0) > 0
            and tight["k1x_c64x128"] > 0 and tight["k3_by_dtype"].get("complex128", 0) > 0
            and sig["k1_by_dtype"].get("complex128", 0) > 0):
        raise AssertionError(f"hermitian_facade: the complex kernels were not launched: {launches}")
    emit(out)
    return {"k1_c128": sig["k1_by_dtype"]["complex128"], "k1x_c64x128": tight["k1x_c64x128"],
            "k3_c128": tight["k3_by_dtype"]["complex128"]}


def phase_expm_hermitian(torch, np, dev, op):
    """The Exponentiator on hermitian_main_path's complex64 operator, from
    phase expm_precise's default_rng(7) state psi: ``evolve`` 100 steps of
    0.05i at krylov_dim 16, ``run_chebyshev(5i)`` and ``evolve(precise=True)``
    10 steps, each against U times the real chain's own evolution of U^H
    psi (the float64 Chebyshev chain of the real chain whose hops are the
    stored entries' magnitudes, so that U R U^H is the stored operator)."""
    import lanczos_tpu_torch as tl

    n = MAIN_N
    rows, cols, vals, phi, mags = _gauge_chain(np)
    real_vals = vals.real.astype(np.float32).astype(np.float64)  # the potential as stored
    real_vals[: n - 1] = -mags
    real_vals[n - 1 : 2 * (n - 1)] = -mags
    op_r = tl.BSROperator.from_coo(rows, cols, real_vals, n, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)
    u = np.exp(1j * phi)
    w = u.conj() * psi

    def truth(a):
        (re, im), _ = tl.Exponentiator(op_r).run_chebyshev(a, w.real, w.imag, precise=True)
        t = u * (re + 1j * im)
        return t / np.linalg.norm(t)

    def angle(tn, re, im):
        o = np.asarray(re.cpu() if hasattr(re, "cpu") else re, np.float64) + 1j * np.asarray(
            im.cpu() if hasattr(im, "cpu") else im, np.float64)
        on = o / np.linalg.norm(o)
        ip = np.vdot(tn, on)
        return float(np.linalg.norm(on - (ip / abs(ip)) * tn))

    t5, t05 = truth(5.0j), truth(0.5j)
    del op_r
    ex = tl.Exponentiator(op)
    res = {}
    for label, fn, tn, bar in (
        ("evolve_100x0.05i", lambda: ex.evolve(0.05j, psi.real, psi.imag, 100, krylov_dim=16), t5, HERM_EVOLVE_BAR),
        ("chebyshev_5i", lambda: ex.run_chebyshev(5.0j, psi.real, psi.imag)[0], t5, HERM_CHEBY_BAR),
        ("evolve_precise_10x0.05i", lambda: ex.evolve(0.05j, psi.real, psi.imag, 10, krylov_dim=16, precise=True),
         t05, HERM_PRECISE_BAR),
    ):
        _launch_counts(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        re, im = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a = angle(tn, re, im)
        res[label] = {"angle": a, "bar": bar, "wall_s": wall, "launches": _read_counts()}
        if not a <= bar:
            raise AssertionError(f"expm_hermitian {label}: angle {a:.3e} above {bar:.0e}")
    terms = ex.run_chebyshev(5.0j, psi.real, psi.imag)[1]
    res["evolve_100x0.05i"]["ms_per_step"] = res["evolve_100x0.05i"]["wall_s"] / 100 * 1e3
    res["evolve_precise_10x0.05i"]["ms_per_step"] = res["evolve_precise_10x0.05i"]["wall_s"] / 10 * 1e3
    res["chebyshev_5i"].update(terms=terms, ms_per_term=res["chebyshev_5i"]["wall_s"] / terms * 1e3)
    emit({"phase": "expm_hermitian", "n": n, "storage": "complex64", **res})


# ---- ROADMAP item 13: K2 and K4 complex, the engines over row slabs ------


def check_k2c(torch, np, blocks, col_blocks, x, n_out, label, *, timing=False, k1_blocks=None):
    """One complex instance of K2 (complex64 or complex128 rsmk tiles
    against an x table of their dtype) or of K1x-rsmk (complex64 tiles
    against a complex128 table): against the plain version at K1C_TOL of
    max |y|, a bit-for-bit repeat, its launch count by dtype; with
    ``timing`` its time beside the bound (8 real operations a stored
    value), the plain version, a read stream of the tiles, K1 on
    ``k1_blocks`` (the same tiles in rmsk) and ``torch.sparse_bsr_tensor``
    over the rsmk tiles as they lie."""
    from lanczos_tpu_torch.ops import spmv

    r, s, bm, bk = blocks.shape
    c_rows = x.numel() // bk
    wide = x.dtype != blocks.dtype
    name = "complex64x128" if wide else str(blocks.dtype).replace("torch.", "")
    counter = (lambda: spmv.bsr_matvec_rsmk_c64x128.launches) if wide else (
        lambda: spmv.bsr_matvec_rsmk.launches_by_dtype[blocks.dtype])

    def kernel():
        return spmv.bsr_matvec_rsmk(blocks, col_blocks, x, n_out=n_out, col_bound=c_rows)

    def plain():
        return spmv.bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")[:n_out]

    before = counter()
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if counter() != before + 2 or got.dtype != x.dtype:
        raise AssertionError(f"K2 {name} {label}: {counter() - before} launches, output {got.dtype}")
    repeat = bool(torch.equal(got, again))
    err, rel = rel_err(got, plain())
    out = {"phase": "k2c", "kernel": name, "case": label, "shape": [r, s, bm, bk], "x_rows": c_rows, "n_out": n_out,
           "max_abs_err": err, "max_rel_err": rel, "tol": K1C_TOL[name], "bitwise_repeat": repeat,
           "plan": spmv.plan(bm, s, bk, x.element_size())}
    if not (rel <= K1C_TOL[name] and repeat):
        raise AssertionError(f"K2 {name} {label}: {out}")
    if timing:
        item = x.element_size()
        tiles = blocks.numel() * blocks.element_size()
        bytes_moved = tiles + col_blocks.numel() * 4 + (x.numel() + n_out) * item
        rate = F32_FLOPS if x.dtype == torch.complex64 else F64_FLOPS
        bound_ms, bound_by = bound(bytes_moved, 8 * blocks.numel(), rate)
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        stream_ms = cuda_ms(torch, lambda: torch.sum(torch.view_as_real(blocks)))
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gbps=bytes_moved / ms / 1e6,
                   stream_bound_ms=stream_ms * bytes_moved / tiles, fraction_of_bound=bound_ms / ms)
        if k1_blocks is not None:
            xk = x[: k1_blocks.shape[0] * k1_blocks.shape[1]]
            out["k1_same_tiles_ms"] = cuda_ms(torch, lambda: spmv.bsr_matvec(k1_blocks, col_blocks, xk, n_out=n_out))
        try:
            crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
            a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64),
                                        blocks.view(-1, bm, bk).to(x.dtype), size=(r * bm, c_rows * bk))
            out["library_max_rel_err"] = rel_err((a @ x)[:n_out], got)[1]
            out["library_ms"] = cuda_ms(torch, lambda: a @ x)
            del a
        except (RuntimeError, NotImplementedError, TypeError) as exc:  # PyTorch may refuse complex BSR on CUDA
            out["library_ms"], out["library_error"] = None, str(exc).splitlines()[0][:200]
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_k2c(torch, np, dev, herm_op):
    """K2's complex instances (complex64, complex128, and K1x-rsmk's
    complex64 x complex128) against their plain versions on seeded tiles:
    small, ragged, a footprint-shaped payload and bk = 8192 (past the
    float32 plan's shared-memory boundary); then each timed on the complex
    main path's tiles (``herm_op``, phase hermitian_main_path's operator)
    in rsmk, beside K1 on the same tiles in rmsk."""
    from lanczos_tpu_torch.ops import spmv

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    for label, (r, s, bm, bk, c_rows) in {
        "small": (4, 3, 8, 8, 4), "ragged": (37, 5, 16, 16, 40), "payload": (64, 3, 16, 16, 7),
        "smem_boundary_bk8192": (64, 1, 128, 8192, 2),
    }.items():
        for tile, xt in ((torch.complex64, torch.complex64), (torch.complex128, torch.complex128),
                         (torch.complex64, torch.complex128)):
            blocks = torch.randn((r, s, bm, bk), generator=gen, device=dev, dtype=tile)
            cb = torch.randint(0, c_rows, (r, s), generator=gen, device=dev, dtype=torch.int32)
            x = torch.randn(c_rows * bk, generator=gen, device=dev, dtype=xt)
            out = check_k2c(torch, np, blocks, cb, x, r * bm - 3, label)
            if label.startswith("smem") and not (out["plan"]["smem"] > spmv.plan(bm, s, bk, 4)["smem"]):
                raise AssertionError(f"K2 complex {label}: the complex plan is not past the float32 one: {out['plan']}")
            del blocks, cb, x
    rsmk = herm_op.blocks.permute(0, 2, 1, 3).contiguous()  # (R, S, bm, bk)
    timed = {}
    x = torch.randn(herm_op.n_padded, generator=gen, device=dev, dtype=torch.complex64)
    timed["complex64"] = check_k2c(torch, np, rsmk, herm_op.col_blocks, x, herm_op.n, "hermitian_main_path",
                                   timing=True, k1_blocks=herm_op.blocks)
    x = x.to(torch.complex128)
    timed["complex64x128"] = check_k2c(torch, np, rsmk, herm_op.col_blocks, x, herm_op.n, "hermitian_main_path",
                                       timing=True, k1_blocks=herm_op.blocks)
    del rsmk
    torch.cuda.empty_cache()
    rsmk128 = herm_op.blocks.permute(0, 2, 1, 3).to(torch.complex128).contiguous()
    timed["complex128"] = check_k2c(torch, np, rsmk128, herm_op.col_blocks, x, herm_op.n, "hermitian_main_path_c128",
                                    timing=True)
    del rsmk128, x
    torch.cuda.empty_cache()
    return timed


def check_k4c(torch, basis, vblk, k, *, timing=False):
    """K4's complex instance: against the plain version (conjugated
    coefficients) at K3C_TOL, twice bit for bit, counted by dtype; with
    ``timing`` beside the bound (the k live rows and the block read once,
    the block written once; 16 real operations per basis value and block
    row), the plain version, two conjugated ``torch.matmul`` and the
    two-read stream of the rows."""
    from lanczos_tpu_torch.ops import cgs

    name = str(basis.dtype).replace("torch.", "")
    b, n = vblk.shape
    want = cgs.cgs_pass_block_reference(vblk, basis, k)
    before = cgs.cgs_pass_block.launches_by_dtype[basis.dtype]
    got = cgs.cgs_pass_block(vblk.clone(), basis, k)
    again = cgs.cgs_pass_block(vblk.clone(), basis, k)
    torch.cuda.synchronize()
    if cgs.cgs_pass_block.launches_by_dtype[basis.dtype] != before + 2:
        raise AssertionError(f"K4 {name} k={k}: launches by dtype {dict(cgs.cgs_pass_block.launches_by_dtype)}")
    err, rel = rel_err(got, want)
    repeat = bool(torch.equal(got, again))
    out = {"phase": "k4c", "kernel": name, "basis": list(basis.shape), "b": b, "k": k, "max_abs_err": err,
           "max_rel_err": rel, "tol": K3C_TOL[name], "bitwise_repeat": repeat}
    if not (rel <= K3C_TOL[name] and repeat):
        raise AssertionError(f"K4 {name}: {out}")
    if timing:
        work = vblk.clone()
        rows = basis[:k]
        item = basis.element_size()
        sms = torch.cuda.get_device_properties(basis.device).multi_processor_count
        ms = cuda_ms(torch, lambda: cgs.cgs_pass_block(work, basis, k))
        plain_ms = cuda_ms(torch, lambda: cgs.cgs_pass_block_reference(vblk, basis, k))
        library_ms = cuda_ms(torch, lambda: vblk - torch.matmul(torch.matmul(rows.conj(), vblk.T).T, rows))
        stream_ms = cuda_ms(torch, lambda: torch.sum(torch.view_as_real(rows)))
        rate = F32_FLOPS if basis.dtype == torch.complex64 else F64_FLOPS
        bound_ms, bound_by = bound(k * n * item + 2 * b * n * item, 16 * k * b * n, rate)
        plan = cgs.block_plan(n, b, item, sms)
        out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   two_read_stream_ms=2 * stream_ms, gbps=2 * k * n * item / ms / 1e6,
                   fraction_of_bound=bound_ms / ms, fraction_of_stream=2 * stream_ms / ms, plan=plan._asdict(),
                   **_k4_info(torch, basis.device, b, basis.dtype, plan))
    emit(out)
    return out


def phase_k4c(torch, dev):
    """K4 complex64 and complex128 on the flagship's (258, 2**22) buffer at
    b = 3, k = 24, 96 and 255 (timed), every width bucket at a few k, and
    a ragged (129, 70001) basis."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    timed = {}
    for dtype in (torch.complex64, torch.complex128):
        basis = _random_basis(torch, dev, 258, K4_N, dtype, gen)
        for k in (24, 96, 255):
            vblk = torch.randn((3, K4_N), generator=gen, device=dev, dtype=dtype)
            timed[(dtype, k)] = check_k4c(torch, basis, vblk, k, timing=True)
        for b in (1, 2, 4, 5, 16):
            vblk = torch.randn((b, K4_N), generator=gen, device=dev, dtype=dtype)
            for k in (1, 9, 258):
                check_k4c(torch, basis, vblk, k)
        del basis, vblk
        torch.cuda.empty_cache()
        basis = _random_basis(torch, dev, 129, 70001, dtype, gen)
        for b in (3, 16):
            vblk = torch.randn((b, 70001), generator=gen, device=dev, dtype=dtype)
            for k in (1, 7, 129):
                check_k4c(torch, basis, vblk, k)
        del basis, vblk
        torch.cuda.empty_cache()
    return timed


# The split pass's bars against the plain version given the same reduce,
# relative to the output's largest entry, by dtype.
SPLIT_TOL = {"float32": 1e-5, "float64": 1e-12, **K3C_TOL}


def phase_split_passes(torch, dev):
    """K3 and K4 in the split form that every engine runs over rows split
    across more than one rank (projection, an all-reduce of the
    coefficients between the wrapper's two calls, update): here with the
    reduce an identity (the bits of the whole pass) and a halving (the
    plain version given the same reduce), in every dtype, K3 at
    (177, 2**20) with k = 176 (the main path's deepest pass) and K4 at
    (256, 2**20) with b = 3 and k = 255; both forms timed, since the card's
    machine has one H100 and runs no world of more than one rank."""
    from lanczos_tpu_torch.ops import cgs

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    rows = []
    for name, fn, plain, cap, k, shape in (("k3", cgs.cgs_pass, cgs.cgs_pass_reference, 177, 176, (MAIN_N,)),
                                           ("k4", cgs.cgs_pass_block, cgs.cgs_pass_block_reference, 256, 255,
                                            (3, MAIN_N))):
        for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
            label = str(dtype).replace("torch.", "")
            basis = _random_basis(torch, dev, cap, MAIN_N, dtype, gen)
            v = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            before = fn.launches_by_dtype[dtype]
            whole = fn(v.clone(), basis, k)
            same = fn(v.clone(), basis, k, lambda c: c)
            halved = fn(v.clone(), basis, k, lambda c: c.mul_(0.5))
            torch.cuda.synchronize()
            if fn.launches_by_dtype[dtype] != before + 3:
                raise AssertionError(f"split {name} {label}: launches by dtype {dict(fn.launches_by_dtype)}")
            err, rel = rel_err(halved, plain(v, basis, k, lambda c: c * 0.5))
            out = {"phase": "split_passes", "kernel": name, "dtype": label, "basis": [cap, MAIN_N],
                   "block": list(shape), "k": k, "identity_bits_equal": bool(torch.equal(same, whole)),
                   "max_abs_err": err, "max_rel_err": rel, "tol": SPLIT_TOL[label]}
            if not (out["identity_bits_equal"] and rel <= SPLIT_TOL[label]):
                raise AssertionError(f"split {name} {label}: {out}")
            work = v.clone()
            out["whole_ms"] = cuda_ms(torch, lambda: fn(work, basis, k))
            out["split_ms"] = cuda_ms(torch, lambda: fn(work, basis, k, lambda c: c))
            out["split_over_whole"] = out["split_ms"] / out["whole_ms"]
            emit(out)
            rows.append(out)
            del basis, v, work, whole, same, halved
            torch.cuda.empty_cache()
    return rows


def phase_block_hermitian(torch, np, dev, herm_op, ref):
    """The block-thick engine on complex input on the card: b = 3, a
    128-row basis, on hermitian_main_path's gauge-phased complex64 operator
    (K1 and K4 complex64), the values within HERM_MAIN_BAR of main_path's
    scipy values; then the L = 64 Harper-Hofstadter lattice in complex128
    (K1 and K4 complex128) against Harper's reduction."""
    import lanczos_tpu_torch as tl

    out = {"phase": "block_hermitian"}
    eng = tl.LambdaLanczos(herm_op, num_eigs=3, find_maximum=False)
    eng.block_size, eng.restart_policy, eng.max_iteration = 3, "thick", 128
    eng.eps, eng.stop_when_full, eng.max_restarts = 1e-6, True, 32
    rng = np.random.default_rng(SEED)  # distinct start rows, the same every run
    eng.init_vector = lambda n_: (rng.uniform(-1.0, 1.0, n_) + 1j * rng.uniform(-1.0, 1.0, n_)).astype(np.complex64)
    _launch_counts(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evals, evecs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    rel = np.abs(np.sort(np.asarray(evals)) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    if not (counts["k4_by_dtype"].get("complex64", 0) > 0 and counts["k1_by_dtype"].get("complex64", 0) > 0
            and set(counts["k4_by_dtype"]) == {"complex64"}):
        raise AssertionError(f"block_hermitian: K4 and K1 complex64 expected, launches {counts}")
    if not (evecs.dtype == torch.complex64 and evecs.shape == (3, herm_op.n) and np.all(rel <= HERM_MAIN_BAR)
            and max(residuals) <= HERM_RES_BAR):
        raise AssertionError(f"block_hermitian: eigenvalues {evals} vs {ref} ({rel}), residuals {residuals}")
    out["main_path_complex64"] = {"n": herm_op.n, "block_size": 3, "max_iteration": 128,
                                  "eigenvalues": list(map(float, evals)), "max_rel_err": float(rel.max()),
                                  "bar": HERM_MAIN_BAR, "residuals": residuals,
                                  "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches": counts}
    rows, cols, vals = _hofstadter_coo(np, HOF_L)
    harper = _harper_levels(np, HOF_L)
    op128 = tl.BSROperator.from_coo(rows, cols, vals, HOF_L * HOF_L, dtype=torch.complex128, device=dev)
    eng = tl.LambdaLanczos(op128, num_eigs=3, find_maximum=False)
    eng.block_size, eng.restart_policy, eng.max_iteration, eng.eps, eng.max_restarts = 3, "thick", 96, 1e-12, 64
    rng = np.random.default_rng(SEED + 1)
    eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_) + 1j * rng.uniform(-1.0, 1.0, n_)
    _launch_counts(torch)
    t0 = time.perf_counter()
    evals, _ = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts128 = _read_counts()
    rel = np.abs(np.sort(np.asarray(evals)) - harper[:3]) / np.abs(harper[:3])
    if not (counts128["k4_by_dtype"].get("complex128", 0) > 0 and np.all(rel <= HOF_C128_BAR)):
        raise AssertionError(f"block_hermitian Hofstadter: {evals} vs {harper[:3]} ({rel}), launches {counts128}")
    out["hofstadter_complex128"] = {"L": HOF_L, "eigenvalues": list(map(float, evals)), "harper": harper[:3].tolist(),
                                    "max_rel_err": float(rel.max()), "bar": HOF_C128_BAR,
                                    "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches": counts128}
    emit(out)
    return {"k4_c64": counts["k4_by_dtype"]["complex64"], "k4_c128": counts128["k4_by_dtype"]["complex128"]}


def _angle(np, truth, out):
    """The state angle between two complex vectors (``engine_set.angle``)."""
    from lanczos_tpu_torch.parallel.engine_set import angle

    return angle(truth, out)


def sharded_engines(torch, np, mesh, op, ref, thick, herm, pv_ref, chain):
    """Every engine of ROADMAP item 13 over the one-rank NCCL world of
    phase sharded_main_path: ``engine_set.engine_set``'s f32, pv, dia and
    complex groups, the set that ``multichip --engines`` runs on four
    cards.  Over its ShardedBSROperator ``op`` (the main path's problem):
    thick (beside phase thick_scalar's run ``thick``), block thick (b = 3,
    K4 at world size 1), a CheckpointedRun stopped after its first round
    and resumed, precise thick (K1x-rsmk); over a ShardedDIAOperator of the
    n = 2**20 chain: filtered_lanczos at degree 400 (the unfused chain over
    the sharded matvec), evolve and run_chebyshev against phase
    expm_chain's unsharded states ``chain``, the fused run against the
    hybrid; the complex main path (K2 complex64, beside phase
    hermitian_main_path's run ``herm``) with a precise evolution (K1x-rsmk
    complex64 x complex128), a complex128 run (K2 complex128) and a
    complex128 run over DIA slabs.  One ``sharded_engines_case`` line a
    case.  Returns K2's complex launches by instance."""
    from lanczos_tpu_torch.parallel.engine_set import engine_set

    refs = {"ref": ref, "ref32": pv_ref, "thick": thick, "herm": herm, "chain": chain}
    records = engine_set(mesh, groups=("f32", "pv", "dia", "complex"), refs=refs, op=op, emit=emit,
                         phase="sharded_engines_case", counting=counting_checks)
    emit({"phase": "sharded_engines", "world_size": mesh.size, "n": op.n, **records})
    return {"k2_c64": records["complex_main_path"]["launches"]["k2_by_dtype"]["complex64"],
            "k2_c128": records["complex128_run"]["launches"]["k2_by_dtype"]["complex128"],
            "k2_c64x128": records["complex_evolve_precise"]["launches"]["k1x_rsmk_c64x128"]}


# ---- bfloat16 tiles (ROADMAP queue 2: K1 and K2 for bfloat16 tiles) --------


def _bf16_entries(np, vals):
    """The main path's COO values as its bfloat16 tiles hold them, in
    float64 (``engine_set.bf16_entries``)."""
    from lanczos_tpu_torch.parallel.engine_set import bf16_entries

    return bf16_entries(vals)


def check_bf16(torch, blocks, col_blocks, n_out, layout, label, gen, *, timing=False):
    """The bfloat16 instances on ``blocks`` (bfloat16 tiles; 'rmsk': K1
    against a float32 x and K1x against a float64 one, 'rsmk': K2 and
    K1x-rsmk): each against its plain version and against its float32-tile
    twin over the widened tiles (the same products in another order: a lane
    reads 8 bfloat16 values where it reads 4 float32 ones), at BF16_TOL of
    max |y| for a float32 x and K1X_TOL for a float64 one, a bit-for-bit
    repeat and its own launch count; with ``timing`` its time by CUDA events
    beside the bound (2 bytes a stored value; float64 operations at the
    float64 rate for K1x), the plain version, the float32 twin, a read
    stream of the bfloat16 tiles and ``torch.sparse_bsr_tensor`` over a
    float32 (float64 for K1x) copy of the tiles @ x.  Returns the two
    lines by x dtype."""
    import torch.nn.functional as F

    from lanczos_tpu_torch.ops import spmv

    wide = blocks.float()  # the float32 twin's tiles: the same values, exactly
    if layout == "rmsk":
        r, bm, s, bk = blocks.shape
        x_len = n_out  # K1 reads the unpadded vector

        def call(b, x):
            return spmv.bsr_matvec(b, col_blocks, x, n_out)

        def plain(x):
            return spmv.bsr_matvec_reference(blocks, col_blocks, F.pad(x, (0, r * bm - x.shape[0])), layout="rmsk")[:n_out]

        counters = {torch.float32: spmv.bsr_matvec, torch.float64: spmv.bsr_matvec_bf16x64}
        names = {torch.float32: "k1_bf16", torch.float64: "k1x_bf16x64"}
    else:
        r, s, bm, bk = blocks.shape
        x_len = r * bm  # the whole vector as K2's table
        c_rows = x_len // bk

        def call(b, x):
            return spmv.bsr_matvec_rsmk(b, col_blocks, x, n_out, col_bound=c_rows)

        def plain(x):
            return spmv.bsr_matvec_reference(blocks, col_blocks, x, layout="rsmk")[:n_out]

        counters = {torch.float32: spmv.bsr_matvec_rsmk, torch.float64: spmv.bsr_matvec_rsmk_bf16x64}
        names = {torch.float32: "k2_bf16", torch.float64: "k1x_rsmk_bf16x64"}
    outs = {}
    for xtype, tol in ((torch.float32, BF16_TOL), (torch.float64, K1X_TOL)):
        x = torch.randn(x_len, generator=gen, device=blocks.device, dtype=xtype)
        counter = counters[xtype]
        before = counter.launches
        got, again = call(blocks, x), call(blocks, x)
        torch.cuda.synchronize()
        if counter.launches != before + 2 or got.dtype != xtype:
            raise AssertionError(f"{names[xtype]} {label}: {counter.launches - before} launches, output {got.dtype}")
        err, rel = rel_err(got, plain(x))
        twin_rel = rel_err(got, call(wide, x))[1]
        out = {"phase": "bf16_kernel", "kernel": names[xtype], "case": label, "layout": layout,
               "shape": list(blocks.shape), "n_out": n_out, "x_dtype": str(xtype), "max_abs_err": err,
               "max_rel_err": rel, "f32_tiles_max_rel_err": twin_rel, "tol": tol,
               "bitwise_repeat": bool(torch.equal(got, again))}
        if not (rel <= tol and twin_rel <= tol and out["bitwise_repeat"]):
            raise AssertionError(f"bfloat16 {names[xtype]} {label}: {out}")
        if timing:
            tiles = blocks.numel() * 2
            # Each input read once (tiles, column indices, x), y written once;
            # one multiply and one add a stored value in x's type.
            bytes_moved = tiles + col_blocks.numel() * 4 + (x_len + n_out) * x.element_size()
            bound_ms, bound_by = bound(bytes_moved, 2 * blocks.numel(),
                                       F32_FLOPS if xtype == torch.float32 else F64_FLOPS)
            ms = cuda_ms(torch, lambda: call(blocks, x))
            plain_ms = cuda_ms(torch, lambda: plain(x))
            f32_ms = cuda_ms(torch, lambda: call(wide, x))
            stream_ms = cuda_ms(torch, lambda: torch.sum(blocks))
            values = (wide.permute(0, 2, 1, 3) if layout == "rmsk" else wide).reshape(r * s, bm, bk).to(xtype)
            crow = torch.arange(0, r * s + 1, s, dtype=torch.int64, device=blocks.device)
            a = torch.sparse_bsr_tensor(crow, col_blocks.reshape(-1).to(torch.int64), values, size=(r * bm, r * bm))
            xp = F.pad(x, (0, r * bm - x_len))
            lib_rel = rel_err((a @ xp)[:n_out], got)[1]
            library_ms = cuda_ms(torch, lambda: a @ xp)
            del a, values
            torch.cuda.empty_cache()
            out.update(ms=ms, plain_ms=plain_ms, f32_kernel_ms=f32_ms, library_ms=library_ms,
                       library_max_rel_err=lib_rel, bound_ms=bound_ms, bound_by=bound_by, tile_gb=tiles / 1e9,
                       gbps=bytes_moved / ms / 1e6, stream_bound_ms=stream_ms * bytes_moved / tiles,
                       fraction_of_bound=bound_ms / ms)
        emit(out)
        outs[xtype] = out
    return outs


# Shapes of the bfloat16 kernel checks beyond the small one: the scalar
# loop (bk = 12), K1x's body with an odd row count and a partial chunk (9
# rows, 40 vectors a row against 16 lanes of 3), pieces wider than their
# register chunk (bk = 1024: four tiles a piece, four chunks of 32 lanes of
# 4, then a piece of one tile), and the 64 Mi stored nnz case.
BF16_SHAPES = {
    "ragged_bk12": (37, 12, 5, 12),
    "odd_rows_partial_chunk": (64, 9, 5, 64),
    "wide_piece": (128, 16, 5, 1024),
    "bench_64Mi_nnz": (BENCH_R, 128, 8, 128),
}


def bf16x64_plans(torch):
    """K1x's bfloat16 body at the shapes phases k1bf16 and k2bf16 run, in
    both layouts: the plan the library makes (``lt_bsr_spmv_bf16x64_info``)
    against ``spmv.bf16x64_plan``, with the selected kernel's registers,
    local (spill) bytes a thread and resident CTAs a multiprocessor."""
    import ctypes

    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.ops import spmv

    shapes = {"small": (4, 8, 3, 8), **BF16_SHAPES, "main_path": (MAIN_N // 128, 128, 3, 128)}
    out = {}
    for label, (_r, bm, s, bk) in shapes.items():
        want = spmv.bf16x64_plan(bm, s, bk)
        for layout, rsmk in (("rmsk", 0), ("rsmk", 1)):
            info = (ctypes.c_int * 8)()
            _build.check(_build.library().lt_bsr_spmv_bf16x64_info(bm, s, bk, rsmk, info), "lt_bsr_spmv_bf16x64_info")
            got = {"lanes_per_row": info[0], "vectors_per_lane": info[1], "s_piece": info[2], "smem": info[3],
                   "opt_in": bool(info[4])}
            if got != want:
                raise AssertionError(f"bf16x64 plan {label} {layout}: the library's {got}, the Python plan's {want}")
            out[f"{label}_{layout}"] = {**got, "registers": info[5], "local_bytes": info[6], "ctas_per_sm": info[7]}
    emit({"phase": "bf16x64_plan", "plans": out})
    return out


def phase_k1bf16(torch, dev, op):
    """K1 and K1x on bfloat16 tiles: a small shape, :data:`BF16_SHAPES`
    (the last of them, the 64 Mi stored nnz case, timed) and the main path's
    tiles in bfloat16 (``op``, timed); first K1x's plans and registers
    (:func:`bf16x64_plans`)."""
    bf16x64_plans(torch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    for label, (r, bm, s, bk, n) in {
        "small": (4, 8, 3, 8, 30),
        **{k: (r, bm, s, bk, r * bm - (5 if k == "ragged_bk12" else 0)) for k, (r, bm, s, bk) in BF16_SHAPES.items()},
    }.items():
        blocks, cb = _random_bsr(torch, dev, r, bm, s, bk, torch.float32, gen)
        check_bf16(torch, blocks.to(torch.bfloat16), cb, n, "rmsk", label, gen, timing=label.startswith("bench"))
        del blocks, cb
        torch.cuda.empty_cache()
    return check_bf16(torch, op.blocks, op.col_blocks, op.n, "rmsk", "main_path", gen, timing=True)


def phase_k2bf16(torch, dev, op_rsmk, op_rmsk):
    """K2 and K1x-rsmk on bfloat16 tiles: a small shape, :data:`BF16_SHAPES`
    (the 64 Mi stored nnz case timed) and the main path's tiles in rsmk
    (``op_rsmk``, the one-rank sharded operator's, timed); on the same tiles
    in both layouts K1 bfloat16 against K2 bfloat16 (a float32 x) and K1x
    bfloat16 against K1x-rsmk bfloat16 (a float64 x) bit for bit: at bm =
    bk = 128 lane q of K1 and K2 covers the same flattened (s, k) of a row,
    and K1x's body maps its lanes to the same (s, k) in both layouts at
    every shape it takes (bk % 8 == 0)."""
    from lanczos_tpu_torch.ops import spmv

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    bits = {torch.float32: {}, torch.float64: {}}

    def same_bits(label, rmsk, cb_rmsk, rsmk, cb_rsmk, n_pad):
        for xtype, table in bits.items():
            if xtype == torch.float32 and rmsk.shape[1] != 128 and label != "small":
                continue  # K1 = K2 in float32 is claimed at bm = bk = 128 (and the small shape) only
            x = torch.randn(n_pad, generator=gen, device=dev, dtype=xtype)
            table[label] = bool(torch.equal(spmv.bsr_matvec(rmsk, cb_rmsk, x), spmv.bsr_matvec_rsmk(rsmk, cb_rsmk, x)))

    for label, (r, bm, s, bk) in {"small": (4, 8, 3, 8), **BF16_SHAPES}.items():
        if bk % 8:
            continue  # the scalar loop: phase k1bf16 holds it in rmsk
        blocks, cb = _random_bsr(torch, dev, r, bm, s, bk, torch.float32, gen)
        rmsk = blocks.to(torch.bfloat16)
        rsmk = rmsk.permute(0, 2, 1, 3).contiguous()
        check_bf16(torch, rsmk, cb, r * bm, "rsmk", label, gen, timing=label.startswith("bench"))
        same_bits(label, rmsk, cb, rsmk, cb, r * bm)
        del blocks, cb, rmsk, rsmk
        torch.cuda.empty_cache()
    timed = check_bf16(torch, op_rsmk.blocks, op_rsmk.col_blocks, op_rsmk.n, "rsmk", "main_path", gen, timing=True)
    if not torch.equal(op_rmsk.blocks.permute(0, 2, 1, 3), op_rsmk.blocks):
        raise AssertionError("k2bf16: the sharded operator's tiles are not the main path's in rsmk")
    same_bits("main_path", op_rmsk.blocks, op_rmsk.col_blocks, op_rsmk.blocks, op_rsmk.col_blocks, op_rsmk.n_padded)
    emit({"phase": "k2bf16", "k1_equals_k2_bitwise": bits[torch.float32],
          "k1x_equals_k1x_rsmk_bitwise": bits[torch.float64]})
    if not all(v for table in bits.values() for v in table.values()):
        raise AssertionError(f"k2bf16: the rmsk and rsmk bfloat16 instances differ: {bits}")
    return timed


def phase_bf16_main_path(torch, np, dev):
    """The main path's problem with bfloat16 tiles: ``BSROperator.from_coo(
    ..., dtype=torch.bfloat16)`` through ``LambdaLanczos(op, num_eigs=3,
    dtype=torch.float32)``, fused (K1 bfloat16, K3 and K6 float32; no
    float32 K1 launch), against scipy eigsh in float64 on the rounded
    entries (BF16_MAIN_BAR relative, residuals BF16_RES_BAR); the same tiles
    with ``precise_vectors`` (K1x bfloat16 x float64, PV_MAIN_BAR); one
    ``Exponentiator.run(-0.5, v)`` from a seeded unit vector against the
    same run over a float32 operator holding the rounded values (both at
    eps 1e-12, state angle BF16_EXPM_ANGLE_BAR).  The one-rank NCCL part
    runs in phase sharded_main_path's world (:func:`sharded_bf16`)."""
    import scipy.sparse
    import scipy.sparse.linalg

    import lanczos_tpu_torch as tl

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np)
    t0 = time.perf_counter()
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=128, bk=128, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    a_bf = scipy.sparse.coo_matrix((_bf16_entries(np, vals), (rows, cols)), shape=(n, n)).tocsr()
    t0 = time.perf_counter()
    ref = np.sort(scipy.sparse.linalg.eigsh(a_bf, k=3, which="SA", tol=0)[0])
    scipy_s = time.perf_counter() - t0

    eng = _main_path_engine(tl, torch, op, dtype=torch.float32)
    _launch_counts(torch)
    with counting_checks() as checks:
        t0 = time.perf_counter()
        evals, evecs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counts()
    counts["k6"] = checks["k6_launches"]
    if not (counts["k1_by_dtype"].get("bfloat16", 0) > 0 and set(counts["k1_by_dtype"]) == {"bfloat16"}
            and counts["k3_by_dtype"].get("float32", 0) > 0 and counts["k6"] > 0):
        raise AssertionError(f"bf16 main path: launches {counts} (K1 bfloat16 only, K3 and K6 float32 expected)")
    check_stats(checks)
    rel = np.abs(np.sort(np.asarray(evals)) - ref) / np.abs(ref)
    residuals = eng.residuals(evals, evecs)
    if not (evecs.shape == (3, n) and evecs.dtype == torch.float32 and bool(torch.isfinite(evecs).all())):
        raise AssertionError(f"bf16 main path: eigenvectors {evecs.dtype} {tuple(evecs.shape)}")
    if not (np.all(rel <= BF16_MAIN_BAR) and max(residuals) <= BF16_RES_BAR):
        raise AssertionError(f"bf16 main path: eigenvalues {evals} vs scipy {ref}: {rel}, residuals {residuals}")
    line = {"phase": "bf16_main_path", "n": n, "storage": "bfloat16", "vectors": "float32", "mode": eng._resolve_mode(),
            "tiles": list(op.blocks.shape), "tile_gb": op.blocks.numel() * 2 / 1e9, "pack_s": pack_s,
            "eigenvalues": list(map(float, evals)), "scipy_eigsh_bf16_entries": ref.tolist(),
            "max_rel_err": float(rel.max()), "bar": BF16_MAIN_BAR, "residuals": residuals,
            "iteration_counts": eng.iteration_counts, "wall_s": wall,
            "iterations_per_s": sum(eng.iteration_counts) / wall, "launches": counts, "checks": checks,
            "scipy_s": scipy_s}

    # The precise tier over the same tiles: K1x bfloat16 x float64.
    pv = _main_path_engine(tl, torch, op, dtype=torch.float32)
    pv.precise_vectors = True
    pv.eps = 1e-12
    (pvals, _pvecs), pv_wall, pv_counts = _pv_counts(torch, pv.run)
    pv_err = np.abs(np.sort(np.asarray(pvals)) - ref)
    if not (pv_counts["k1x_bf16x64"] > 0 and pv_counts["k1"] == 0 and pv_counts["k1x"] == 0
            and _all_f64(pv_counts, "k3_by_dtype") and _all_f64(pv_counts, "k6_by_dtype")):
        raise AssertionError(f"bf16 pv: launches {pv_counts} (K1x bfloat16, float64 K3 and K6 expected, no K1)")
    if not np.all(pv_err <= PV_MAIN_BAR):
        raise AssertionError(f"bf16 pv: eigenvalues {pvals} vs scipy {ref}: errors {pv_err}")
    line["precise"] = {"eps": pv.eps, "eigenvalues": list(map(float, pvals)), "abs_errs": pv_err.tolist(),
                       "bar": PV_MAIN_BAR, "iteration_counts": pv.iteration_counts, "wall_s": pv_wall,
                       "launches": pv_counts}

    # One Exponentiator.run over the bfloat16 tiles against float32 tiles
    # holding the same values.
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    v = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
    v /= torch.linalg.vector_norm(v)
    op32 = tl.BSROperator(op.blocks.float(), op.col_blocks, n)
    expm = {}
    for label, operator in (("bfloat16", op), ("float32", op32)):
        ex = tl.Exponentiator(operator, dtype=torch.float32)
        ex.max_iteration = EXPM_BSR_MAX_ITER
        ex.eps = 1e-12
        _launch_counts(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, itern = ex.run(-0.5, v)
        torch.cuda.synchronize()
        expm[label] = {"out": out, "iterations": itern, "ms": (time.perf_counter() - t0) * 1e3,
                       "k1_by_dtype": _read_counts()["k1_by_dtype"]}
    del op32
    angle = _angle(np, expm["float32"]["out"].double().cpu().numpy(), expm["bfloat16"]["out"].double().cpu().numpy())
    if not (expm["bfloat16"]["k1_by_dtype"] == {"bfloat16": expm["bfloat16"]["k1_by_dtype"].get("bfloat16", 0)}
            and expm["bfloat16"]["k1_by_dtype"].get("bfloat16", 0) > 0 and angle <= BF16_EXPM_ANGLE_BAR
            and max(r["iterations"] for r in expm.values()) < EXPM_BSR_MAX_ITER):
        raise AssertionError(f"bf16 expm: angle {angle:.3e}, {[(k, r['iterations'], r['k1_by_dtype']) for k, r in expm.items()]}")
    line["expm_run"] = {"a": -0.5, "eps": 1e-12, "angle_vs_float32_tiles": angle, "bar": BF16_EXPM_ANGLE_BAR,
                        **{f"{k}_{key}": r[key] for k, r in expm.items() for key in ("iterations", "ms", "k1_by_dtype")}}
    emit(line)
    return {"op": op, "ref": ref, "iteration_counts": eng.iteration_counts, "wall_s": wall,
            "k1_launches": counts["k1_by_dtype"]["bfloat16"], "k1x_launches": pv_counts["k1x_bf16x64"]}


def sharded_bf16(torch, np, mesh, bf16):
    """The bfloat16 main path over the one-rank NCCL ShardedBSROperator
    (phase sharded_main_path's world): ``ShardedBSROperator.from_coo(...,
    dtype=torch.bfloat16)`` through ``engine_set.engine_set``'s bf16 group,
    fused over float32 slabs (K2 bfloat16; the unsharded bfloat16 run's
    iteration counts, as K2 gives K1's bits), then precise (K1x-rsmk
    bfloat16 x float64), against phase bf16_main_path's scipy values.
    Returns the operator for phase k2bf16 and the counts."""
    from lanczos_tpu_torch.parallel.engine_set import engine_set
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    n = MAIN_N
    rows, cols, vals = _main_path_coo(np)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=128, bk=128, dtype=torch.bfloat16)
    refs = {"ref_bf16": bf16["ref"], "bf16_iteration_counts": bf16["iteration_counts"]}
    records = engine_set(mesh, groups=("bf16",), refs=refs, bf16_op=op, emit=None)
    fused, pv = records["bf16_fused"], records["bf16_precise"]
    emit({"phase": "bf16_sharded", "n": n, "world_size": mesh.size, "comm": op.comm, "tiles": list(op.blocks.shape),
          "eigenvalues": fused["values"], "max_rel_err": fused["max_err"], "bar": fused["bar"],
          "iteration_counts": fused["iteration_counts"], "unsharded_iteration_counts": bf16["iteration_counts"],
          "wall_s": fused["wall_s"], "unsharded_wall_s": bf16["wall_s"], "launches": fused["launches"],
          "precise": {"eigenvalues": pv["values"], "abs_errs": pv["max_err"], "bar": pv["bar"],
                      "iteration_counts": pv["iteration_counts"], "wall_s": pv["wall_s"], "launches": pv["launches"]}})
    return {"op": op, "k2_launches": fused["launches"]["k2_by_dtype"]["bfloat16"],
            "k1x_rsmk_launches": pv["launches"]["k1x_rsmk_bf16x64"]}


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
    timed("host_tridiagonal", phase_host_tridiagonal, np)
    k6 = timed("k6", phase_k6, torch, np, dev)
    timed("k1", phase_k1, torch, dev)
    timed("k3", phase_k3, torch, dev)
    k4 = timed("k4", phase_k4, torch, dev)
    e2_launches, e2 = timed("e2", phase_e2, torch, dev)
    e3_launches, e3 = timed("e3", phase_e3, torch, dev)
    e1_launches, e1 = timed("e1", phase_e1, torch, dev)
    timed("expm_zoo", phase_expm_zoo, torch, np, dev)
    chain = timed("expm_chain", phase_expm_chain, torch, np, dev)
    timed("small_solves", phase_small_solves, torch, np, dev)
    launches, k1, k3, op, ref, main_iters, k3_seq, main_evecs = timed("main_path", phase_main_path, torch, np, dev)
    pv_main = timed("pv_main_path", phase_pv_main_path, torch, np, dev, op)
    bf16 = timed("bf16_main_path", phase_bf16_main_path, torch, np, dev)
    k1bf16 = timed("k1bf16", phase_k1bf16, torch, dev, bf16["op"])
    thick = timed("thick_scalar", phase_thick_scalar, torch, np, op, ref)
    timed("operators", phase_operators, torch, np, dev, ref)
    timed("expm_bsr", phase_expm_bsr, torch, np, dev, op)
    timed("expm_small", phase_expm_small, torch, np, dev)
    herm_op, herm_counts, k1c = timed("hermitian_main_path", phase_hermitian_main_path, torch, np, dev, op, ref,
                                      *main_evecs, main_iters)
    timed("expm_hermitian", phase_expm_hermitian, torch, np, dev, herm_op)
    block_herm = timed("block_hermitian", phase_block_hermitian, torch, np, dev, herm_op, ref)
    k2c = timed("k2c", phase_k2c, torch, np, dev, herm_op)
    del op, herm_op, main_evecs
    torch.cuda.empty_cache()
    timed("k1c", phase_k1c, torch, np, dev)
    k3c = timed("k3c", phase_k3c, torch, dev)
    k4c = timed("k4c", phase_k4c, torch, dev)
    timed("split_passes", phase_split_passes, torch, dev)
    facade = timed("hermitian_facade", phase_hermitian_facade, torch, np, dev)
    torch.cuda.empty_cache()
    timed("k3_path", phase_k3_path, torch, dev, k3_seq)
    sharded_launches, sharded_op, sharded_pv_out = timed("sharded_main_path", phase_sharded_main_path, torch, np, dev,
                                                         ref, main_iters, pv_main["ref32"], thick, herm_counts, chain,
                                                         bf16)
    seconds["sharded_pv"] = sharded_pv_out["seconds"]  # inside sharded_main_path's seconds
    seconds["sharded_engines"] = sharded_pv_out["engines_seconds"]  # the same
    seconds["grid_mesh"] = sharded_pv_out["grid_seconds"]  # the same
    seconds["bf16_sharded"] = sharded_pv_out["bf16_seconds"]  # the same
    seconds["multichip"] = sharded_pv_out["multichip_seconds"]  # the same
    sharded_eng = sharded_pv_out["engines"]
    k2 = timed("k2", phase_k2, torch, dev, sharded_op)
    del sharded_op
    bf16_sharded = sharded_pv_out["bf16"]
    k2bf16 = timed("k2bf16", phase_k2bf16, torch, dev, bf16_sharded.pop("op"), bf16.pop("op"))
    torch.cuda.empty_cache()
    timed("k1x", phase_k1x, torch, np, dev)
    timed("pv_thick", phase_pv_thick, torch, np, dev, 1)
    timed("pv_block_thick", phase_pv_thick, torch, np, dev, 3)
    torch.cuda.empty_cache()
    flagship = timed("block_thick_flagship", phase_block_thick_flagship, torch, np, dev, FLAGSHIP_N)
    torch.cuda.empty_cache()
    k5 = timed("k5", phase_k5, torch, np, dev)
    cheby_launches = timed("cheby_flagship", phase_cheby_flagship, torch, np, dev, CHEBY_N)
    timed("precise_filter", phase_precise_filter, torch, np, dev)
    timed("expm_precise", phase_expm_precise, torch, np, dev)
    torch.cuda.empty_cache()
    timed("pack_bsr", phase_pack_bsr, np)
    timed("samples", phase_samples)
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
    # (ms_per_call) beside the one-call ms.  K6's launches are the main
    # path's checks, its times phase k6's case at k = 128 with 5 roots
    # (float32); no single PyTorch call computes a Sturm multisection, so
    # its library time is null; its entry adds the dependent scan steps of
    # that case, the latency floor beside the operations bound.  K1x's
    # launches are the precise main path's (bsr_matvec_f32x64) and the
    # sharded precise main path's (its rsmk form), its times those of the
    # main path's tiles in each layout, with K1 (K2) on the same tiles and a
    # float32 x beside them (f32_kernel_ms); its library call is the BSR
    # tensor product over a float64 copy of the tiles.  K2's complex
    # instances count their launches in phase sharded_engines (complex64:
    # the complex main path over the one-rank sharded operator; complex64 x
    # complex128: its precise evolution; complex128: a complex128 run of the
    # Exponentiator), their times phase k2c's on the complex main path's
    # tiles in rsmk; K4's count theirs in phase block_hermitian (complex64:
    # the complex main path, block thick; complex128: the Hofstadter
    # lattice), their times phase k4c's at b = 3, k = 255 (with k = 24 and
    # 96 beside them).  The bfloat16 instances (K1, K2, K1x and K1x-rsmk over
    # bfloat16 tiles) count their launches in phase bf16_main_path (K1, and
    # K1x in its precise run) and in its one-rank sharded part (K2, and
    # K1x-rsmk in its precise run), their times phases k1bf16's and
    # k2bf16's on the main path's tiles in bfloat16, with the float32 twin
    # over the widened tiles beside them (f32_kernel_ms); their library
    # call is the BSR tensor product over a float32 (K1x: float64) copy of
    # the tiles.
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
        {**entry("sturm_check", "lanczos_tpu_torch/csrc/sturm_check.cu", K6_REPLACES, launches["k6"], k6),
         "ms_per_call": k6["ms_per_call"], "device_ms": k6["device_ms"], "dependent_steps": k6["dependent_steps"]},
        {**entry("bsr_matvec_f32x64", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1X_REPLACES, pv_main["launches"],
                 pv_main["k1x"]), "f32_kernel_ms": pv_main["k1x"]["f32_kernel_ms"]},
        {**entry("bsr_matvec_rsmk_f32x64", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1X_REPLACES,
                 sharded_pv_out["launches"], sharded_pv_out["k1x_rsmk"]),
         "f32_kernel_ms": sharded_pv_out["k1x_rsmk"]["f32_kernel_ms"]},
        {**entry("bsr_matvec_c64", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1_REPLACES,
                 herm_counts["k1_by_dtype"]["complex64"], k1c["complex64"]),
         "f32_kernel_ms": k1c["complex64"]["f32_kernel_ms"], "library_error": k1c["complex64"].get("library_error")},
        {**entry("bsr_matvec_c128", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1_REPLACES, facade["k1_c128"],
                 k1c["complex128"]),
         "f32_kernel_ms": k1c["complex128"]["f32_kernel_ms"], "library_error": k1c["complex128"].get("library_error")},
        {**entry("bsr_matvec_c64x128", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1X_REPLACES, facade["k1x_c64x128"],
                 k1c["complex64x128"]),
         "f32_kernel_ms": k1c["complex64x128"]["f32_kernel_ms"],
         "library_error": k1c["complex64x128"].get("library_error")},
        {**entry("cgs_pass_c64", "lanczos_tpu_torch/csrc/cgs.cu", K3_REPLACES, herm_counts["k3_by_dtype"]["complex64"],
                 k3c[torch.complex64]), "two_read_stream_ms": k3c[torch.complex64]["two_read_stream_ms"]},
        {**entry("cgs_pass_c128", "lanczos_tpu_torch/csrc/cgs.cu", K3_REPLACES, facade["k3_c128"],
                 k3c[torch.complex128]), "two_read_stream_ms": k3c[torch.complex128]["two_read_stream_ms"]},
        *({**entry(f"bsr_matvec_rsmk_{short}", "lanczos_tpu_torch/csrc/bsr_spmv.cu",
                   K2_REPLACES if short != "c64x128" else K1X_REPLACES, sharded_eng[f"k2_{short}"], k2c[name]),
           "stream_bound_ms": k2c[name]["stream_bound_ms"], "k1_same_tiles_ms": k2c[name].get("k1_same_tiles_ms"),
           "library_error": k2c[name].get("library_error")}
          for short, name in (("c64", "complex64"), ("c128", "complex128"), ("c64x128", "complex64x128"))),
        *({**entry(f"cgs_pass_block_{short}", "lanczos_tpu_torch/csrc/cgs_block.cu", K4_REPLACES,
                   block_herm[f"k4_{short}"], k4c[(dtype, 255)]),
           "two_read_stream_ms": k4c[(dtype, 255)]["two_read_stream_ms"],
           "ms_k24_k96": [k4c[(dtype, 24)]["ms"], k4c[(dtype, 96)]["ms"]]}
          for short, dtype in (("c64", torch.complex64), ("c128", torch.complex128))),
        *({**entry(name, "lanczos_tpu_torch/csrc/bsr_spmv.cu", replaces, n_launches, line),
           "f32_kernel_ms": line["f32_kernel_ms"], "stream_bound_ms": line["stream_bound_ms"]}
          for name, replaces, n_launches, line in (
              ("bsr_matvec_bf16", K1_REPLACES, bf16["k1_launches"], k1bf16[torch.float32]),
              ("bsr_matvec_rsmk_bf16", K2_REPLACES, bf16_sharded["k2_launches"], k2bf16[torch.float32]),
              ("bsr_matvec_bf16x64", K1X_REPLACES, bf16["k1x_launches"], k1bf16[torch.float64]),
              ("bsr_matvec_rsmk_bf16x64", K1X_REPLACES, bf16_sharded["k1x_rsmk_launches"], k2bf16[torch.float64]))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
