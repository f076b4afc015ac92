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
once with the default unfused chain.  The launch counts are set to 0 just
before each path and read just after it.
Every phase prints one JSON line; any failure raises, so the script exits
non-zero and prints no result.  The last two lines are the kernel table and
the device line.  It needs a CUDA device and fails at once without one; it
imports no JAX.
"""

from __future__ import annotations

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
SEED = 0
MAIN_N = 2**20  # main-path problem size
K3_N = 2**22  # width of the (257, n) basis in the K3 phase
K4_N = 2**22  # width of the (258, n) basis in the K4 phase (the flagship's buffer)
FLAGSHIP_N = 2**22  # the block flagship's chain (experiments/tpu_flagship_block.py)
CHEBY_N = 2**22  # the Chebyshev flagship's chain (experiments/tpu_flagship_cheby.py)
CHEBY_DEGREE = 400
K5_TOL = 1e-5  # max-abs error over max |plain| at degree <= 129 (tests/test_filtered.py:160-161)
K5_FLAGSHIP_TOL = 1e-4  # the same at the flagship's degree 400
BENCH_R = 512  # row blocks of the 64 Mi-nnz K1 and K2 cases (bm = bk = 128, S = 8)
K2_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-12}  # relative to max |plain|
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


def phase_k4(torch, dev):
    """K4 against its plain version on the flagship's (258, 2**22) f32
    buffer and on a ragged f64 basis; then its time at b = 3, k = 255."""
    from lanczos_tpu_torch.ops import cgs

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = K4_N
    basis = _random_basis(torch, dev, 258, n, torch.float32, gen)
    for b in (1, 2, 3, 4, 8):
        vblk = torch.randn((b, n), generator=gen, device=dev, dtype=torch.float32)
        for k in (1, 3, 129, 255, 258):
            check_k4(torch, basis, vblk, k, 1e-5)

    b, k = 3, 255
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
                 bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "k4_timing", **{key: val for key, val in timed.items() if key != "phase"}})
    del basis, vblk, work, rows

    basis = _random_basis(torch, dev, 129, 70001, torch.float64, gen)
    vblk = torch.randn((3, 70001), generator=gen, device=dev, dtype=torch.float64)
    for k in (1, 64, 129):
        check_k4(torch, basis, vblk, k, 1e-12)
    del basis, vblk
    torch.cuda.empty_cache()
    return timed


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
    t0 = time.perf_counter()
    evals, evecs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": spmv.bsr_matvec.launches, "k3": cgs.cgs_pass.launches}
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"main path did not launch both kernels: {launches}")
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
    return launches, k1, k3, op, ref, eng.iteration_counts


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


def phase_k5(torch, np, dev):
    """K5 against its plain version on a ragged n for three offset sets and
    the degrees around one launch's steps; then the Chebyshev flagship's
    filter apply (n = 2**22 chain, degree 400, window of
    from_interval(op, 400, -2, 2, 1e-5)), timed beside the plain version and
    the default unfused chain."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cheby
    from lanczos_tpu_torch.ops.filters import ChebyshevFilterOperator

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = 70001
    for offsets in ((-1, 1), (-1, 0, 1), (-8, -3, 0, 5, 8)):
        # Rows in [-1.8/k, 1.8/k] keep the spectrum inside the [-1.95, 2.15]
        # window, so the chain does not grow and the relative bar is tight.
        data = (torch.rand((len(offsets), n), generator=gen, device=dev) * 2 - 1) * (1.8 / len(offsets))
        x = torch.randn(n, generator=gen, device=dev)
        s = cheby.steps_per_launch(max(abs(o) for o in offsets))
        errs = {d: check_k5(torch, data, offsets, x, 0.1, 2.05, d, K5_TOL)[1] for d in (1, 2, s - 1, s, s + 1, 37)}
        emit({"phase": "k5", "n": n, "offsets": list(offsets), "steps_per_launch": s,
              "max_rel_err_by_degree": {str(d): r for d, r in errs.items()}, "tol": K5_TOL})
        del data, x

    n, degree = CHEBY_N, CHEBY_DEGREE
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    fused = ChebyshevFilterOperator.from_interval(op, degree, -2.0, 2.0, 1e-5)
    fused.use_fused = True
    unfused = ChebyshevFilterOperator.from_interval(op, degree, -2.0, 2.0, 1e-5)
    x = torch.randn(n, generator=gen, device=dev)
    err, rel = check_k5(torch, op.data, op.offsets, x, fused.c, fused.e, degree, K5_FLAGSHIP_TOL)
    plain = cheby.cheby_chain_apply_reference(op.data, op.offsets, x, fused.c, fused.e, degree)
    unfused_err, unfused_rel = rel_err(unfused.matvec(x), plain)
    ms = cuda_ms(torch, lambda: fused.matvec(x))
    plain_ms = cuda_ms(torch, lambda: cheby.cheby_chain_apply_reference(op.data, op.offsets, x, fused.c, fused.e, degree),
                       reps=5, warmup=1)
    unfused_ms = cuda_ms(torch, lambda: unfused.matvec(x), reps=5, warmup=1)
    rows, offs = fused._prescaled
    ndiag = len(offs)
    s, h, l = cheby.plan(n, ndiag, max(abs(o) for o in offs))
    n_launch = -(-degree // s)
    window_cells = -(-n // l) * (l + 2 * h)
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
           "steps_per_launch": s, "halo": h, "core": l, "launches_per_apply": n_launch, "max_abs_err": err,
           "max_rel_err": rel, "tol": K5_FLAGSHIP_TOL, "unfused_max_rel_err_vs_plain": unfused_rel, "ms": ms,
           "plain_ms": plain_ms, "unfused_ms": unfused_ms, "library_ms": None, "kernel_gb": kernel_bytes / 1e9,
           "stream_gbps": stream_gbps, "stream_bound_ms": kernel_bytes / stream_gbps / 1e6,
           "bound_ms": bound_ms, "bound_by": bound_by, "gflop": 2 * ndiag * n * degree / 1e9}
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
        cgs.cgs_pass.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vals, vecs, info = tl.filtered_lanczos(op, num_eigs=3, degree=CHEBY_DEGREE, mu=1e-5, lo=-2.0, hi=2.0,
                                                   configure=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k5": cheby.cheby_chain_apply.launches, "k3": cgs.cgs_pass.launches}
        errs = np.abs(np.sort(np.asarray(vals)) - exact)
        residuals = info["residuals"]
        label = "fused" if use_fused else "unfused"
        if use_fused and not (launches["k5"] > 0 and launches["k3"] > 0):
            raise AssertionError(f"Chebyshev flagship did not launch K5 and K3: {launches}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the GPU and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_environment(torch)
    phase_build()
    phase_k1(torch, dev)
    phase_k3(torch, dev)
    k4 = phase_k4(torch, dev)
    phase_small_solves(torch, np, dev)
    launches, k1, k3, op, ref, main_iters = phase_main_path(torch, np, dev)
    phase_thick_scalar(torch, np, op, ref)
    del op
    torch.cuda.empty_cache()
    sharded_launches, sharded_op = phase_sharded_main_path(torch, np, dev, ref, main_iters)
    k2 = phase_k2(torch, dev, sharded_op)
    del sharded_op
    torch.cuda.empty_cache()
    flagship = phase_block_thick_flagship(torch, np, dev, FLAGSHIP_N)
    torch.cuda.empty_cache()
    k5 = phase_k5(torch, np, dev)
    cheby_launches = phase_cheby_flagship(torch, np, dev, CHEBY_N)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    def entry(name, source, replaces, n_launches, timed):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n_launches,
                "max_abs_err": timed["max_abs_err"], "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                "library_ms": timed["library_ms"], "lib_ms": timed["library_ms"]}  # lib_ms: the same, short name

    # launches: K1 and K3 from the main path's run, K2 from the sharded main
    # path's, K4 from the block flagship's and K5 from the Chebyshev
    # flagship's fused run (the paths that run them).  No single PyTorch
    # call computes a Chebyshev chain, so K5's library time is null; its
    # k5_timing line has the unfused chain's.
    emit({"kernels": [
        entry("bsr_matvec", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K1_REPLACES, launches["k1"], k1),
        entry("bsr_matvec_rsmk", "lanczos_tpu_torch/csrc/bsr_spmv.cu", K2_REPLACES, sharded_launches["k2"], k2),
        entry("cgs_pass", "lanczos_tpu_torch/csrc/cgs.cu", K3_REPLACES, launches["k3"], k3),
        entry("cgs_pass_block", "lanczos_tpu_torch/csrc/cgs_block.cu", K4_REPLACES, flagship["k4"], k4),
        entry("cheby_chain_apply", "lanczos_tpu_torch/csrc/cheby_chain.cu", K5_REPLACES, cheby_launches["k5"], k5),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
