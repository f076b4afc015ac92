#!/usr/bin/env python3
"""Smoke test of lanczos_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from ``lanczos_tpu_torch/csrc``, holds each
against its plain PyTorch version, and drives the main path —
``LambdaLanczos.run`` -> deflation driver -> fused engine over a
``BSROperator`` — at n = 2**20.  Every phase prints one JSON line; any
failure raises, so the script exits non-zero and prints no result.  The last
two lines are the kernel table and the device line.  It needs a CUDA device
and fails at once without one; it imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

K1_REPLACES = "lanczos_tpu/ops/pallas_spmv.py:195"
K3_REPLACES = "lanczos_tpu/ops/pallas_cgs.py:212"
SEED = 0
MAIN_N = 2**20  # main-path problem size
K3_N = 2**22  # width of the (257, n) basis in the K3 phase
BENCH_R = 512  # row blocks of the 64 Mi-nnz K1 case (bm = bk = 128, S = 8)


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


def check_k1(torch, blocks, col_blocks, x, n, tol, label, timing=False):
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
        out.update(ms=ms, plain_ms=plain_ms, gbps=bytes_moved / ms / 1e6, plain_gbps=bytes_moved / plain_ms / 1e6,
                   stream_gbps=blocks.numel() * item / stream_ms / 1e6)
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
        ms = cuda_ms(torch, lambda: cgs.cgs_pass(work, basis, k))
        plain_ms = cuda_ms(torch, lambda: cgs.cgs_pass_reference(v, basis, k))
        bytes_moved = 2 * k * basis.shape[1] * basis.element_size()
        out.update(ms=ms, plain_ms=plain_ms, gbps=bytes_moved / ms / 1e6, plain_gbps=bytes_moved / plain_ms / 1e6)
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
    rng = np.random.default_rng(SEED)
    pot = rng.uniform(0.0, 1.0, n)
    pot[[n // 4, n // 2, 3 * n // 4]] = [-4.0, -3.5, -3.0]
    rows, cols, vals = _chain_coo(np, n, pot)
    t0 = time.perf_counter()
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=128, bk=128, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    eng = tl.LambdaLanczos(op, num_eigs=3, find_maximum=False)
    eng.eps = 1e-6
    eng.init_vector = tl.fixed_seed_initializer(torch.float32, seed=SEED)  # same start every run
    # The three bound states are checked independently below (scipy and
    # residuals), so the confirming deflation round — which would resolve
    # the gap-less band edge to eps — is skipped.
    eng.stop_when_full = True
    mode = eng._resolve_mode()
    if mode != "fused":
        raise AssertionError(f"mode='auto' resolved to {mode} on {dev}")

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
    k1 = check_k1(torch, op.blocks, op.col_blocks, x, n, 1e-5, "main_path", timing=True)
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
    return launches, k1, k3


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
    phase_small_solves(torch, np, dev)
    launches, k1, k3 = phase_main_path(torch, np, dev)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": "bsr_matvec", "route": "cuda", "source": "lanczos_tpu_torch/csrc/bsr_spmv.cu",
         "replaces": K1_REPLACES, "launches": launches["k1"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "cgs_pass", "route": "cuda", "source": "lanczos_tpu_torch/csrc/cgs.cu",
         "replaces": K3_REPLACES, "launches": launches["k3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
