#!/usr/bin/env python3
"""Times kernels K3, K4, K5, E2a, E2b, E3 and E1's v2 forms of one checkout
of lanczos_tpu_torch on one NVIDIA GPU, so that two commits can be compared
on the same card: ``python3 chip_ab.py --root DIR [--flagships] [--bf16]
[--spmv-only]``.

DIR holds the checkout (``.`` for this one, or a parent commit unpacked by
``git archive`` into a git-ignored directory); its ``lanczos_tpu_torch``
and ``chip_smoke.py`` are imported from there.  Only calls both sides
share are used:

- ``cgs.cgs_pass`` (K3) one call at a time over ``chip_smoke.K3_SWEEP``
  (k from 1 to 256 on a (257, 2**20) float32 basis, k in (1, 16, 64, 256)
  on (257, 2**22)), each beside two ``torch.mv`` and the two-read stream;
  the main path's k sequence (:data:`K3_MAIN_PATH_KS`) replayed as one
  sum beside the sum of its two-read streams; and the host's microseconds
  per call at k = 1 on a (2, 4096) basis beside two ``torch.mv``;
- the main path's solve (n = 2**20, 176 iterations): its wall by host
  clock, then under ``torch.profiler`` K3's and K1's device time in it,
  its busy time and idle share; with ``--bf16`` the same over its tiles in
  bfloat16 and the precise solve over them (K1x's device time), and K1x
  and K1x-rsmk over those tiles beside K1 bfloat16, K1x on the widened
  tiles and a read of the tiles (checkouts whose port takes bfloat16
  tiles: older ones refuse them);
- ``cgs.cgs_pass_block`` at b = 3 on the block flagship's (258, 2**22)
  float32 buffer for k = 24, 96 and 255;
- the Chebyshev flagship's filter apply (n = 2**22 chain, degree 400)
  through ``ChebyshevFilterOperator.matvec`` with ``use_fused`` set;
- ``bcgs_kernel.bcgs_mgs_pass(v, basis, k, chunk)`` (E2a) on the study's
  (257, 2**22) float32 basis for k in (64, 128, 256) and chunk in (32,
  64), beside two ``torch.mv`` per chunk and the two-read stream (2 k n 4
  bytes over a same-process ``torch.sum`` read rate), and
  ``bcgs_kernel2.cgs_single_pass(v, basis, k)`` (E2b) on the same basis
  for the same k, beside two ``torch.mv`` and the same stream;
- ``spmv_bench.spmv_v2(blocks, col_blocks, x, vpu=...)`` (E1's VPU form
  and dot form) at the study's 64 Mi stored nnz in float32 (R = 512, S =
  8, 128 x 128 tiles), beside K2 (``spmv.bsr_matvec_rsmk``) and a
  ``torch.sum`` read of the tiles: one call, and per call over runs of 50;
- ``carry_copy_bench.row_set(buf, k, w)`` (E3) on a (256, 2**20) float32
  buffer: one call, and runs of 100 calls per call, by CUDA events beside
  ``index_copy_`` and ``copy_``;
  host microseconds per call by ``perf_counter`` over 10**4 calls, for the
  whole call and for each step of its launch path; and 64 calls captured
  in one ``torch.cuda.CUDAGraph`` with k a device word the graph advances,
  beside the same 64 calls of ``index_copy_`` and of ``copy_``
  (``chip_smoke.e3_graph`` of this tree, with its bit-for-bit checks).

``digests`` holds the SHA-256 of K3's (at (258, 2**22) k = 256, (257,
2**20) k = 128 and float64 (129, 70001) k = 129), K4's, E2b's, E2c's and
E1's three variants' outputs on fixed inputs, ``spmv_digests`` those of
every BSR matvec instance in both layouts; those of the kernels a change
leaves alone must not differ between the two sides, and every one must
repeat from run to run of one side.  Times are medians of
CUDA-event timings after a warm-up.  ``--flagships``
adds the checkout's own ``chip_smoke.py`` phases ``block_thick_flagship``
and ``cheby_flagship`` (their walls and checks).  Run the two sides in
turns (A, B, B, A) on the same card.  Prints one JSON line with the card's
name and power limit; needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

E3_CAP1, E3_N = 256, 2**20
# The k of every K3 launch of the main path's solve (chip_smoke.py phase
# main_path, n = 2**20 float32, 176 iterations): k = 1, 2, ..., 176, once
# each, as recorded on the parent of the K3 redesign, c29b668 (phase
# k3_path prints the histogram of every run).  A fixed sequence, so that
# both sides replay the same calls whatever their bits do to the solve.
K3_MAIN_PATH_KS = tuple(range(1, 177))

# The measurement helpers of this tree's chip_smoke.py (the side under test
# may be a parent without them), loaded by path so that ``import
# chip_smoke`` still finds the checkout's own.
_spec = importlib.util.spec_from_file_location("chip_smoke_helpers", Path(__file__).resolve().with_name("chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def digest(torch, t) -> str:
    import hashlib

    torch.cuda.synchronize()
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def digests(torch, cgs, dev) -> dict:
    """SHA-256 of K4 (b = 3, k = 255), E2b and E2c (k = 256) outputs on
    inputs drawn from a fixed seed at the study's (257, 2**22) size, and of
    E1's dot form, VPU form and v3 at its 64 Mi stored nnz."""
    from lanczos_tpu_torch.experiments import bcgs_kernel2, bcgs_kernel3, spmv_bench

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 2**22
    basis = torch.randn((258, n), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    vblk = torch.randn((3, n), generator=gen, device=dev)
    out = {"k4_b3_k255": digest(torch, cgs.cgs_pass_block(vblk.clone(), basis, 255)),
           "e2b_k256": digest(torch, bcgs_kernel2.cgs_single_pass(vblk[0].clone(), basis[:257], 256)),
           "k3_k256": digest(torch, cgs.cgs_pass(vblk[2].clone(), basis, 256))}
    shadow = bcgs_kernel3.make_shadow(basis[:257])
    out["e2c_k256"] = digest(torch, bcgs_kernel3.cgs_shadow_pass(vblk[1].clone(), shadow, basis[:257], 256))
    del basis, vblk, shadow
    blocks, blocks_t, cb, x = e1_operator(torch, dev, gen)
    out["e1_v2"] = digest(torch, spmv_bench.spmv_v2(blocks, cb, x, G=8))
    out["e1_v2_vpu"] = digest(torch, spmv_bench.spmv_v2(blocks, cb, x, G=8, vpu=True))
    out["e1_v3"] = digest(torch, spmv_bench.spmv_v3(blocks_t, cb, x, G=8))
    del blocks, blocks_t, cb, x
    # K3 at the main path's width and in float64, from a generator of its
    # own (the inputs above stay those of the earlier digests).
    gen = torch.Generator(device=dev).manual_seed(2)
    basis = torch.randn((257, 2**20), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    v = torch.randn(2**20, generator=gen, device=dev)
    out["k3_k128_n2p20"] = digest(torch, cgs.cgs_pass(v, basis, 128))
    basis = torch.randn((129, 70001), generator=gen, device=dev, dtype=torch.float64)
    v = torch.randn(70001, generator=gen, device=dev, dtype=torch.float64)
    out["k3_f64_k129_n70001"] = digest(torch, cgs.cgs_pass(v, basis, 129))
    return out


def spmv_digests(torch, dev) -> dict:
    """SHA-256 of every instance of ``csrc/bsr_spmv.cu`` in both layouts
    (K1 and K2 in float32, float64, complex64, complex128 and bfloat16
    tiles against a float32 x; K1x and K1x-rsmk in float32 x float64,
    complex64 x complex128 and bfloat16 x float64) on inputs drawn from a
    fixed seed: the main path's tile shape over 1024 row blocks and a
    scalar-loop shape (bk = 12)."""
    from lanczos_tpu_torch.ops import spmv

    gen = torch.Generator(device=dev).manual_seed(3)
    instances = (("f32", torch.float32, torch.float32), ("f64", torch.float64, torch.float64),
                 ("c64", torch.complex64, torch.complex64), ("c128", torch.complex128, torch.complex128),
                 ("bf16", torch.bfloat16, torch.float32), ("f32x64", torch.float32, torch.float64),
                 ("c64x128", torch.complex64, torch.complex128), ("bf16x64", torch.bfloat16, torch.float64))
    out = {}
    for label, (r, bm, s, bk) in {"main_tiles": (1024, 128, 3, 128), "bk12": (64, 12, 5, 12)}.items():
        re = torch.randn((r, bm, s, bk), generator=gen, device=dev)
        im = torch.randn((r, bm, s, bk), generator=gen, device=dev)
        cb = torch.randint(0, r * bm // bk, (r, s), generator=gen, device=dev, dtype=torch.int32)
        for name, tiles, xtype in instances:
            rmsk = torch.complex(re, im).to(tiles) if tiles.is_complex else re.to(tiles)
            x = torch.randn(r * bm, generator=gen, device=dev, dtype=xtype)
            out[f"k1_{name}_{label}"] = digest(torch, spmv.bsr_matvec(rmsk, cb, x))
            out[f"k2_{name}_{label}"] = digest(torch, spmv.bsr_matvec_rsmk(rmsk.permute(0, 2, 1, 3).contiguous(), cb, x))
        del re, im, cb, rmsk
        torch.cuda.empty_cache()
    return out


def time_bf16x64(torch, np, dev) -> dict:
    """K1x and K1x-rsmk over the main path's tiles in bfloat16 (phase
    bf16_main_path's operator, a float64 x) by CUDA events, beside K1
    bfloat16 (a float32 x), K1x float32 x float64 on the widened tiles and a
    ``torch.sum`` read of the bfloat16 tiles, each timed twice in turns."""
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import spmv

    rows, cols, vals = smoke._main_path_coo(np)
    op = tl.BSROperator.from_coo(rows, cols, vals, smoke.MAIN_N, bm=128, bk=128, dtype=torch.bfloat16, device=dev)
    blocks, cb, n = op.blocks, op.col_blocks, op.n
    rsmk = blocks.permute(0, 2, 1, 3).contiguous()
    wide = blocks.float()
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(op.n_padded, generator=gen, device=dev, dtype=torch.float64)
    x32 = x.float()
    calls = {"k1x_bf16x64": lambda: spmv.bsr_matvec(blocks, cb, x, n),
             "k1x_rsmk_bf16x64": lambda: spmv.bsr_matvec_rsmk(rsmk, cb, x, n, col_bound=op.n_padded // 128),
             "k1_bf16": lambda: spmv.bsr_matvec(blocks, cb, x32, n),
             "k1x_f32x64_widened": lambda: spmv.bsr_matvec(wide, cb, x, n),
             "bf16_tile_sum": lambda: torch.sum(blocks)}
    out = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            out[name].append(smoke.cuda_ms(torch, fn))
    out["tile_gb"] = blocks.numel() * 2 / 1e9
    out["plan_study"] = bf16x64_plan_study(torch, blocks, cb, x, n, calls["k1x_bf16x64"]())
    return out


def bf16x64_plan_study(torch, blocks, cb, x, n, want) -> dict | None:
    """K1x's bfloat16 body on ``blocks`` (rmsk) with other lanes a row and
    vectors a lane forced in place of ``spmv.bf16x64_plan``'s choice
    (``lt_bsr_spmv_bf16x64_forced``): each one's ms by CUDA events and its
    error against the wrapper's result ``want`` (another order of the same
    products), the plan's own choice bit for bit.  None for a checkout
    without the study entry (``lt_bsr_spmv_bf16x64_forced``)."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.ops import spmv

    lib = _build.library()
    if not hasattr(lib, "lt_bsr_spmv_bf16x64_forced"):
        return None
    r, bm, s, bk = blocks.shape
    plan = spmv.bf16x64_plan(bm, s, bk)
    out = {"plan": [plan["lanes_per_row"], plan["vectors_per_lane"]]}
    for lanes, vpl in ((16, 3), (32, 2), (32, 1), (8, 3), (8, 2), (4, 4)):

        def forced(lanes=lanes, vpl=vpl):
            y = torch.empty(n, dtype=torch.float64, device=x.device)
            _build.check(lib.lt_bsr_spmv_bf16x64_forced(
                blocks.data_ptr(), cb.data_ptr(), x.data_ptr(), y.data_ptr(), r, bm, s, bk, x.numel(), n, 0,
                lanes.bit_length() - 1, vpl, x.device.index, torch.cuda.current_stream(x.device).cuda_stream),
                "lt_bsr_spmv_bf16x64_forced")
            return y

        y = forced()
        out[f"{lanes}x{vpl}"] = {"ms": smoke.cuda_ms(torch, forced), "max_rel_err": smoke.rel_err(y, want)[1],
                                 "bitwise_as_wrapper": bool(torch.equal(y, want))}
    return out


def e1_operator(torch, dev, gen, r: int = 512):
    """E1's study operator on the card: (R, 8, 128, 128) float32 tiles of
    0.01 times standard normals, the same tiles as (R, 128, 8, 128), column
    blocks over the R row blocks, and x."""
    blocks = torch.randn((r, 8, 128, 128), generator=gen, device=dev) * 0.01
    cb = torch.randint(0, r, (r, 8), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn(r * 128, generator=gen, device=dev)
    return blocks, blocks.permute(0, 2, 1, 3).contiguous(), cb, x


def time_e1(torch, dev, gen) -> dict:
    """E1's VPU form at the study's size beside the dot form, K2 and the
    read stream of the tiles: ms of one call, and ms per call over runs of
    50 back-to-back calls (the single call also holds the host's enqueue);
    then the host's microseconds per call of each at a tiny operator."""
    from lanczos_tpu_torch.experiments import spmv_bench
    from lanczos_tpu_torch.ops import spmv

    blocks, _blocks_t, cb, x = e1_operator(torch, dev, gen)
    calls = {"vpu": lambda: spmv_bench.spmv_v2(blocks, cb, x, G=8, vpu=True),
             "dot": lambda: spmv_bench.spmv_v2(blocks, cb, x, G=8),
             "k2": lambda: spmv.bsr_matvec_rsmk(blocks, cb, x, col_bound=512),
             "stream": lambda: torch.sum(blocks)}
    out = {f"{name}_ms": smoke.cuda_ms(torch, fn) for name, fn in calls.items()}
    out.update({f"{name}_ms_per_call": smoke.cuda_ms_per_call(torch, fn, calls=50, reps=10)
                for name, fn in calls.items()})
    # The host's part of each call: host microseconds per call on (2, 1,
    # 16, 16) tiles, whose launches take a few µs of the card, so that the
    # loop measures the enqueue.
    blocks = torch.randn((2, 1, 16, 16), generator=gen, device=dev)
    cb = torch.tensor([[1], [0]], dtype=torch.int32, device=dev)
    x = torch.randn(32, generator=gen, device=dev)
    tiny = {"vpu": lambda: spmv_bench.spmv_v2(blocks, cb, x, G=8, vpu=True),
            "dot": lambda: spmv_bench.spmv_v2(blocks, cb, x, G=8),
            "k2": lambda: spmv.bsr_matvec_rsmk(blocks, cb, x, col_bound=2),
            "stream": lambda: torch.sum(blocks)}
    out["host_us_per_call_tiny"] = {name: smoke.host_us_per_call(torch, fn) for name, fn in tiny.items()}
    return out


def profile_solve(torch, eng, iters) -> dict:
    """The same solve again under ``torch.profiler`` (the same start
    vector, so the same iterations and K3 calls): its device span, busy
    time (the union of the device intervals) and idle share, and the device
    milliseconds of K3's three kernels and of K1.  A solve that takes
    another number of iterations fails the run."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    if sum(eng.iteration_counts) != iters:
        raise AssertionError(f"the profiled solve took {eng.iteration_counts} iterations, not {iters}")
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not spans:
        raise AssertionError("the profiler recorded no device activity in the main path's solve")
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]

    def device_ms(*names):
        return sum(e.time_range.end - e.time_range.start for e in device if any(m in e.name for m in names)) / 1e3

    by_name = {}
    for e in device:
        rec = by_name.setdefault(e.name[:60], [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3
        rec[1] += 1
    return {"device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / span,
            "k3_device_ms": device_ms("cgs_project_kernel", "reduce_rows_kernel", "cgs_update_kernel"),
            "k1_device_ms": device_ms("bsr_spmv"), "device_events": len(device),
            "top_device_ms": sorted(([name, ms, count] for name, (ms, count) in by_name.items()),
                                    key=lambda r: -r[1])[:6]}


def main_path_profile(torch, np, dev, tiles=None, precise=False) -> dict:
    """The main path's solve (``chip_smoke.py`` phase main_path's problem
    and engine) run once, then again under ``torch.profiler``
    (:func:`profile_solve`): the warm solve's wall by host clock, K3's and
    K1's device milliseconds in the solve (K1x's in a precise solve), its
    device busy time and idle share.  ``tiles=torch.bfloat16`` packs the
    tiles in bfloat16 (phase bf16_main_path's operator; float32 vectors);
    ``precise`` runs ``precise_vectors`` at eps 1e-12, as phase
    bf16_main_path's precise run does."""
    import lanczos_tpu_torch as tl

    rows, cols, vals = smoke._main_path_coo(np)
    op = tl.BSROperator.from_coo(rows, cols, vals, smoke.MAIN_N, bm=128, bk=128, dtype=tiles or torch.float32,
                                 device=dev)
    eng = smoke._main_path_engine(tl, torch, op, *([torch.float32] if tiles is not None else []))
    if precise:
        eng.precise_vectors = True
        eng.eps = 1e-12
    eng.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = profile_solve(torch, eng, sum(eng.iteration_counts))
    out["iterations"] = sum(eng.iteration_counts)
    out["solve_wall_s"] = wall  # the warm solve before the profiled one, by host clock
    return out


def time_k3(torch, cgs, dev, gen) -> dict:
    """K3 one call at a time over ``chip_smoke.K3_SWEEP``, back to back and
    with L2 flushed before each call, beside two ``torch.mv`` and the
    two-read stream (2 k n 4 bytes over a same-process ``torch.sum`` read
    rate of the basis); the main path's k sequence
    (:data:`K3_MAIN_PATH_KS`) replayed on the (257, 2**20) basis as one
    sum, back to back and cold (``chip_smoke.k3_replay``), beside the sum
    of its two-read streams; and the host's microseconds per call on a
    (2, 4096) basis at k = 1, beside two ``torch.mv``."""
    ks = K3_MAIN_PATH_KS
    out = {"main_path_launches": len(ks), "main_path_k_sum": sum(ks)}
    flush = smoke.l2_flusher(torch, dev)
    for n, sweep in smoke.K3_SWEEP.items():
        basis = torch.randn((257, n), generator=gen, device=dev)
        basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
        v = torch.randn(n, generator=gen, device=dev)
        stream_gbps = 257 * n * 4 / smoke.cuda_ms(torch, lambda: torch.sum(basis)) / 1e6
        work = v.clone()
        if n == smoke.MAIN_N:
            times = smoke.k3_replay(torch, cgs, ks, basis, work, flush)
            out["replay_ms"], out["replay_cold_ms"] = times["ms"], times["cold_ms"]
            out["replay_two_read_stream_ms"] = 2 * sum(ks) * n * 4 / stream_gbps / 1e6
        for k in sweep:
            rows = basis[:k]
            out[f"{n}_k{k}"] = {
                "ms": smoke.cuda_ms(torch, lambda k=k: cgs.cgs_pass(work, basis, k)),
                "cold_ms": smoke.cuda_ms_cold(torch, lambda k=k: cgs.cgs_pass(work, basis, k), flush),
                "library_ms": smoke.cuda_ms(torch, lambda rows=rows: v - torch.mv(rows.T, torch.mv(rows, v))),
                "two_read_stream_ms": 2 * k * n * 4 / stream_gbps / 1e6,
            }
        del basis, v, work
        torch.cuda.empty_cache()
    del flush
    basis = torch.randn((2, 4096), generator=gen, device=dev)
    v = torch.randn(4096, generator=gen, device=dev)
    row = basis[:1]
    out["host_us_per_call_k1_n4096"] = {
        "k3": smoke.host_us_per_call(torch, lambda: cgs.cgs_pass(v, basis, 1)),
        "two_mv": smoke.host_us_per_call(torch, lambda: v - torch.mv(row.T, torch.mv(row, v))),
    }
    return out


def time_k4(torch, cgs, dev, gen) -> dict:
    n = 2**22
    basis = torch.randn((258, n), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    vblk = torch.randn((3, n), generator=gen, device=dev)
    out = {}
    for k in (24, 96, 255):
        work = vblk.clone()
        out[str(k)] = smoke.cuda_ms(torch, lambda: cgs.cgs_pass_block(work, basis, k))
    return out


def time_k5(torch, np, tl, dev, gen) -> float:
    from lanczos_tpu_torch.ops.filters import ChebyshevFilterOperator

    n = 2**22
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    fused = ChebyshevFilterOperator.from_interval(op, 400, -2.0, 2.0, 1e-5)
    fused.use_fused = True
    x = torch.randn(n, generator=gen, device=dev)
    return smoke.cuda_ms(torch, lambda: fused.matvec(x))


def time_e2(torch, dev, gen) -> tuple[dict, dict]:
    """E2a and E2b at the study's size: ms per pass by (chunk, k) and by k,
    the library sequence and the two-read stream bound of each."""
    from lanczos_tpu_torch.experiments import bcgs_kernel, bcgs_kernel2

    n = 2**22
    basis = torch.randn((257, n), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    v = torch.randn(n, generator=gen, device=dev)
    stream_gbps = 257 * n * 4 / smoke.cuda_ms(torch, lambda: torch.sum(basis)) / 1e6
    out = {"stream_gbps": stream_gbps}
    work = v.clone()
    for chunk in (32, 64):
        for k in (64, 128, 256):

            def two_mv_per_chunk(k=k, chunk=chunk):
                w = v
                for c0 in range(0, k, chunk):
                    r = basis[c0 : min(c0 + chunk, k)]
                    w = w - torch.mv(r.T, torch.mv(r, w))
                return w

            out[f"chunk{chunk}_k{k}"] = {
                "ms": smoke.cuda_ms(torch, lambda k=k, chunk=chunk: bcgs_kernel.bcgs_mgs_pass(work, basis, k, chunk)),
                "library_ms": smoke.cuda_ms(torch, two_mv_per_chunk),
                "two_read_stream_ms": 2 * k * n * 4 / stream_gbps / 1e6,
            }
    e2b = {"stream_gbps": stream_gbps}
    for k in (64, 128, 256):
        rows = basis[:k]
        e2b[f"k{k}"] = {
            "ms": smoke.cuda_ms(torch, lambda k=k: bcgs_kernel2.cgs_single_pass(work, basis, k)),
            "library_ms": smoke.cuda_ms(torch, lambda rows=rows: v - torch.mv(rows.T, torch.mv(rows, v))),
            "two_read_stream_ms": 2 * k * n * 4 / stream_gbps / 1e6,
        }
    # At k = 256, each also per call over runs of 5 back-to-back calls, with
    # E2a at chunk 64 and the stream beside them: a single call also holds
    # the host's part of the launch.
    rows = basis[:256]
    per_call = {"e2b": lambda: bcgs_kernel2.cgs_single_pass(work, basis, 256),
                "e2a_chunk64": lambda: bcgs_kernel.bcgs_mgs_pass(work, basis, 256, 64),
                "two_mv": lambda: v - torch.mv(rows.T, torch.mv(rows, v)),
                "two_read_stream": lambda: (torch.sum(rows), torch.sum(rows))}
    e2b["k256_ms_per_call_of_5"] = {name: smoke.cuda_ms_per_call(torch, fn, calls=5, reps=10)
                                    for name, fn in per_call.items()}
    return out, e2b


def time_e3(torch, dev, gen) -> dict:
    """E3 eager (events and host clock, with the launch path's steps) and
    in a captured CUDA graph."""
    from lanczos_tpu_torch import _build
    from lanczos_tpu_torch.experiments import carry_copy_bench as cc

    cap1, n = E3_CAP1, E3_N
    buf = torch.randn((cap1, n), generator=gen, device=dev)
    w = torch.randn(n, generator=gen, device=dev)
    kt = torch.tensor([cap1 // 2], dtype=torch.int32, device=dev)
    klong = kt.long()
    probe = torch.empty(n, device=dev)
    calls = {"row_set": lambda: cc.row_set(buf, kt, w), "index_copy_": lambda: buf.index_copy_(0, klong, w[None]),
             "copy_": lambda: probe.copy_(w)}
    out = {"events_ms": {name: smoke.cuda_ms(torch, fn) for name, fn in calls.items()},
           "events_ms_per_call_of_100": {name: smoke.cuda_ms_per_call(torch, fn) for name, fn in calls.items()}}

    # The steps of the launch path as it stood before its redesign (the
    # checks, the library lookup, a Stream object, three data_ptr, the
    # foreign call that sets the device and launches, the error check), each
    # alone, and the whole call; the raw stream handle and the two library
    # calls beside them.
    lib = _build.library()
    fn = lib.lt_row_set_f32
    idx = dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (buf.data_ptr(), kt.data_ptr(), w.data_ptr())

    def checks():
        if w.shape != (n,) or kt.shape != (1,) or kt.dtype != torch.int32:
            raise AssertionError
        if not (buf.device == w.device == kt.device):
            raise AssertionError
        if buf.device.type == "cpu" or buf.device.type != "cuda":
            raise AssertionError
        if buf.dtype not in (torch.float32, torch.float64) or w.dtype != buf.dtype:
            raise AssertionError
        if not (buf.is_contiguous() and w.is_contiguous()):
            raise AssertionError

    steps = {
        "call": lambda: cc.row_set(buf, kt, w),
        "checks": checks,
        "library": _build.library,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "data_ptr_x3": lambda: (buf.data_ptr(), kt.data_ptr(), w.data_ptr()),
        "foreign_call": lambda: fn(ptrs[0], ptrs[1], ptrs[2], cap1, n, idx, stream),
        "error_check": lambda: _build.check(0, "row_set (E3)"),
        "index_copy_": lambda: buf.index_copy_(0, klong, w[None]),
        "copy_": lambda: probe.copy_(w),
        "empty": lambda: None,
    }
    out["host_us"] = {name: smoke.host_us_per_call(torch, f) for name, f in steps.items()}
    del buf, w, probe
    torch.cuda.empty_cache()
    out["graph"] = smoke.e3_graph(torch, dev, cc, gen, cap1, n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose lanczos_tpu_torch is timed")
    ap.add_argument("--flagships", action="store_true", help="also run its chip_smoke.py flagship phases")
    ap.add_argument("--bf16", action="store_true",
                    help="also profile the main path's solve over bfloat16 tiles (a checkout whose port takes them)")
    ap.add_argument("--spmv-only", action="store_true",
                    help="only the BSR matvec digests and, with --bf16, the bfloat16 parts")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.ops import cgs

    if Path(tl.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tl.__file__}, not the checkout at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root), "nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    if not args.spmv_only:
        out["digests"] = digests(torch, cgs, dev)
        torch.cuda.empty_cache()
        out["k3"] = time_k3(torch, cgs, dev, gen)
        torch.cuda.empty_cache()
        out["main_path_profiled"] = main_path_profile(torch, np, dev)
        torch.cuda.empty_cache()
    out["spmv_digests"] = spmv_digests(torch, dev)
    torch.cuda.empty_cache()
    if args.bf16:
        out["bf16_main_path_profiled"] = main_path_profile(torch, np, dev, torch.bfloat16)
        torch.cuda.empty_cache()
        out["bf16_precise_profiled"] = main_path_profile(torch, np, dev, torch.bfloat16, precise=True)
        torch.cuda.empty_cache()
        out["bf16x64_ms"] = time_bf16x64(torch, np, dev)
        torch.cuda.empty_cache()
    if args.spmv_only:
        print(json.dumps(out), flush=True)
        return 0
    out["k4_b3_ms_by_k"] = time_k4(torch, cgs, dev, gen)
    torch.cuda.empty_cache()
    out["k5_ms_per_apply"] = time_k5(torch, np, tl, dev, gen)
    torch.cuda.empty_cache()
    out["e2a"], out["e2b"] = time_e2(torch, dev, gen)
    torch.cuda.empty_cache()
    out["e1"] = time_e1(torch, dev, gen)
    torch.cuda.empty_cache()
    out["e3"] = time_e3(torch, dev, gen)
    torch.cuda.empty_cache()
    if args.flagships:
        import chip_smoke

        if Path(chip_smoke.__file__).resolve().parent != root:
            raise RuntimeError(f"imported {chip_smoke.__file__}, not the checkout's")
        block = chip_smoke.phase_block_thick_flagship(torch, np, dev, 2**22)
        torch.cuda.empty_cache()
        chip_smoke.phase_cheby_flagship(torch, np, dev, 2**22)
        out["block_flagship_k4_launches"] = block["k4"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
