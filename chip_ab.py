#!/usr/bin/env python3
"""Times kernels K4, K5, E2a and E3 of one checkout of lanczos_tpu_torch on
one NVIDIA GPU, so that two commits can be compared on the same card:
``python3 chip_ab.py --root DIR [--flagships]``.

DIR holds the checkout (``.`` for this one, or a parent commit unpacked by
``git archive`` into a git-ignored directory); its ``lanczos_tpu_torch``
and ``chip_smoke.py`` are imported from there.  Only calls both sides
share are used:

- ``cgs.cgs_pass_block`` at b = 3 on the block flagship's (258, 2**22)
  float32 buffer for k = 24, 96 and 255;
- the Chebyshev flagship's filter apply (n = 2**22 chain, degree 400)
  through ``ChebyshevFilterOperator.matvec`` with ``use_fused`` set;
- ``bcgs_kernel.bcgs_mgs_pass(v, basis, k, chunk)`` (E2a) on the study's
  (257, 2**22) float32 basis for k in (64, 128, 256) and chunk in (32,
  64), beside two ``torch.mv`` per chunk and the two-read stream (2 k n 4
  bytes over a same-process ``torch.sum`` read rate);
- ``carry_copy_bench.row_set(buf, k, w)`` (E3) on a (256, 2**20) float32
  buffer: one call, and runs of 100 calls per call, by CUDA events beside
  ``index_copy_`` and ``copy_``;
  host microseconds per call by ``perf_counter`` over 10**4 calls, for the
  whole call and for each step of its launch path; and 64 calls captured
  in one ``torch.cuda.CUDAGraph`` with k a device word the graph advances,
  beside the same 64 calls of ``index_copy_`` and of ``copy_``
  (``chip_smoke.e3_graph`` of this tree, with its bit-for-bit checks).

``digests`` holds the SHA-256 of K4's, E2b's and E2c's outputs on fixed
inputs, which must not differ between the two sides.  Times are medians of
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
from pathlib import Path

E3_CAP1, E3_N = 256, 2**20

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
    inputs drawn from a fixed seed at the study's (257, 2**22) size."""
    from lanczos_tpu_torch.experiments import bcgs_kernel2, bcgs_kernel3

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 2**22
    basis = torch.randn((258, n), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    vblk = torch.randn((3, n), generator=gen, device=dev)
    out = {"k4_b3_k255": digest(torch, cgs.cgs_pass_block(vblk.clone(), basis, 255)),
           "e2b_k256": digest(torch, bcgs_kernel2.cgs_single_pass(vblk[0].clone(), basis[:257], 256))}
    shadow = bcgs_kernel3.make_shadow(basis[:257])
    out["e2c_k256"] = digest(torch, bcgs_kernel3.cgs_shadow_pass(vblk[1].clone(), shadow, basis[:257], 256))
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


def time_e2a(torch, dev, gen) -> dict:
    """E2a at the study's size: ms per pass by (chunk, k), the library
    sequence and the two-read stream bound of each."""
    from lanczos_tpu_torch.experiments import bcgs_kernel

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
    return out


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
    out["digests"] = digests(torch, cgs, dev)
    torch.cuda.empty_cache()
    out["k4_b3_ms_by_k"] = time_k4(torch, cgs, dev, gen)
    torch.cuda.empty_cache()
    out["k5_ms_per_apply"] = time_k5(torch, np, tl, dev, gen)
    torch.cuda.empty_cache()
    out["e2a"] = time_e2a(torch, dev, gen)
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
