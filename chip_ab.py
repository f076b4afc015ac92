#!/usr/bin/env python3
"""Times kernels K4 and K5 of one checkout of lanczos_tpu_torch on one
NVIDIA GPU, so that two commits can be compared on the same card:
``python3 chip_ab.py --root DIR [--flagships]``.

DIR holds the checkout (``.`` for this one, or a parent commit unpacked by
``git archive`` into a git-ignored directory); its ``lanczos_tpu_torch``
and ``chip_smoke.py`` are imported from there.  Only calls both sides
share are used: ``cgs.cgs_pass_block`` at b = 3 on the block flagship's
(258, 2**22) float32 buffer for k = 24, 96 and 255, and the Chebyshev
flagship's filter apply (n = 2**22 chain, degree 400) through
``ChebyshevFilterOperator.matvec`` with ``use_fused`` set.  Times are
medians of CUDA-event timings after a warm-up.  ``--flagships`` adds the
checkout's own ``chip_smoke.py`` phases ``block_thick_flagship`` and
``cheby_flagship`` (their walls and checks).  Run the two sides in turns
(A, B, B, A) on the same card.  Prints one JSON line
with the card's name and power limit; needs a CUDA device and imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


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
    from lanczos_tpu_torch.ops.filters import ChebyshevFilterOperator

    if Path(tl.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tl.__file__}, not the checkout at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n = 2**22
    gen = torch.Generator(device=dev).manual_seed(0)
    basis = torch.randn((258, n), generator=gen, device=dev)
    basis /= torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    vblk = torch.randn((3, n), generator=gen, device=dev)
    k4_ms = {}
    for k in (24, 96, 255):
        work = vblk.clone()
        k4_ms[str(k)] = cuda_ms(torch, lambda: cgs.cgs_pass_block(work, basis, k))
    del basis, vblk, work
    torch.cuda.empty_cache()

    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device=dev)
    fused = ChebyshevFilterOperator.from_interval(op, 400, -2.0, 2.0, 1e-5)
    fused.use_fused = True
    x = torch.randn(n, generator=gen, device=dev)
    k5_ms = cuda_ms(torch, lambda: fused.matvec(x))
    del op, fused, x
    torch.cuda.empty_cache()

    out = {"root": str(root), "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "k4_b3_ms_by_k": k4_ms, "k5_ms_per_apply": k5_ms}
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
