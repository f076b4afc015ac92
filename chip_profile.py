#!/usr/bin/env python3
"""Where a block thick-restart step's time goes on one NVIDIA GPU:
``python3 chip_profile.py``.

Runs one full cycle (85 block steps, the 256-row buffer of width-3 blocks)
of the block flagship's build — the float32 DIA chain at n = 2**22 of
``chip_smoke.py``'s ``block_thick_flagship`` phase, with float64 coefficient
dots — once to warm up and once under ``torch.profiler``.  Prints one JSON
line: the card's name and power limit, the cycle's wall time per step, the
device's busy and idle shares, and the device time by kernel name.  It needs
a CUDA device and imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N = 2**22
B = 3
CAP_B = 256 // B


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py: no CUDA device", file=sys.stderr)
        return 2
    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.solvers import block_lanczos, block_thick

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    op = tl.DIAOperator.from_diagonals([-1, 1], [np.full(N, -1.0, np.float32)] * 2, N, device=dev)
    v0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (B, N)).astype(np.float32), device=dev)
    defl = torch.zeros((0, N), device=dev)
    mask = torch.ones(0, device=dev)
    u0, _ = block_lanczos._orthonormalize_block(v0, defl, mask, torch.zeros((B, N), device=dev), 0)
    st = block_thick._BlockState(u0, CAP_B, True, np.float64)

    def cycle():
        st.reset(u0)
        block_thick._fused_block_stage(op, st, defl, mask, -4.0, CAP_B, 1, True)
        torch.cuda.synchronize()

    cycle()  # warm-up: kernel build, allocator, cuBLAS handles
    t0 = time.perf_counter()
    cycle()
    wall_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cycle()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    # Busy time: the union of the device intervals (kernels and copies).
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict[str, list[float]] = {}
    for e in events:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "n": N, "block_size": B, "steps": CAP_B,
        "wall_s_unprofiled": wall_s, "ms_per_step_unprofiled": wall_s / CAP_B * 1e3,
        "device_span_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share_of_span": busy / (end - start), "device_launches": len(events),
        "launches_per_step": len(events) / CAP_B,
        "device_ms_by_kernel": [{"name": k[:90], "ms": v[0] / 1e3, "count": v[1]} for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
