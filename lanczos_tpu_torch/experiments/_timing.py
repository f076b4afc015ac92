"""The marginal timing method of the kernel studies, on CUDA events.

The JAX studies time a chain of ``short`` and of ``long`` iterations and
take ``(t_long - t_short) / (long - short)``, the median over repeats
(``experiments/pallas_bcgs_kernel.py:91-99``), so that fixed costs per
call cancel.  Here each chain is enqueued on the current CUDA stream
between two events, and the time is the events' elapsed time, not the
host's clock around a sync.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["cuda_device", "resolve_device", "marginal"]


def cuda_device(device="cuda") -> torch.device:
    """``device`` as a CUDA ``torch.device``; raises for any other device
    and when PyTorch sees no card (a timing has no CPU mode)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the kernel studies time the CUDA card, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel studies time the card")
    return device


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` for a correctness check, which runs
    on the CPU too; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        cuda_device(device)
    return device


def marginal(run, short: int, long: int, repeats: int = 5, device="cuda") -> float:
    """Seconds per iteration of ``run(r)``, which enqueues ``r`` iterations
    on the current stream of ``device``: ``(t_long - t_short) / (long -
    short)``, the median over ``repeats`` pairs, after one warm-up of each."""
    device = cuda_device(device)

    def timed(r: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(r)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    with torch.cuda.device(device):
        timed(short)
        timed(long)
        diffs = []
        for _ in range(repeats):
            t_short = timed(short)
            t_long = timed(long)
            diffs.append((t_long - t_short) / (long - short))
    return statistics.median(diffs)
