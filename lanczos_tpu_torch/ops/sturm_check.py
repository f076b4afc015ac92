"""Kernel K6: the fused engine's convergence check on the card, one launch
per check (``csrc/sturm_check.cu``).

It replaces no ``pl.pallas_call``: in the JAX package the check is XLA ops
inside the fused engine's device loop (``lanczos_tpu/core/tridiagonal.py:322``
``extremal_eigenvalues_device`` under ``lax.cond``,
``lanczos_tpu/solvers/lanczos_fused.py:406-423``).  Its plain versions are
the torch code of :mod:`lanczos_tpu_torch.core.tridiagonal`
(``extremal_eigenvalues_reference`` and ``convergence_check_reference``),
which the wrappers there take for CPU tensors; CUDA tensors come here.

:func:`plan` cuts a launch: a cluster of eight CTAs per root, each with
every eighth cut, its cuts x ``size`` column of 2x2 products (two copies of
four entries) in shared memory when it fits, else in global scratch.  :func:`sturm_check` launches it and counts
the launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

__all__ = ["SturmPlan", "plan", "sturm_check", "MODES"]

SMEM_BYTES = 227 * 1024  # opt-in shared memory of one block on sm_90
STATIC_BYTES = 2048  # the kernel's static shared arrays (64 cuts, three count arrays, bracket), at most
CLUSTER = 8  # CTAs per root (a portable thread block cluster), each with every eighth cut
MAX_THREADS = 1024
MAX_POINTS = 64
MODES = {"evs": 0, "check": 1, "screen": 2}  # the kernel entry's mode ids


class SturmPlan(NamedTuple):
    """How K6 runs one multisection: ``ctas`` CTAs (a cluster of
    :data:`CLUSTER` per root, each with ``cuts`` of the root's cuts at
    most) of ``threads`` threads, the product columns on ``route`` with
    ``smem_bytes`` of dynamic shared memory per CTA, and ``scratch`` values
    of global scratch (the check's new estimate, then the columns of the
    global route)."""

    ctas: int
    cuts: int
    threads: int
    route: str
    smem_bytes: int
    scratch: int


def plan(size: int, nroot: int, itemsize: int, points: int = 15) -> SturmPlan:
    """K6's launch for a leading block of ``size`` rows, ``nroot`` roots,
    ``itemsize``-byte values and ``points`` cuts a round.

    A root's ``points`` cuts are dealt to the :data:`CLUSTER` CTAs of its
    cluster (cut p to CTA p mod 8), so a CTA holds ``cuts = ceil(points /
    8)`` columns of ``size`` cells of four entries, kept twice (the scan
    reads one copy and writes the other): ``8 * cuts * size * itemsize``
    bytes, in shared memory while that fits beside the static arrays (size
    <= 3600 in float32 at 15 cuts, <= 1800 in float64), else in global
    scratch, which the card's L2 holds at the sizes a check sees.  Threads:
    one per cell, in whole warps, at most 1024 (each thread then walks
    several cells a step), and at least one per cut and per (cut, CTA)
    pair of the count exchange."""
    size, nroot, points = int(size), int(nroot), int(points)
    if size < 1 or nroot < 1 or not 1 <= points <= MAX_POINTS:
        raise ValueError(f"K6 needs size >= 1, nroot >= 1 and 1 <= points <= {MAX_POINTS}, "
                         f"got {size}, {nroot}, {points}")
    cuts = -(-points // CLUSTER)
    cells = cuts * size
    threads = min(MAX_THREADS, -(-max(cells, points, cuts * CLUSTER) // 32) * 32)
    column = 8 * cells * itemsize
    ctas = nroot * CLUSTER
    if column <= SMEM_BYTES - STATIC_BYTES:
        return SturmPlan(ctas, cuts, threads, "shared", column, nroot)
    return SturmPlan(ctas, cuts, threads, "global", 0, nroot + ctas * 8 * cells)


# Per CUDA device index: the persistent ticket counter of check mode (the
# CTA that finishes last resets it) and the cut fractions by (dtype, points).
_TICKETS: dict = {}
_FRACS: dict = {}


def cut_fractions(points: int, dtype, device):
    """``arange(1, points + 1) / (points + 1)`` in ``dtype``: the plain
    version's own ops (a division by a scalar rounds by device), made once
    per device."""
    key = (torch.device(device), dtype, int(points))
    fr = _FRACS.get(key)
    if fr is None:
        fr = torch.arange(1, points + 1, device=device, dtype=dtype) / (points + 1)
        _FRACS[key] = fr
    return fr


def sturm_check(alpha, beta, limit, *, size: int, nroot: int, find_maximum: bool, rounds: int, points: int = 15,
                mode: str = "evs", evs=None, out=None, screened: int = 0, k: int = 0, breakdown_eps: float = 0.0,
                eps: float = 0.0, gate: bool = False):
    """K6 on CUDA tensors (float32 or float64), one launch, counted in
    ``sturm_check.launches``.

    * ``mode='evs'``: the ``nroot`` extremal eigenvalues of the leading
      ``size`` x ``size`` block of the tridiagonal (``alpha``, ``beta``) by
      ``rounds`` rounds of multisection from ``[-limit, limit]``; returns
      them in a new (nroot,) tensor (``extremal_eigenvalues_device``'s
      order).
    * ``mode='check'``: the breakdown screen of ``beta[screened:k]``
      against ``breakdown_eps``, then, without a breakdown, the
      multisection (``size == k``), the relative-change test against
      ``evs`` (the previous estimate, replaced in place) at ``eps``, gated
      by ``gate``; writes ``out`` = (stop, itern) and returns it (stop 1
      for a breakdown, 2 for convergence, else 0).
    * ``mode='screen'``: the breakdown screen alone (eps == 0).

    ``limit`` is a 0-d tensor on the device, made by the plain version's
    ops.  Nothing here waits for the device.
    """
    dev = alpha.device
    if dev.type != "cuda":
        raise ValueError(f"sturm_check (K6) runs on CUDA tensors, got {dev}")
    dtype = alpha.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K6 takes float32/float64 tridiagonals, got {dtype}")
    if beta.dtype != dtype or beta.device != dev or not (alpha.is_contiguous() and beta.is_contiguous()):
        raise ValueError("alpha and beta must be contiguous tensors of one dtype on one device")
    m = MODES[mode]
    if m != MODES["screen"]:
        if alpha.shape[0] < size or beta.shape[0] < size - 1:
            raise ValueError(f"buffers of {alpha.shape[0]}/{beta.shape[0]} rows hold no {size}-row block")
        if limit.dtype != dtype or limit.device != dev or limit.numel() != 1:
            raise ValueError("limit must be a one-value tensor of the buffers' dtype and device")
    if m != MODES["evs"]:
        if out is None or out.dtype != torch.int32 or out.numel() < 2 or out.device != dev:
            raise ValueError("the check writes (stop, itern) into an int32 tensor of 2 values on the device")
        if not 0 <= screened <= k <= beta.shape[0]:
            raise ValueError(f"screen range [{screened}, {k}) outside the {beta.shape[0]} betas")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _build.library()
    fn = lib.lt_sturm_check_f32 if dtype == torch.float32 else lib.lt_sturm_check_f64
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if m == MODES["screen"]:
        err = fn(None, beta.data_ptr(), None, None, None, None, out.data_ptr(), None, None, 0, 0, 0, 0, 0,
                 int(screened), int(k), float(breakdown_eps), 0.0, 0, m, 32, 0, idx, stream)
        _build.check(err, "sturm_check (K6) screen")
        sturm_check.launches += 1
        return out
    p = plan(size, nroot, alpha.element_size(), points)
    fracs = cut_fractions(points, dtype, dev)
    scratch = torch.empty(p.scratch, dtype=dtype, device=dev)
    gbuf = scratch.data_ptr() + nroot * alpha.element_size() if p.route == "global" else None
    if m == MODES["evs"]:
        evs = torch.empty(nroot, dtype=dtype, device=dev)
        ticket, out_ptr = None, None
    else:
        if evs is None or evs.dtype != dtype or evs.shape != (nroot,) or evs.device != dev:
            raise ValueError(f"the previous estimate must be a ({nroot},) {dtype} tensor on {dev}")
        if size != k:
            raise ValueError(f"the check tests the leading k = {k} rows, got size {size}")
        tk = _TICKETS.get(idx)
        if tk is None:
            tk = _TICKETS[idx] = torch.zeros(1, dtype=torch.int32, device=dev)
        ticket, out_ptr = tk.data_ptr(), out.data_ptr()
    err = fn(alpha.data_ptr(), beta.data_ptr(), limit.data_ptr(), fracs.data_ptr(), evs.data_ptr(),
             scratch.data_ptr(), out_ptr, ticket, gbuf, int(size), int(nroot), int(bool(find_maximum)), int(rounds),
             int(points), int(screened), int(k), float(breakdown_eps), float(eps), int(bool(gate)), m, p.threads,
             p.smem_bytes, idx, stream)
    _build.check(err, f"sturm_check (K6) {mode}")
    sturm_check.launches += 1
    return evs if m == MODES["evs"] else out


sturm_check.launches = 0
