"""The Chebyshev filter's recurrence chain: kernel K5 and its plain version
(port of ``lanczos_tpu/ops/pallas_cheby.py``).

For a DIA operator (``offsets``, ``data`` with ``data[d, i] = A[i, i +
offsets[d]]``) the chain computes ``T_degree((A - c)/e) @ x``.  The rows
are prescaled once, in the data's dtype as pallas_cheby.py:141-151 does:
``data' = (2/e) data`` with ``-2c/e`` added to the 0-offset row, or
appended as a new 0-offset row.  Then

    t_1      = 0.5 * step(x)
    t_{k+1}  = step(t_k) - t_{k-1},    step(t)[i] = sum_d data'[d, i] t[i + off_d]

with entries past the matrix edge read as zero, the diagonals summed in
``offsets`` order.

:func:`cheby_chain_apply` launches the hand-written CUDA kernels
(``csrc/cheby_chain.cu``) on CUDA tensors, ``plan(n, offsets).steps``
steps per launch on the route :func:`plan` picks, and runs
:func:`cheby_chain_apply_reference` on CPU tensors.  The Pallas kernel's
VMEM budget (``cheby_chain_fits`` there) has no counterpart;
:func:`cheby_chain_fits` states the CUDA plan's own limit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build

__all__ = [
    "ChainPlan",
    "cheby_chain_apply",
    "cheby_chain_apply_reference",
    "cheby_chain_fits",
    "chain_apply_prescaled",
    "plan",
    "prescale",
    "steps_per_launch",
]

# ROADMAP.md names the work that would lift the refusal below.
_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K5 for float64 and complex vectors"
SMEM_BYTES = 227 * 1024  # opt-in dynamic shared memory of one block on sm_90
MAX_DIAGS = 32  # prescaled rows the kernel takes
_S_MAX = 128  # most steps per launch of the shared-memory route (at w = 1)
SMEM_THREADS = 1024  # threads per CTA of the shared-memory route
REG_THREADS = 256  # threads per CTA of the register route
REG_CELLS = 16  # cells per thread on the register route
REG_STEPS = 256  # steps per launch on the register route: its window loads cost more than a wider halo
REG_MAX_W = 1  # widest band the register route takes (its offsets are compile-time patterns in [-1, 1])
REG_BUDGET = 128  # registers per thread with two register-route CTAs resident per SM
ROUTES = ("registers", "shared")  # route ids 0 and 1 of the kernel entry


def steps_per_launch(w: int) -> int:
    """Recurrence steps one launch of the shared-memory route advances for
    bandwidth ``w``: 128 // w, so the halo H = steps * w stays near 128
    cells at every bandwidth."""
    return max(_S_MAX // max(int(w), 1), 1)


class ChainPlan(NamedTuple):
    """How K5 cuts a chain: ``route`` ("registers" or "shared"),
    ``threads`` per CTA, ``cells`` per thread (the register route's run; 1
    on the shared-memory route, whose threads stride the window), ``steps``
    per launch, ``halo`` H and ``core`` L cells per CTA (the window is
    L + 2H cells)."""

    route: str
    threads: int
    cells: int
    steps: int
    halo: int
    core: int


def _shared_core(ndiag: int, w: int, h: int) -> int:
    """Largest core (a multiple of 32) whose window fits t, t_prev (each
    with w zero cells on both sides) and ``ndiag`` rows in
    :data:`SMEM_BYTES`."""
    cells = (SMEM_BYTES // 4 - 4 * w) // (ndiag + 2)
    return (cells - 2 * h) // 32 * 32


def plan(n: int, offsets) -> ChainPlan:
    """K5's launch plan for prescaled rows at ``offsets``.

    The rule: distinct offsets in [-REG_MAX_W, REG_MAX_W] (so at most three
    rows) take the register route, 256 threads of :data:`REG_CELLS` cells
    each, whose rows, t, t_prev and new values (``(ndiag + 3) * cells``)
    fit :data:`REG_BUDGET`, :data:`REG_STEPS` steps per launch; the core is
    the window less the two halos.  Every other band takes the
    shared-memory route, ``steps_per_launch(w)`` steps per launch, whose
    core is the largest multiple of 32 cells that fits :data:`SMEM_BYTES`,
    or n when one window covers the vector.  The halo is steps * w on both
    routes, w = max |offset|."""
    offs = tuple(int(o) for o in offsets)
    ndiag, w = len(offs), max(abs(o) for o in offs)
    if w <= REG_MAX_W and len(set(offs)) == ndiag:
        h = REG_STEPS * w
        return ChainPlan("registers", REG_THREADS, REG_CELLS, REG_STEPS, h, REG_THREADS * REG_CELLS - 2 * h)
    s = steps_per_launch(w)
    return ChainPlan("shared", SMEM_THREADS, 1, s, s * w, min(_shared_core(ndiag, w, s * w), int(n)))


def cheby_chain_fits(ndiag: int, w: int) -> bool:
    """True when the kernels take ``ndiag`` prescaled rows of bandwidth
    ``w``: at most :data:`MAX_DIAGS` rows, and a shared-memory window with a
    halo of ``steps_per_launch(w) * w`` cells on each side and a core of at
    least one warp's 32 cells fits the block's shared memory (every band
    the register route takes fits it too)."""
    return 1 <= ndiag <= MAX_DIAGS and w >= 0 and _shared_core(ndiag, w, steps_per_launch(w) * w) >= 32


def prescale(data, offsets, c, e):
    """``(data', offsets')``: the rows times 2/e with -2c/e on the 0-offset
    row (appended when ``offsets`` has none), computed in ``data.dtype``."""
    offs = tuple(int(o) for o in offsets)
    e_t = torch.tensor(float(e), dtype=data.dtype)
    scale = 2.0 / e_t
    shift = (-2.0 * torch.tensor(float(c), dtype=data.dtype)) / e_t
    data_p = data * scale.to(data.device)
    if 0 in offs:
        data_p[offs.index(0)] += shift.to(data.device)
    else:
        data_p = torch.cat([data_p, shift.to(data.device).expand(1, data.shape[1])])
        offs = offs + (0,)
    return data_p.contiguous(), offs


def _step(data_p, offs, t):
    """sum_d data'[d] * t[i + off_d], in ``offs`` order (zero past the edge)."""
    n = t.shape[-1]
    lo = max([0] + [-d for d in offs])
    hi = max([0] + [d for d in offs])
    tp = F.pad(t, (lo, hi)) if (lo or hi) else t
    acc = None
    for d, off in enumerate(offs):
        term = data_p[d] * tp[..., lo + off : lo + off + n]
        acc = term if acc is None else acc + term
    return acc


def _chain_plain(data_p, offs, x, degree: int):
    t_prev, t = x, 0.5 * _step(data_p, offs, x)
    for _ in range(degree - 1):
        t_prev, t = t, _step(data_p, offs, t) - t_prev
    return t


def _check_degree(degree) -> int:
    degree = int(degree)
    if degree < 1:
        # T_0 is the identity; the JAX function refuses it too
        # (pallas_cheby.py:133-136).
        raise ValueError(f"degree must be >= 1, got {degree} (T_0 is the identity)")
    return degree


def cheby_chain_apply_reference(data, offsets, x, c, e, degree: int):
    """Plain PyTorch ``T_degree((A - c)/e) @ x`` on any device and dtype:
    the prescale, then the recurrence one step at a time."""
    degree = _check_degree(degree)
    data_p, offs = prescale(data, offsets, c, e)
    return _chain_plain(data_p, offs, x, degree)


def chain_apply_prescaled(data_p, offs, x, degree: int):
    """The chain on rows already prescaled by :func:`prescale` (a filter
    operator keeps them for its lifetime).

    On CUDA tensors this launches K5 (float32 only; other dtypes raise)
    ``ceil(degree / plan(n, offs).steps)`` times on the route :func:`plan`
    picks, each launch counted in ``cheby_chain_apply.launches`` and in
    ``cheby_chain_apply.launches_by_route``; on CPU tensors it runs the
    plain recurrence.
    """
    degree = _check_degree(degree)
    offs = tuple(int(o) for o in offs)
    n = x.shape[-1]
    if data_p.ndim != 2 or data_p.shape != (len(offs), n):
        raise ValueError(f"rows of shape {tuple(data_p.shape)} do not fit {len(offs)} offsets and n={n}")
    if x.device.type == "cpu":
        return _chain_plain(data_p, offs, x, degree)
    if x.device.type != "cuda":
        raise ValueError(f"cheby_chain_apply runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or data_p.dtype != torch.float32:
        raise NotImplementedError(f"K5 takes float32 rows and vectors on CUDA, got {data_p.dtype} / {x.dtype}; see {_DTYPE_ITEM}")
    if x.ndim != 1:
        raise ValueError(f"K5 takes one vector, got shape {tuple(x.shape)}")
    if data_p.device != x.device:
        raise ValueError("rows and x must be on one device")
    if not (data_p.is_contiguous() and x.is_contiguous()):
        raise ValueError("cheby_chain_apply needs contiguous tensors")
    w = max(abs(o) for o in offs)
    if not cheby_chain_fits(len(offs), w):
        raise ValueError(f"K5 does not take {len(offs)} rows of bandwidth {w} (see cheby_chain_fits)")
    p = plan(n, offs)
    route = ROUTES.index(p.route)
    lib = _build.library()
    offs_c = (ctypes.c_int * len(offs))(*offs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    t, t_prev, done = x, None, 0
    while done < degree:
        steps = min(p.steps, degree - done)
        t_out = torch.empty_like(x)
        tp_out = torch.empty_like(x)
        err = lib.lt_cheby_chain_f32(
            route, data_p.data_ptr(), offs_c, len(offs), t.data_ptr(), None if t_prev is None else t_prev.data_ptr(),
            t_out.data_ptr(), tp_out.data_ptr(), n, w, p.core, p.halo, steps, int(t_prev is None), x.device.index,
            stream,
        )
        _build.check(err, f"cheby_chain_apply (K5, {p.route} route)")
        cheby_chain_apply.launches += 1
        cheby_chain_apply.launches_by_route[p.route] += 1
        t, t_prev, done = t_out, tp_out, done + steps
    return t


def cheby_chain_apply(data, offsets, x, c, e, degree: int):
    """K5: ``T_degree((A - c)/e) @ x`` for the DIA operator (``offsets``,
    ``data``): :func:`prescale`, then :func:`chain_apply_prescaled` (the
    kernel on CUDA tensors, the plain recurrence on CPU tensors)."""
    data_p, offs = prescale(data, offsets, c, e)
    return chain_apply_prescaled(data_p, offs, x, degree)


cheby_chain_apply.launches = 0
cheby_chain_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
