"""The multi-card dryrun of the row-partitioned path (port of
``__graft_entry__.dryrun_multichip``) and its launcher.

:func:`dryrun_multichip` runs inside a process group, on every rank: the JAX
package's regimes, one by one, with its shapes, seeds, engine settings and
bars.  Where the JAX package runs one controller over an n-device mesh,
each rank here runs the same solve on its slab (``torch.distributed``), so
regime 1's ``vmap`` over a ``(batch, rows)`` mesh becomes one dense solve
per slice of a :func:`~.mesh.make_multislice_mesh` grid, over that slice's
rows, and the multi-process regime becomes :func:`.mp_demo.run_solves`
inside the running world.  Regimes that the JAX package skips below two
devices are skipped the same way.  Each regime's record holds its values,
its errors against the bars, its iteration counts and whether every rank
of each solve holds the same bits (the values all-gathered and compared as
int64 words); rank 0 prints it as one JSON line.  A missed bar or a rank
with other bits raises, on every rank alike.

:func:`engines` (``--engines``) runs the row-partitioned engines' set
(:func:`.engine_set.engine_set`: thick, block thick, a resumed checkpoint,
precise thick, the footprint exchange, bfloat16 and complex slabs, the
filter and the Exponentiator over DIA slabs) at the one-card phases'
widths, in place of the dryrun; over gloo ranks at its CPU size.

:func:`full_width` (``--full``) runs the full-width set beside the one-card
phases of ``chip_smoke.py``: the main path's n = 2**20 operator as a
:class:`~.sharded.ShardedBSROperator` under ``comm='gather'`` and
``comm='auto'``, with the same solve on a one-rank group of the same world
and the matvec's scaling from one rank to all; the n = 2**22 block flagship
over a :class:`~.sharded.ShardedDIAOperator`; and a ``2 x 2`` grid (the
chain over its combined axes and a 2-D dense operator).

On a host with N cards::

    python3 -m lanczos_tpu_torch.parallel.multichip --ranks N [--full] [--engines]

builds the kernel library once, then starts one process per card.  Each
rank sets its card (``torch.cuda.set_device``) before it joins the NCCL
process group at a local rendezvous; the launcher runs every rank under one
timeout and kills them all, exiting non-zero, when one fails or the world
outlives it.  ``--device cpu`` runs gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

__all__ = ["dryrun_multichip", "full_width", "engines", "launch", "main"]

# The JAX dryrun's bars (__graft_entry__.py:112, :140, :174, :203, :214,
# :234, :253, :268, :289-291, :307-308, :330).
SANITY_BAR = 5e-2
PV_BAR = 1e-8
FILTER_BAR = 1e-10
NORM_BARS = (1e-4, 1e-10)
DEMO_BARS = (1e-11, 1e-10)

MAIN_N = 2**20  # the main path's chain (chip_smoke.py phase main_path)
FLAGSHIP_N = 2**22  # the block flagship's chain (experiments/tpu_flagship_block.py)
GRID_DENSE_N = 32768  # the main path's construction stored dense (chip_smoke.py phase grid_mesh)
SEED = 0


def _stencil_coo(n):
    i = np.arange(n - 1)
    return np.concatenate([i, i + 1]), np.concatenate([i + 1, i]), np.full(2 * (n - 1), -1.0)


def _chain_min(n, k=1):
    return -2.0 * np.cos(np.pi * np.arange(1, k + 1) / (n + 1))


def _host(x):
    """A tensor or array as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _gathered(torch, world, values):
    """``values`` (a flat list of numbers) of every rank as float64, one
    row a rank."""
    from .mesh import all_gather

    t = torch.tensor(np.asarray(values, np.float64).ravel(), device=world.device)
    return all_gather(t, world).cpu().numpy().reshape(world.size, -1)


def _same_bits(values, world, key: int = 0):
    """All-gather ``values`` (a flat list of numbers) with this rank's
    solve ``key`` over ``world``; returns ``(rows by key in key order,
    same)``: ``same`` when every rank with one key holds the same float64
    words."""
    import torch

    rows, same = {}, True
    for row in _gathered(torch, world, [float(key), *np.ravel(values)]):
        k = int(row[0])
        if k in rows:
            same &= bool(np.array_equal(rows[k].view(np.int64), row[1:].view(np.int64)))
        else:
            rows[k] = row[1:].copy()
    return [rows[k].tolist() for k in sorted(rows)], same


class _Regimes:
    """The records of one dryrun: each regime checked against its bars and
    printed by rank 0."""

    def __init__(self, world, emit):
        self.world, self.emit, self.records = world, emit, []

    def record(self, regime, name, values, checks, seconds, iterations=None, key=0, **extra):
        rows, same = _same_bits(values, self.world, key)
        rec = {"regime": regime, "name": name, "world": self.world.size, "values": rows if key else rows[0],
               "checks": {k: [float(err), bar] for k, (err, bar) in checks.items()},
               "iteration_counts": iterations, "same_bits": same, "seconds": seconds, **extra}
        rec["ok"] = same and all(err < bar for err, bar in checks.values())
        self.records.append(rec)
        if self.emit is not None and self.world.rank == 0:
            self.emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"dryrun regime {regime} ({name}) failed: {json.dumps(rec)}")

    def skip(self, regime, name, why):
        rec = {"regime": regime, "name": name, "world": self.world.size, "skipped": why, "ok": True}
        self.records.append(rec)
        if self.emit is not None and self.world.rank == 0:
            self.emit(rec)


def _fused_min(op, v0, m_cap, find_maximum):
    """The JAX dryrun's fused build (eps 1e-5, one root) from the slab
    ``v0``: (its value, its iterations)."""
    import torch

    from ..solvers.lanczos_fused import fused_krylov

    defl = torch.zeros((1, op.n_local), dtype=v0.dtype, device=v0.device)
    mask = torch.zeros((1,), dtype=v0.dtype, device=v0.device)
    _u, _a, _b, itern, evs = fused_krylov(op, v0, defl, mask, 1e-5, 0.0, nroot=1, m_cap=m_cap,
                                          find_maximum=find_maximum)
    return float(evs[0]), int(itern)


def dryrun_multichip(n_devices: int | None = None, *, emit=print, skip=()) -> list[dict]:
    """Run the JAX package's dryrun regimes over the current process group
    (every rank calls it) and return their records; rank 0 passes each to
    ``emit`` (default: one JSON line on stdout; None prints nothing).

    ``n_devices`` defaults to the world size and must equal it.  The
    regimes numbered in ``skip`` are recorded as skipped (the CPU tests'
    gloo worlds leave out 9 and 11, the two that take seconds there).
    Raises ``AssertionError`` on the first regime that misses a bar or
    whose ranks disagree in a bit."""
    import torch

    from ..api import Exponentiator, LambdaLanczos
    from ..solvers.filtered import filtered_lanczos
    from . import mesh as pmesh
    from . import mp_demo
    from .sharded import ShardedBSROperator, ShardedDenseOperator, ShardedDIAOperator

    world = pmesh.make_mesh()
    n_devices = world.size if n_devices is None else int(n_devices)
    if n_devices != world.size:
        raise ValueError(f"need {n_devices} ranks, the world has {world.size}")
    out = _Regimes(world, None if emit is None else (lambda rec: emit(json.dumps(rec))))
    f32 = torch.float32

    def wanted(regime, name):
        if regime in skip:
            out.skip(regime, name, "left out by the caller")
        return regime not in skip

    def clock():
        if world.device.type == "cuda":
            torch.cuda.synchronize(world.device)
        return time.perf_counter()

    # ---- regime 1: a batch of dense solves, one per slice, over its rows
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    grid = pmesh.make_multislice_mesh(dp)
    s = grid.coords[0]
    n, m_cap = 64, 24
    rng = np.random.default_rng(0)
    a = rng.standard_normal((dp, n, n)).astype(np.float32)
    a = (a + np.swapaxes(a, 1, 2)) / 2
    v0 = rng.uniform(-1, 1, size=(dp, n)).astype(np.float32)
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    t0 = clock()
    op1 = ShardedDenseOperator.from_dense(torch.from_numpy(a[s]), grid.rows_mesh)
    got, it1 = _fused_min(op1, op1.scatter(torch.from_numpy(v0[s])), m_cap, True)
    ref = np.linalg.eigvalsh(a.astype(np.float64))[:, -1]
    out.record(1, "batch_x_rows_dense", [got], {"rel_err": (abs(got - ref[s]) / abs(ref[s]), SANITY_BAR)},
               clock() - t0, [it1], key=s + 1, grid=list(grid.shape), reference=ref.tolist())

    # ---- regime 2: the 1-D row-partitioned BSR fused solve (gather)
    ns = 128
    r, c, v = _stencil_coo(ns)
    expected = _chain_min(ns)[0]
    t0 = clock()
    op = ShardedBSROperator.from_coo(r, c, v, ns, world, dtype=f32)
    w0 = rng.uniform(-1, 1, size=op.n_padded).astype(np.float32)
    w0[ns:] = 0.0
    w0 /= np.linalg.norm(w0)
    # Over the padded space: the padding adds eigenvalue 0, the minimum stays.
    pad_op = ShardedBSROperator(op.blocks, op.col_blocks, op.n_padded, world)
    w0_s = pad_op.scatter(torch.from_numpy(w0))
    got, it2 = _fused_min(pad_op, w0_s, 16, False)
    out.record(2, "bsr_fused_gather", [got], {"abs_err": (abs(got - expected), SANITY_BAR)}, clock() - t0, [it2],
               comm=pad_op.comm)

    # ---- regime 3: the DIA chain over the combined (slices, rows) axes
    if n_devices % 2 == 0 and n_devices > 1:
        n3 = 256
        off = np.full(n3, -1.0, np.float32)
        t0 = clock()
        op3 = ShardedDIAOperator.from_diagonals([-1, 1], [off, off], n3, grid.combined)
        v3 = rng.uniform(-1, 1, size=n3).astype(np.float32)
        v3 /= np.linalg.norm(v3)
        got, it3 = _fused_min(op3, op3.scatter(torch.from_numpy(v3)), 16, False)
        out.record(3, "multislice_dia", [got], {"abs_err": (abs(got - _chain_min(n3)[0]), SANITY_BAR)},
                   clock() - t0, [it3], grid=list(grid.shape))
    else:
        out.skip(3, "multislice_dia", "the JAX dryrun runs it on an even number of devices above one")

    # ---- regime 4: block thick restart over the 1-D sharded DIA operator
    n4 = 256
    off4 = np.full(n4, -1.0, np.float32)
    expected4 = _chain_min(n4)[0]

    def block_thick(mesh_):
        eng = LambdaLanczos(ShardedDIAOperator.from_diagonals([-1, 1], [off4, off4], n4, mesh_),
                            find_maximum=False, num_eigs=1)
        eng.block_size = 2
        eng.restart_policy = "thick"
        eng.max_iteration = 32
        eng.eps = 1e-3
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            val, _ = eng.run_one()
        return float(val), eng.iteration_counts

    t0 = clock()
    val4, it4 = block_thick(world)
    out.record(4, "block_thick_dia", [val4], {"abs_err": (abs(val4 - expected4), SANITY_BAR)}, clock() - t0, it4)

    # ---- regime 5: the ring-halo BSR under the fused engine
    t0 = clock()
    op5 = ShardedBSROperator.from_coo(r, c, v, ns, world, dtype=f32, comm="ring")
    pad_op5 = ShardedBSROperator(op5.blocks, op5.col_blocks, op5.n_padded, world, comm=op5.comm,
                                 ring_groups=op5.ring_groups)
    got, it5 = _fused_min(pad_op5, w0_s, 16, False)
    out.record(5, "bsr_fused_ring", [got], {"abs_err": (abs(got - expected), SANITY_BAR)}, clock() - t0, [it5],
               comm=pad_op5.comm)

    # ---- regimes 7 and 8: precise_vectors thick over DIA and ring BSR slabs
    def precise_thick(op_):
        eng = LambdaLanczos(op_, find_maximum=False, num_eigs=1, dtype=np.float32, mode="fused")
        eng.precise_vectors = True
        eng.restart_policy = "thick"
        eng.max_iteration = 32
        eng.max_restarts = 64
        eng.eps = 1e-10
        eng.eigenvalue_offset = -4.0
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            val, _ = eng.run_one()
        return float(val), eng.iteration_counts

    t0 = clock()
    val7, it7 = precise_thick(ShardedDIAOperator.from_diagonals([-1, 1], [off4, off4], n4, world))
    out.record(7, "precise_thick_dia", [val7], {"abs_err": (abs(val7 - expected4), PV_BAR)}, clock() - t0, it7)
    t0 = clock()
    op8 = ShardedBSROperator.from_coo(r, c, v, ns, world, dtype=f32, comm="ring")
    val8, it8 = precise_thick(op8)
    out.record(8, "precise_thick_bsr_ring", [val8], {"abs_err": (abs(val8 - expected), PV_BAR)}, clock() - t0, it8,
               comm=op8.comm)

    # ---- regime 9: the precise filtered solve over DIA slabs
    if wanted(9, "precise_filtered_dia"):
        t0 = clock()
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            vals9, _v9, info9 = filtered_lanczos(ShardedDIAOperator.from_diagonals([-1, 1], [off4, off4], n4, world),
                                                 num_eigs=1, lo=-2.0, hi=2.0, precise=True)
        val9 = float(np.asarray(vals9)[0])
        out.record(9, "precise_filtered_dia", [val9], {"abs_err": (abs(val9 - expected4), FILTER_BAR)}, clock() - t0,
                   info9["iteration_counts"], degree=info9["filter_degree"])

    # ---- regime 10: the Chebyshev propagator, float32 and precise
    t0 = clock()
    ex = Exponentiator(ShardedDIAOperator.from_diagonals([-1, 1], [off4, off4], n4, world), dtype=np.float32)
    rng10 = np.random.default_rng(5)
    v10 = rng10.standard_normal(n4).astype(np.float32)
    v10 /= np.linalg.norm(v10)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        (cr, ci), k10 = ex.run_chebyshev(1.5j, v10, lo=-2.0, hi=2.0)
        v10_64 = v10.astype(np.float64)
        v10_64 /= np.linalg.norm(v10_64)  # a float32-normalized state is only 1 +- 3e-8
        (pr, pi), k10p = ex.run_chebyshev(1.5j, v10_64, np.zeros(n4), lo=-2.0, hi=2.0, precise=True)
    nrm = float(np.linalg.norm(_host(cr) + 1j * _host(ci)))
    nrm_p = float(np.linalg.norm(_host(pr) + 1j * _host(pi)))
    out.record(10, "chebyshev_propagator", [nrm, nrm_p],
               {"norm_err": (abs(nrm - 1.0), NORM_BARS[0]), "norm_err_precise": (abs(nrm_p - 1.0), NORM_BARS[1])},
               clock() - t0, terms=[int(k10), int(k10p)])

    # ---- regime 11: the multi-process demo, inside the running world
    if wanted(11, "mp_demo"):
        t0 = clock()
        demo = mp_demo.run_solves(n=256)
        out.record(11, "mp_demo", [demo["stencil_val"], *demo["pv_vals"], *demo["pv_thick_vals"]],
                   {"stencil_err": (demo["stencil_err"], DEMO_BARS[0]), "pv_err": (demo["pv_err"], DEMO_BARS[1]),
                    "pv_thick_err": (demo["pv_thick_err"], DEMO_BARS[1])}, clock() - t0,
                   [demo["iteration_counts"], demo["pv_iteration_counts"], demo["pv_thick_iteration_counts"]])

    # ---- regime 6: block thick over the rows of each slice of the grid
    if dp > 1:
        t0 = clock()
        val6, it6 = block_thick(grid.rows_mesh)
        out.record(6, "block_thick_grid_rows", [val6], {"abs_err": (abs(val6 - expected4), SANITY_BAR)},
                   clock() - t0, it6, key=s + 1, grid=list(grid.shape))
    else:
        out.skip(6, "block_thick_grid_rows", "the JAX dryrun runs it when the batch axis holds two slices")
    return out.records


# ------------------------------------------------------------ full width


def main_path_coo(n: int = MAIN_N):
    """The main path's problem: the n-site hopping chain with a potential
    uniform in [0, 1) from ``default_rng(0)`` and three deep sites (three
    bound states below the band); (rows, cols, vals), the chain's two
    diagonals first, then the potential."""
    rng = np.random.default_rng(SEED)
    pot = rng.uniform(0.0, 1.0, n)
    pot[[n // 4, n // 2, 3 * n // 4]] = [-4.0, -3.5, -3.0]
    i = np.arange(n - 1)
    return (np.concatenate([i, i + 1, np.arange(n)]), np.concatenate([i + 1, i, np.arange(n)]),
            np.concatenate([np.full(2 * (n - 1), -1.0), pot]))


def main_path_engine(op, dtype=None, mode: str = "auto"):
    """``LambdaLanczos`` over ``op`` as the main path configures it (three
    pairs, eps 1e-6, a fixed float32 start; vectors in ``dtype``: the
    operator's by default, float32 for bfloat16 tiles).  The three bound
    states are checked on their own (scipy and residuals), so the
    confirming deflation round, which would resolve the gap-less band edge
    to eps, is skipped.  Raises unless ``mode`` resolves to the fused
    engine (``'auto'`` does on the card; the CPU tests pass ``'fused'``)."""
    import torch

    from ..api import LambdaLanczos
    from ..utils.random import fixed_seed_initializer

    eng = LambdaLanczos(op, num_eigs=3, find_maximum=False, dtype=dtype, mode=mode)
    eng.eps = 1e-6
    eng.init_vector = fixed_seed_initializer(torch.float32, seed=SEED)  # the same start every run
    eng.stop_when_full = True
    resolved = eng._resolve_mode()
    if resolved != "fused":
        raise AssertionError(f"mode={mode!r} resolved to {resolved} on {op.device}")
    return eng


def _launch_counts():
    from ..ops import cgs, spmv

    return {"k1": spmv.bsr_matvec.launches, "k2": spmv.bsr_matvec_rsmk.launches, "k3": cgs.cgs_pass.launches,
            "k4": cgs.cgs_pass_block.launches}


def _zero_counts():
    from ..ops import cgs, spmv

    spmv.bsr_matvec.launches = spmv.bsr_matvec_rsmk.launches = 0
    cgs.cgs_pass.launches = cgs.cgs_pass_block.launches = 0


def _cuda_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``reps`` calls
    back to back (collectives: every rank calls it alike)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(torch, fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn`` while its calls are queued (no
    synchronize inside the loop): the enqueue cost."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _host_profile(torch, fn, top: int = 10) -> dict:
    """``fn`` under ``torch.profiler`` with host activity: the host ops that
    take the most self time (name, calls, self ms, device ms) and the calls
    that make the host wait for the device."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
    return {"top_host_self_ms": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3,
                                  getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3]
                                 for e in rows[:top]],
            "host_waits": {e.key: e.count for e in rows if e.key.startswith(waits)}}


def _profile(torch, fn) -> dict:
    """``fn`` under ``torch.profiler`` (device activity only): the device
    span, busy time (the union of the device intervals) and idle share, and
    device ms by kernel family (NCCL, K2, K3, K4)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, None, None
    for lo, hi in spans:
        if cur_e is None or lo > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = lo, hi
        else:
            cur_e = max(cur_e, hi)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]

    def ms(*names):
        return sum(e.time_range.end - e.time_range.start for e in device if any(m in e.name for m in names)) / 1e3

    return {"device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / span,
            "nccl_device_ms": ms("nccl"), "k2_device_ms": ms("bsr_spmv"),
            "k3_device_ms": ms("cgs_project_kernel", "reduce_rows_kernel", "cgs_update_kernel"),
            "k4_device_ms": ms("cgs_block"), "device_events": len(device)}


def _collective_ms(torch, op) -> dict:
    """ms per call of each collective kind of the main path's iteration at
    its shapes: the x all-gather (the gather comm's), a scalar all-reduce
    (alpha, beta), the k-coefficient all-reduce of a split K3 pass (k =
    128) and the ring's neighbour exchange with its wait."""
    from ..core.linalg import reduce_sum
    from .mesh import all_gather
    from .sharded import _exchange, _wait

    mesh, dev = op.mesh, op.device
    x = torch.randn(op.n_local, device=dev)
    scalar = torch.ones((), device=dev)
    coeffs = torch.ones(128, device=dev)
    left, right = torch.zeros_like(x), torch.zeros_like(x)

    def ring():
        _wait(_exchange(mesh, [(x, mesh.rank + 1, 0), (x, mesh.rank - 1, 1)],
                        [(left, mesh.rank - 1, 0), (right, mesh.rank + 1, 1)]))

    kinds = {"x_all_gather": lambda: all_gather(x, mesh), "scalar_all_reduce": lambda: reduce_sum(scalar, mesh.group),
             "k128_all_reduce": lambda: reduce_sum(coeffs, mesh.group), "ring_exchange": ring}
    return {**{name: _cuda_ms(torch, fn, 200) for name, fn in kinds.items()},
            "host_us": {name: _host_us(torch, fn) for name, fn in kinds.items()}, "x_bytes": op.n_local * 4}


def full_width(emit=print) -> list[dict]:
    """The full-width set over the current NCCL world (every rank calls
    it); rank 0 passes each record to ``emit``.  Raises on a missed bar, on
    ranks that disagree in a bit, or on a kernel that did not launch."""
    import scipy.linalg
    import scipy.sparse
    import scipy.sparse.linalg
    import torch
    import torch.distributed as dist

    from ..api import LambdaLanczos
    from . import mesh as pmesh
    from .mesh import RowMesh
    from .sharded import ShardedBSROperator, ShardedDIAOperator

    world = pmesh.make_mesh()
    if world.device.type != "cuda":
        raise RuntimeError("the full-width set measures the cards: run it over NCCL ranks")
    dev, rank = world.device, world.rank
    records = []

    def put(rec):
        records.append(rec)
        if rank == 0 and emit is not None:
            emit(json.dumps(rec))

    def solve(eng):
        _zero_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        vals, vecs = eng.run()
        torch.cuda.synchronize()
        return np.asarray(vals, np.float64), vecs, time.perf_counter() - t0, _launch_counts()

    def agree(label, values):
        rows, same = _same_bits(values, world)
        if not same:
            raise AssertionError(f"{label}: the ranks hold other bits than rank 0's {rows}")
        return same

    # ---- the main path's operator: one rank, then every rank, gather and auto
    n = MAIN_N
    rows, cols, vals = main_path_coo(n)
    ref = torch.zeros(3, dtype=torch.float64, device=dev)
    if rank == 0:
        a = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        ref[:] = torch.from_numpy(np.sort(scipy.sparse.linalg.eigsh(a, k=3, which="SA")[0]))
    dist.broadcast(ref, src=0)
    ref = ref.cpu().numpy()
    one_group = dist.new_group([0])

    def held(label, evals, vecs, eng, want, rel_bar=1e-5, res_bar=1e-3):
        rel = np.abs(evals - want) / np.abs(want)
        residuals = eng.residuals(evals, vecs)
        if not (np.all(np.isfinite(evals)) and bool(torch.isfinite(vecs).all()) and np.all(rel <= rel_bar)
                and max(residuals) <= res_bar):
            raise AssertionError(f"{label}: {evals} vs {want} (relative {rel}), residuals {residuals}")
        return float(rel.max()), residuals

    one_rank = {}
    if rank == 0:
        mesh1 = RowMesh(one_group, 0, 1, dev)
        op1 = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh1, bm=128, bk=128, dtype=torch.float32)
        eng = main_path_engine(op1)
        eng.run()  # warm: the first solve loads every kernel
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev1, vecs1 = eng.run()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        rel, residuals = held("main path, one rank", np.asarray(ev1, np.float64), vecs1, eng, ref)
        x1 = op1.scatter(torch.randn(n, generator=torch.Generator().manual_seed(SEED + 2)).to(dev))
        one_rank = {"wall_s": wall1, "iteration_counts": eng.iteration_counts, "launches": _launch_counts(),
                    "max_rel_err": rel, "matvec_ms": _cuda_ms(torch, lambda: op1.matvec(x1)),
                    "stored_values": op1.blocks.numel()}
        del op1, eng, vecs1, x1
        torch.cuda.empty_cache()
    dist.barrier()

    for comm in ("gather", "auto"):
        t0 = time.perf_counter()
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, world, bm=128, bk=128, dtype=torch.float32, comm=comm)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        eng = main_path_engine(op)
        cold = solve(eng)  # the first solve: kernel loads and each communicator's first use
        evals, vecs, wall, launches = solve(eng)
        rel, residuals = held(f"main path, comm={op.comm}", evals, vecs, eng, ref)
        per_rank = _gathered(torch, world, [launches[k] for k in ("k1", "k2", "k3")])
        if any(r[0] != 0 or r[1] == 0 or r[2] == 0 for r in per_rank):
            raise AssertionError(f"main path, comm={op.comm}: launches (K1, K2, K3) by rank {per_rank}")
        same = agree(f"main path, comm={op.comm}", [*evals, *eng.iteration_counts])
        profile = host = None  # rank 0's two profiled solves; the peers run them unprofiled
        if rank == 0:
            profile, host = _profile(torch, eng.run), _host_profile(torch, eng.run)
        else:
            eng.run()
            eng.run()
        x = op.scatter(torch.randn(n, generator=torch.Generator().manual_seed(SEED + 2)).to(dev))
        matvec_ms = _cuda_ms(torch, lambda: op.matvec(x))
        walls = _gathered(torch, world, [wall])
        rec = {"phase": "multichip_main_path", "world": world.size, "comm": op.comm, "n": n,
               "tiles_per_rank": list(op.blocks.shape), "pack_s": pack_s, "eigenvalues": evals.tolist(),
               "scipy_eigsh": ref.tolist(), "max_rel_err": rel, "residuals": residuals,
               "iteration_counts": eng.iteration_counts, "first_solve_wall_s": cold[2], "wall_s": wall,
               "wall_s_by_rank": walls[:, 0].tolist(), "launches_by_rank": per_rank.tolist(), "same_bits": same,
               "profile_rank0": profile, "host_profile_rank0": host, "matvec_ms": matvec_ms, "collective_ms": _collective_ms(torch, op)}
        if rank == 0:
            stored = one_rank["stored_values"]
            rate1, rate_w = stored / one_rank["matvec_ms"] * 1e3, stored / matvec_ms * 1e3
            rec["one_rank"] = one_rank
            rec["scaling"] = {"stored_values": stored, "nnz_per_s_1": rate1, "nnz_per_s_world": rate_w,
                              "efficiency": rate_w / (world.size * rate1), "target": 0.8}
        put(rec)
        del op, eng, vecs, x
        torch.cuda.empty_cache()

    # ---- the block flagship over DIA slabs
    nf = FLAGSHIP_N
    opf = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(nf, -1.0, np.float32)] * 2, nf, world)
    eng = LambdaLanczos(opf, num_eigs=3, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 256
    eng.restart_policy = "thick"
    eng.block_size = 3
    eng.eps = 5e-8
    eng.max_restarts = 24
    eng.thick_keep = 24
    rng = np.random.default_rng(SEED)  # distinct start rows, the same on every rank and every run
    eng.init_vector = lambda n_: rng.uniform(-1.0, 1.0, n_).astype(np.float32)
    evals, vecs, wall, launches = solve(eng)
    exact = _chain_min(nf, 3)
    errs = np.abs(np.sort(evals) - exact)
    residuals = eng.residuals(evals, vecs)
    if not (np.all(errs <= 2e-6) and np.all(np.isfinite(residuals))):
        raise AssertionError(f"block flagship: {evals} vs {exact}: errors {errs}, residuals {residuals}")
    per_rank = _gathered(torch, world, [launches["k4"], launches["k3"], launches["k1"]])
    if any(r[0] == 0 for r in per_rank):
        raise AssertionError(f"block flagship: K4 launches by rank {per_rank}")
    put({"phase": "multichip_block_flagship", "world": world.size, "n": nf, "block_size": 3,
         "eigenvalues": evals.tolist(), "exact": exact.tolist(), "abs_errs": errs.tolist(), "residuals": residuals,
         "iteration_counts": eng.iteration_counts, "wall_s": wall, "launches_by_rank_k4_k3_k1": per_rank.tolist(),
         "same_bits": agree("block flagship", [*evals, *eng.iteration_counts])})
    del opf, eng, vecs
    torch.cuda.empty_cache()

    # ---- a real 2 x 2 grid: the chain over its combined axes, a 2-D dense operator
    if world.size == 4:
        grid = pmesh.make_multislice_mesh(2)
        diags = [np.full(n, -1.0), vals[2 * (n - 1):], np.full(n, -1.0)]
        opg = ShardedDIAOperator.from_diagonals([-1, 0, 1], diags, n, grid.combined, dtype=torch.float32)
        eng = main_path_engine(opg)
        cold = solve(eng)  # the first solve: each subgroup's first use
        evals, vecs, wall, launches = solve(eng)
        rel, residuals = held("grid, combined DIA", evals, vecs, eng, ref)
        rec = {"phase": "multichip_grid", "world": world.size, "grid": list(grid.shape),
               "combined_dia": {"n": n, "eigenvalues": evals.tolist(), "max_rel_err": rel, "residuals": residuals,
                                "iteration_counts": eng.iteration_counts, "first_solve_wall_s": cold[2],
                                "wall_s": wall, "launches_k3_k1_by_rank": _gathered(torch, world, [launches["k3"], launches["k1"]]).tolist(),
                                "same_bits": agree("grid, combined DIA", [*evals, *eng.iteration_counts])}}
        del opg, eng, vecs
        m = GRID_DENSE_N
        r2, c2, v2 = main_path_coo(m)
        want = scipy.linalg.eigh_tridiagonal(v2[2 * (m - 1):], -np.ones(m - 1), eigvals_only=True, select="i",
                                             select_range=(0, 2))
        a = torch.zeros((m, m), dtype=torch.float32, device=dev)
        a[torch.from_numpy(r2).to(dev), torch.from_numpy(c2).to(dev)] = torch.from_numpy(v2).to(dev, torch.float32)
        op2d = pmesh.shard_dense_operator_2d(a, grid)
        del a
        torch.cuda.empty_cache()
        dist.barrier()
        t0 = time.perf_counter()
        op2d.matvec(torch.zeros(op2d.n_local, dtype=torch.float32, device=dev))  # the subgroups' first use
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        eng = main_path_engine(op2d)
        evals, vecs, wall, launches = solve(eng)
        rel, residuals = held("grid, 2-D dense", evals, vecs, eng, want)
        rec["dense_2d"] = {"n": m, "block": list(op2d.a.shape), "eigenvalues": evals.tolist(),
                           "eigh_tridiagonal": want.tolist(), "max_rel_err": rel, "residuals": residuals,
                           "iteration_counts": eng.iteration_counts, "wall_s": wall, "first_matvec_s": first_s,
                           "launches_k3_by_rank": _gathered(torch, world, [launches["k3"]]).tolist(),
                           "same_bits": agree("grid, 2-D dense", [*evals, *eng.iteration_counts])}
        put(rec)
        del op2d, eng, vecs
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ engines


def engines(emit=print, workdir: str | None = None) -> dict:
    """The row-partitioned engines' set over the current world (every rank
    calls it): first every collective kind in every vector dtype
    (:func:`.engine_set.collectives`, recorded; one refused or wrong raises
    once the set has run), then :data:`.engine_set.FULL` over NCCL ranks, its CPU size
    :data:`.engine_set.SMALL` over gloo; rank 0 passes each record, then a
    summary, to ``emit`` as JSON lines.  ``workdir`` is a directory
    every rank sees (the checkpoint case's file).  Raises on a missed bar,
    a kernel that did not launch on some rank, or ranks that disagree in a
    bit."""
    from . import mesh as pmesh
    from .engine_set import FULL, SMALL, collectives, engine_set

    world = pmesh.make_mesh()
    sizes = FULL if world.device.type == "cuda" else SMALL
    t0 = time.perf_counter()
    kinds = collectives(world)
    refused = {k: {d: r for d, r in by.items() if r != "ok"} for k, by in kinds.items()}
    refused = {k: v for k, v in refused.items() if v}
    if emit is not None and world.rank == 0:
        emit(json.dumps({"phase": "multichip_collectives", "world": world.size, "results": kinds,
                         "ok": not refused}))
    records = engine_set(world, sizes=sizes, emit=None if emit is None else (lambda rec: emit(json.dumps(rec))),
                         workdir=workdir)
    if refused:  # the cases that need a refused kind raise on their own; the rest ran
        raise AssertionError(f"collectives refused or wrong over {world.size} ranks: {refused}")
    if emit is not None and world.rank == 0:
        emit(json.dumps({"phase": "multichip_engines_done", "world": world.size, "sizes": dataclasses.asdict(sizes),
                         "seconds": time.perf_counter() - t0, "cases": list(records)}))
    return records


def _card_names() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
    every card's name and power limit, one a line (the error text when the
    tool fails)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


# ------------------------------------------------------------- launcher


def _rank_main(args) -> int:
    """One rank: set the card, join the world, run the dryrun (or, with
    ``--engines``, the engines' set; and with ``--full`` the full-width
    set); a failure ends the process at once with code 1."""
    import torch
    import torch.distributed as dist

    from . import mesh as pmesh

    try:
        cuda = args.device == "cuda"
        if cuda:
            torch.cuda.set_device(args.rank)  # before the process group: NCCL binds each rank to its card
        pmesh.initialize_distributed(backend="nccl" if cuda else "gloo", init_method=args.init_method,
                                     world_size=args.ranks, rank=args.rank,
                                     timeout=datetime.timedelta(seconds=args.timeout))
        world = pmesh.make_mesh()
        t0 = time.perf_counter()
        probe = torch.ones(1, device=world.device)
        dist.all_reduce(probe)  # the first collective creates the communicator
        if cuda:
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if args.abort_rank == args.rank:  # the drill: this rank dies with the world running
            os._exit(3)
        if world.rank == 0:
            print(json.dumps({"phase": "world", "backend": str(dist.get_backend()), "world": world.size,
                              "device": str(world.device), "first_collective_s": first_s,
                              "sum_of_ones": float(probe[0]), **({"cards": _card_names()} if cuda else {})}),
                  flush=True)
        if not args.engines or args.full:
            dryrun_multichip(args.ranks, emit=lambda line: print(line, flush=True))
        if args.full:
            full_width(emit=lambda line: print(line, flush=True))
        if args.engines:
            engines(emit=lambda line: print(line, flush=True), workdir=args.workdir)
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # the peers block in a collective: the launcher ends them
    return 0


def launch(ranks: int, *, full: bool = False, engines: bool = False, device: str = "cuda", timeout: float = 1200.0,
           log_dir: str | None = None, abort_rank: int | None = None) -> list[dict]:
    """Run the dryrun (and with ``full`` the full-width set) over ``ranks``
    processes at a local rendezvous and return rank 0's records;
    ``engines`` runs the engines' set instead of the dryrun (beside both
    with ``full``), its checkpoint in ``log_dir``.

    ``device='cuda'`` puts rank i on card i over NCCL, after building the
    kernel library once here; ``'cpu'`` runs gloo ranks.  Each rank's
    output goes to ``log_dir`` (default: a new temporary directory).  When
    a rank fails, or the world outlives ``timeout`` seconds, every rank is
    killed and the call raises ``RuntimeError`` with the failing ranks'
    output.  ``abort_rank`` is the drill: that rank exits once the world's
    first collective is done."""
    ranks = int(ranks)
    if device == "cuda":
        import torch

        from .. import _build
        from ..native import build as native_build

        if torch.cuda.device_count() < ranks:
            raise RuntimeError(f"{ranks} ranks need {ranks} cards, this host has {torch.cuda.device_count()}")
        _build.library()  # once, before the ranks: each would otherwise start its own nvcc processes
        native_build.shared_object_path()
    log_dir = log_dir or tempfile.mkdtemp(prefix="multichip-")
    os.makedirs(log_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(ranks),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // ranks) if device == "cuda" else 1),
               PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(log_dir, f"rank{i}.log") for i in range(ranks)]
    procs = []
    try:
        for i in range(ranks):
            with open(logs[i], "w") as f:
                cmd = [sys.executable, "-m", "lanczos_tpu_torch.parallel.multichip", "--rank", str(i), "--ranks",
                       str(ranks), "--init-method", f"tcp://127.0.0.1:{port}", "--device", device, "--timeout",
                       str(timeout), "--workdir", log_dir, *(["--full"] if full else []),
                       *(["--engines"] if engines else []),
                       *(["--abort-rank", str(abort_rank)] if abort_rank is not None else [])]
                procs.append(subprocess.Popen(cmd, env=dict(env, LOCAL_RANK=str(i)), stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def tail(i):
        with open(logs[i]) as f:
            return f.read()[-4000:]

    if failed or not all(c == 0 for c in codes):
        why = (f"rank(s) {failed} failed (codes {codes})" if failed
               else f"the world outlived its {timeout} s timeout")
        raise RuntimeError(f"multichip launch: {why}; every rank was killed\n"
                           + "\n".join(f"--- rank {i} ({logs[i]}):\n{tail(i)}" for i in (failed or range(ranks))))
    with open(logs[0]) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, required=True, help="ranks of the world, one a card under NCCL")
    ap.add_argument("--full", action="store_true", help="also run the full-width set (NCCL only)")
    ap.add_argument("--engines", action="store_true",
                    help="run the row-partitioned engines' set instead of the dryrun (beside both with --full)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: one card per rank over NCCL (default); cpu: gloo")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds for the whole world")
    ap.add_argument("--log-dir", default=None, help="where each rank's output goes (default: a temporary directory)")
    ap.add_argument("--abort-rank", type=int, default=None,
                    help="the drill: this rank exits after the first collective, and the launch must fail")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # set by the launcher
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    try:
        records = launch(args.ranks, full=args.full, engines=args.engines, device=args.device, timeout=args.timeout,
                         log_dir=args.log_dir, abort_rank=args.abort_rank)
    except RuntimeError as e:
        print(str(e), file=sys.stderr, flush=True)
        return 1
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
