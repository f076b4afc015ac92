"""Checkpoint and resume for long solves (port of
``lanczos_tpu.utils.checkpoint``).

The reference has no checkpointing (its engines keep no state between
``run()`` calls).  The natural boundary is between deflated restarts: the
state there is exactly the accepted eigenpairs (the
:class:`~lanczos_tpu_torch.solvers.lanczos.EigenPairManager` content) and
the iteration counts.  Everything inside one restart is rebuilt quickly;
everything across restarts is the accumulated matvecs.

The format is the JAX package's, so a file either package writes loads in
the other: one ``.npz`` with ``format_version`` (1), ``eigenvalues``
(float64), ``eigenvectors`` (one row per pair, ``(0, 0)`` when empty),
``find_maximum``, ``num_eigs``, ``iteration_counts`` (int64) and the
caller's ``extra_<name>`` fields, written to a temporary file and renamed
into place.

A run over a row-partitioned operator writes the same file: every rank
gathers the eigenvectors to the global n, rank 0 writes, and the group
waits for it; a load gives every rank its slabs of the global rows.  So a
file written by a run on some number of ranks resumes on any other, one
process included.  (The JAX package's ``compile_cache`` is an XLA executable cache
and has no counterpart here.)
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import to_torch_dtype
from ..ops.operators import resolve_device

__all__ = ["save_state", "load_state", "CheckpointedRun", "npz_path"]

_FORMAT_VERSION = 1


def npz_path(path) -> str:
    """``np.savez`` appends '.npz' to a path without it; save, load and the
    existence test all use the name on disk."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path, manager, iteration_counts, *, extra: dict | None = None, sharded=None) -> None:
    """Write the deflation state of a run (the EigenPairManager content);
    the eigenvectors come to the host from whatever device holds them.
    ``sharded`` is the run's row-partitioned operator, if it is one: the
    manager holds slabs, every rank of its group calls this, the global
    rows are gathered, rank 0 writes and the group waits for the file."""
    vals = np.asarray(manager.eigenvalues(), dtype=np.float64)
    rows = manager.eigenvectors()
    if sharded is not None:
        rows = [sharded.gather(v) for v in rows]
    vecs = (
        np.stack([v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in rows])
        if manager.pairs
        else np.zeros((0, 0))
    )
    if sharded is None or sharded.mesh.rank == 0:
        _write(path, vals, vecs, manager, iteration_counts, extra)
    if sharded is not None:
        dist.barrier(group=sharded.group)


def _write(path, vals, vecs, manager, iteration_counts, extra) -> None:
    target = npz_path(path)
    # Atomic write: a crash inside savez must not leave a truncated file
    # that blocks every later resume.
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(target) or ".")
    os.close(fd)
    try:
        np.savez(
            tmp[:-4],  # savez appends .npz again
            format_version=_FORMAT_VERSION,
            eigenvalues=vals,
            eigenvectors=vecs,
            find_maximum=np.asarray(manager.find_maximum),
            num_eigs=np.asarray(manager.num_eigs),
            iteration_counts=np.asarray(iteration_counts, dtype=np.int64),
            **{f"extra_{k}": np.asarray(v) for k, v in (extra or {}).items()},
        )
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path, dtype=None, *, device=None, with_finished: bool = False, with_extras: bool = False,
               sharded=None):
    """Read a checkpoint -> (manager, iteration_counts[, finished][, extras]).

    The eigenvectors become tensors of ``dtype`` (default: as stored) on
    ``device`` (default: the card); with ``sharded`` (a row-partitioned
    operator) each is this rank's slab of the stored global row, on the
    operator's device.  ``finished`` says whether the saved
    run had reached the deflation fixed point (False for a file without
    the flag); ``extras`` is every ``extra_*`` field as a dict of numpy
    values (the filtered solve keeps its round state there).
    """
    from ..solvers.lanczos import EigenPairManager

    device = sharded.device if sharded is not None else resolve_device(device)
    with np.load(npz_path(path)) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than this library")
        manager = EigenPairManager(bool(z["find_maximum"]), int(z["num_eigs"]))
        vals = z["eigenvalues"]
        vecs = z["eigenvectors"]
        for i in range(vals.shape[0]):
            v = torch.as_tensor(vecs[i], device=device)
            if sharded is not None:
                v = sharded.scatter(v)
            manager.insert([float(vals[i])], [v.to(to_torch_dtype(dtype)) if dtype is not None else v])
        counts = [int(c) for c in z["iteration_counts"]]
        finished = bool(z["extra_finished"]) if "extra_finished" in z else False
        extras = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    out = [manager, counts]
    if with_finished:
        out.append(finished)
    if with_extras:
        out.append(extras)
    return tuple(out)


class CheckpointedRun:
    """Drive a :class:`~lanczos_tpu_torch.api.LambdaLanczos` with a
    checkpoint after every deflated restart; a run resumes from the file
    when it exists.

    >>> run = CheckpointedRun(engine, "state.npz")
    >>> eigenvalues, eigenvectors = run.run()
    """

    def __init__(self, engine, path):
        self.engine = engine
        self.path = path

    def run(self):
        from ..parallel.sharded import ShardedOperator
        from ..solvers import lanczos as _lanczos

        eng = self.engine
        sharded = eng.operator if isinstance(eng.operator, ShardedOperator) else None
        dev = eng.operator.device
        cfg = eng._config().resolved(eng.dtype)

        if os.path.exists(npz_path(self.path)):
            manager, iter_counts, finished = load_state(self.path, eng.dtype, device=dev, with_finished=True,
                                                        sharded=sharded)
            if finished:
                # The saved run reached the deflation fixed point (it ended
                # between the last save and run() returning): return the
                # stored result instead of one more deflated restart.
                eng._iteration_counts = iter_counts
                vals = np.asarray(manager.eigenvalues())
                rows = manager.eigenvectors()
                if sharded is not None:
                    rows = [sharded.gather(v) for v in rows]
                vecs = (
                    torch.stack(rows)
                    if manager.pairs
                    else torch.zeros((0, eng.matrix_size), dtype=eng.dtype, device=dev)
                )
                return vals, vecs
        else:
            manager, iter_counts = None, None

        # The engine run() would pick (fused, hybrid, thick, block), from
        # the one dispatch point.
        iterate_one, v0_rows, use_warm = eng._iterate_factory(cfg)
        result = _lanczos.deflation_driver(
            iterate_one, cfg, eng._init_fn(), eng.dtype, device=dev,
            v0_rows=v0_rows, use_warm_restarts=use_warm,
            manager=manager, iter_counts=iter_counts, sharded=sharded,
            after_round=lambda mgr, counts, fin: save_state(self.path, mgr, counts, extra={"finished": fin},
                                                            sharded=sharded),
        )
        eng._iteration_counts = result.iteration_counts
        return result.eigenvalues, result.eigenvectors
