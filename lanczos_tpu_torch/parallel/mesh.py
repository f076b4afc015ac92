"""Process groups and row slabs (port of ``lanczos_tpu.parallel.mesh``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and lets
GSPMD place every array and insert every collective.  The PyTorch idiom is
one process per device under ``torch.distributed`` (NCCL between CUDA cards,
gloo on the CPU): each rank holds its own slab and every collective is
written out.  So the mesh here is a small record of the group, this rank's
place in it and its device, and a vector of length ``n_pad`` is split into
``size`` equal, contiguous slabs, rank ``r`` owning rows
``[r * n_pad / size, (r + 1) * n_pad / size)``.

Bootstrap each process with :func:`initialize_distributed` (the arguments of
``torch.distributed.init_process_group``: backend, ``init_method``,
``world_size``, ``rank``, ``timeout``) before :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = [
    "RowMesh",
    "initialize_distributed",
    "make_mesh",
    "pad_to_multiple",
    "shard_vector",
    "gather_vector",
    "all_gather",
]


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One process group laid out as a row of slabs: ``rank`` of ``size``,
    with its tensors on ``device``."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``, or nothing when a
    process group is already initialized.

    A failed rendezvous (nothing listening, a timeout, a mismatched world
    size) raises: it is never taken for "already initialized", which would
    leave the process running alone on its local slab."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)


def make_mesh(group=None) -> RowMesh:
    """The row mesh of ``group`` (default: the whole world).  Under NCCL the
    device is ``cuda:<local rank>`` (``LOCAL_RANK`` when the launcher sets
    it, else the rank modulo the cards on the host); under gloo it is the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed(...) before make_mesh()")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if "nccl" in str(dist.get_backend(group)):
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    return RowMesh(group, rank, size, device)


def pad_to_multiple(n: int, mesh: RowMesh, lane: int = 128) -> int:
    """Smallest n' >= n divisible by ``size * lane``: every slab the same
    whole number of lanes."""
    q = mesh.size * lane
    return -(-n // q) * q


def all_gather(x_local, mesh: RowMesh):
    """The slabs of every rank, concatenated in rank order (equal, contiguous
    chunks, as NCCL's single-tensor all-gather needs)."""
    out = torch.empty((mesh.size * x_local.shape[0], *x_local.shape[1:]), dtype=x_local.dtype, device=x_local.device)
    # all_gather_single is the newer name of all_gather_into_tensor (same
    # arguments); older PyTorch has only the latter.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x_local.contiguous(), group=mesh.group)
    return out


def shard_vector(x, mesh: RowMesh, n_pad: int | None = None):
    """This rank's slab of the global vector ``x``, zero-padded to ``n_pad``
    (default ``len(x)``, which must then divide evenly), on the mesh's
    device."""
    x = torch.as_tensor(x, device=mesh.device)
    n_pad = x.shape[0] if n_pad is None else int(n_pad)
    if n_pad % mesh.size or n_pad < x.shape[0]:
        raise ValueError(f"{n_pad} padded rows do not hold a vector of {x.shape[0]} in {mesh.size} equal slabs")
    nl = n_pad // mesh.size
    lo = mesh.rank * nl
    out = torch.zeros(nl, dtype=x.dtype, device=mesh.device)
    hi = min(lo + nl, x.shape[0])
    if hi > lo:
        out[: hi - lo] = x[lo:hi]
    return out


def gather_vector(x_local, mesh: RowMesh, n: int | None = None):
    """The global vector from every rank's slab, trimmed to ``n`` rows
    (default: all of them); the same on every rank."""
    full = all_gather(x_local, mesh)
    return full if n is None else full[:n]
