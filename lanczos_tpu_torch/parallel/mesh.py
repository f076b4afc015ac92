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

The JAX package's 2-D meshes, a ``(slices, rows)`` multislice mesh and a
``(rows, cols)`` tensor-parallel mesh laid out by GSPMD, are here a
:class:`GridMesh`: a grid of ``torch.distributed`` subgroups, one per row
and one per column of the grid, from :func:`make_multislice_mesh`.  NVLink
inside a host takes the place of ICI and the network between hosts that of
DCN.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = [
    "RowMesh",
    "GridMesh",
    "initialize_distributed",
    "make_mesh",
    "make_multislice_mesh",
    "pad_to_multiple",
    "shard_vector",
    "shard_dense_operator",
    "shard_dense_operator_2d",
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


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """The ranks of a process group laid out as a ``(slices, rows)`` grid,
    slice-major: the rank ``r`` of ``world`` sits at ``(r // rows, r %
    rows)``.

    ``rows_mesh`` is the row mesh of this rank's slice (its ``rows`` ranks:
    the per-iteration collectives of a solve sharded inside one slice),
    ``slices_mesh`` that of the ranks with this rank's row index (one per
    slice), and ``combined`` the row mesh of the whole grid in slice-major
    order, the JAX package's combined ``("slices", "rows")`` axis: an
    operator built on it splits n over every rank.  Laid out slice-major,
    that order is ``world``'s own, so ``combined`` is ``world``."""

    world: RowMesh
    shape: tuple  # (slices, rows)
    coords: tuple  # this rank's (slice, row)
    rows_mesh: RowMesh
    slices_mesh: RowMesh

    @property
    def combined(self) -> RowMesh:
        return self.world


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
    it, else the rank modulo the cards on the host), made the current
    device: NCCL's batched point-to-point transfers and the seed broadcast
    of ``utils/random.py`` run on the current device, and a rank that left
    it at card 0 would put them there.  Set it before
    :func:`initialize_distributed` as well (``torch.cuda.set_device``), as
    ``multichip`` and ``mp_demo`` do.  Under gloo the device is the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed(...) before make_mesh()")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if "nccl" in str(dist.get_backend(group)):
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    return RowMesh(group, rank, size, device)


def make_multislice_mesh(num_slices: int | None = None, group=None) -> GridMesh:
    """The ``(slices, rows)`` grid of ``group`` (default: the whole world).

    ``num_slices`` defaults to the number of hosts, ``world_size //
    LOCAL_WORLD_SIZE`` when the launcher sets ``LOCAL_WORLD_SIZE`` (else
    1): the counterpart of the JAX package's slice count from the devices'
    ``slice_index``, so that a slice's ``rows`` ranks share a host's NVLink.
    Raises ``ValueError`` when the group's ranks do not split into
    ``num_slices`` equal slices.

    Every rank of the world calls it: it creates the subgroups of every
    slice and every row index in the same order on each rank, as
    ``torch.distributed.new_group`` requires of every rank of the default
    group.  So ``group``, when given, must hold every rank of the world."""
    world = make_mesh(group)
    if world.size != dist.get_world_size():
        raise ValueError(f"the grid's group holds {world.size} of the world's {dist.get_world_size()} ranks; "
                         "every rank of the world takes part in creating its subgroups")
    if num_slices is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world.size))
        if per_host < 1 or world.size % per_host:
            raise ValueError(f"{world.size} ranks do not split into hosts of LOCAL_WORLD_SIZE={per_host}")
        num_slices = world.size // per_host
    num_slices = int(num_slices)
    if num_slices < 1 or world.size % num_slices:
        raise ValueError(f"{world.size} ranks do not split into {num_slices} equal slices")
    rows = world.size // num_slices
    ranks = [dist.get_global_rank(world.group, r) for r in range(world.size)]
    slices_of = [ranks[s * rows:(s + 1) * rows] for s in range(num_slices)]
    rows_of = [ranks[r::rows] for r in range(rows)]
    s, r = divmod(world.rank, rows)
    row_groups = [dist.new_group(members) for members in slices_of]
    slice_groups = [dist.new_group(members) for members in rows_of]
    return GridMesh(world, (num_slices, rows), (s, r), _sub_mesh(row_groups[s], world.device),
                    _sub_mesh(slice_groups[r], world.device))


def _sub_mesh(group, device) -> RowMesh:
    return RowMesh(group, dist.get_rank(group), dist.get_world_size(group), device)


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


def shard_dense_operator(a, mesh: RowMesh):
    """Row-partition a dense operator over ``mesh``: a
    :class:`~lanczos_tpu_torch.parallel.sharded.ShardedDenseOperator`, each
    rank holding its row slab and all-gathering the input of every matvec
    (the JAX package's ``P('rows', None)`` placement)."""
    from .sharded import ShardedDenseOperator

    return ShardedDenseOperator.from_dense(a, mesh)


def shard_dense_operator_2d(a, grid: GridMesh):
    """Split a dense operator over a ``(rows, cols)`` grid: a
    :class:`~lanczos_tpu_torch.parallel.sharded.ShardedDenseOperator2D`,
    rank ``(i, j)`` holding the block ``A[I_i, J_j]`` and summing its
    partial products over the ranks ``(i, .)`` (the JAX package's
    ``P('rows', 'cols')`` placement).  Build the grid with
    :func:`make_multislice_mesh`, its first axis the row blocks."""
    from .sharded import ShardedDenseOperator2D

    return ShardedDenseOperator2D.from_dense(a, grid)
