"""Initial-vector generators (port of ``lanczos_tpu.utils.random``;
reference VectorRandomInitializer, lambda_lanczos.hpp:70-104).

The reference draws every element uniformly from [-1, 1] (real and imaginary
parts for complex types) from a fresh engine on every call, so the default
is a new vector per restart; its tests use a fixed-seed generator that gives
the same vector on each call (test/lambda_lanczos_test.cpp:25-45).  Both are
reproduced here.  Draws come from a ``numpy.random.Generator`` and are numpy
arrays: the solver moves them to the operator's device, and the same seed
gives the same vector as the JAX package.  Under ``torch.distributed`` the
fresh draws are the same on every rank of a group, the operator's draw
group in a solve (:func:`_fresh_rng`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import is_complex_dtype, to_numpy_dtype

__all__ = ["random_initializer", "fixed_seed_initializer"]


def _draw(rng: np.random.Generator, n: int, dtype) -> np.ndarray:
    dtype = to_numpy_dtype(dtype)
    if is_complex_dtype(dtype):
        r = rng.uniform(-1.0, 1.0, size=n)
        i = rng.uniform(-1.0, 1.0, size=n)
        return (r + 1j * i).astype(dtype)
    return rng.uniform(-1.0, 1.0, size=n).astype(dtype)


_WORLD = object()  # the default group: the whole world, when one is initialized


def _fresh_rng(group=_WORLD) -> np.random.Generator:
    """A fresh-entropy generator that is the same on every rank of ``group``.

    Every rank of a row-partitioned solve runs the same engine and draws the
    same full-length start vector, keeping its own slab of it; a per-rank
    draw would give each rank a slab of a different vector.  So the entropy
    of ``group``'s first rank is broadcast over ``group``, as the JAX package
    broadcasts process 0's (lanczos_tpu/utils/random.py:30-50): each call
    still gives a new vector, the same one on all of them.  The engines pass
    the operator's draw group
    (:func:`lanczos_tpu_torch.parallel.sharded.draw_group`): the ranks of
    one solve and no others, so solves that run side by side over their own
    groups (the slices of a grid) draw as often as each needs, and ``None``
    (an operator on one device) draws locally.  Left out, ``group`` is the
    whole world when a process group is initialized."""
    if group is _WORLD:
        group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if group is not None and dist.get_world_size(group) > 1:
        nccl = "nccl" in str(dist.get_backend(group))
        dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        seed = torch.tensor([np.random.SeedSequence().entropy & ((1 << 63) - 1)], dtype=torch.int64, device=dev)
        dist.broadcast(seed, src=dist.get_process_group_ranks(group)[0], group=group)
        return np.random.default_rng(int(seed.item()))
    return np.random.default_rng()


def random_initializer(dtype, group=_WORLD):
    """Fresh-entropy uniform [-1, 1] init, a new draw every call (the
    reference default, lambda_lanczos.hpp:79-88), the same on every rank of
    ``group`` (:func:`_fresh_rng`; by default the whole world)."""

    def init(n: int) -> np.ndarray:
        return _draw(_fresh_rng(group), n, dtype)

    return init


def fixed_seed_initializer(dtype, seed: int = 1):
    """Deterministic init: a fresh generator with the same seed every call,
    so every restart sees the same vector (test/lambda_lanczos_test.cpp:25-45)."""

    def init(n: int) -> np.ndarray:
        return _draw(np.random.default_rng(seed), n, dtype)

    return init
