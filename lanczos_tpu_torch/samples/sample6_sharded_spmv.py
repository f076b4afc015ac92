"""A row-partitioned sparse Hamiltonian solved over a process group (port
of samples/sample6_sharded_spmv.py, the JAX package's sample with no
reference counterpart).

Without a launcher it runs as a world of one rank (gloo on the CPU, NCCL on
the card); under ``torchrun --nproc-per-node=K`` it takes the launcher's
world, one rank per card.

Run: ``python -m lanczos_tpu_torch.samples.sample6_sharded_spmv``.
"""

import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from lanczos_tpu_torch import LambdaLanczos, fixed_seed_initializer
from lanczos_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator
from lanczos_tpu_torch.samples import sample_device

device = sample_device()
backend = "nccl" if device.startswith("cuda") else "gloo"

n = 4096
i = np.arange(n - 1)
rows = np.concatenate([i, i + 1])
cols = np.concatenate([i + 1, i])
vals = np.full(2 * (n - 1), -1.0)

with tempfile.TemporaryDirectory() as rendezvous:
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # the launcher's world (env:// rendezvous)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        initialize_distributed(backend=backend)
    else:  # a world of one, met through a file (no store server thread to outlive it)
        if backend == "nccl":
            torch.cuda.set_device(torch.device(device).index or 0)
        initialize_distributed(backend=backend, init_method=f"file://{rendezvous}/store", world_size=1, rank=0,
                               timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        print(f"mesh: {mesh.size} devices")
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=torch.float64)

        # mode='auto': the fused engine on the card (the JAX sample's
        # mode='fused'), the hybrid one on the CPU, where the fused engine's
        # device-side check would run as its plain version.
        engine = LambdaLanczos(op, find_maximum=False, mode="auto")
        engine.eigenvalue_offset = -4.0
        # Cap the Krylov space: the default (= n) sizes the device buffers
        # for a worst case this well-conditioned problem never reaches.
        engine.max_iteration = 256
        # The budget, not eps, ends this gap-less chain's solve, so its
        # error follows the start vector: a seeded start (the JAX sample
        # draws a fresh one) makes the printed error the same every run.
        engine.init_vector = fixed_seed_initializer(torch.float64, seed=1)
        eigenvalue, eigenvector = engine.run_one()

        exact = -2 * np.cos(np.pi / (n + 1))
        print(f"Eigenvalue: {eigenvalue:.12g}")
        print(f"Exact:      {exact:.12g}")
        print(f"error eigenvalue: {abs(eigenvalue - exact):.3e}")
    finally:
        dist.destroy_process_group()
