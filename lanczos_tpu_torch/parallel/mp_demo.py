"""Multi-process execution harness and demo (port of
``lanczos_tpu.parallel.mp_demo``).

One process per rank under ``torch.distributed``: each process runs the same
solve on its own slab of a row-partitioned operator, and the replicated
results (eigenvalues, the gathered eigenvector) come out bit-identical on
every rank.  This module is the proof harness (:func:`launch` spawns a
local world) and the template for a real launch: on a host with N cards run

    python -m lanczos_tpu_torch.parallel.mp_demo \\
        --coordinator HOST0:PORT --num-processes N --process-id I

once per card (I = 0 .. N-1; rank I runs on ``cuda:I`` over NCCL), or add
``--device cpu`` for gloo ranks on the CPU.  Each process prints one JSON
line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

__all__ = ["run_solves", "launch", "main"]


def run_solves(n: int = 512, pv_rows: int = 48, pv_restarts: int = 64) -> dict:
    """Solve the -1 hopping chain, a :class:`ShardedDIAOperator` over the
    world, with the hybrid engine; then its two lowest eigenvalues with
    ``precise_vectors`` over the float32 diagonals, in the fused engine and
    in the thick-restart engine under a ``pv_rows``-row cap (the JAX demo's
    precise part: the bounded-memory accuracy path over the same halos);
    returns the values and their errors.  Call after the process group is
    initialized."""
    import numpy as np
    import torch

    from ..api import LambdaLanczos
    from . import mesh as pmesh
    from .sharded import ShardedDIAOperator

    m = pmesh.make_mesh()
    op = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, m, dtype=torch.float64)
    eng = LambdaLanczos(op, find_maximum=False, mode="hybrid")
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-12
    val, vec = eng.run_one()
    exact = -2 * np.cos(np.pi / (n + 1))

    op32 = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, m, dtype=torch.float32)
    pv = LambdaLanczos(op32, find_maximum=False, num_eigs=2)
    pv.precise_vectors = True
    pv.eigenvalue_offset = -4.0
    pv.eps = 1e-12
    pv_vals, pv_vecs = pv.run()
    pv_exact = -2 * np.cos(np.pi * np.arange(1, 3) / (n + 1))

    thick = LambdaLanczos(op32, find_maximum=False, num_eigs=2)
    thick.eigenvalue_offset = -4.0
    thick.precise_vectors = True
    thick.restart_policy = "thick"
    thick.max_iteration = pv_rows
    thick.max_restarts = pv_restarts
    thick.eps = 1e-12
    thick_vals, _ = thick.run()
    thick_vals = np.sort(np.asarray(thick_vals))
    return {
        "stencil_val": float(val),
        "stencil_err": abs(float(val) - exact),
        "stencil_vec_sum": float(vec.double().sum()),
        "iteration_counts": eng.iteration_counts,
        "pv_vals": [float(v) for v in np.sort(np.asarray(pv_vals))],
        "pv_err": float(np.max(np.abs(np.sort(np.asarray(pv_vals)) - pv_exact))),
        "pv_vec_dtype": str(pv_vecs.dtype),
        "pv_iteration_counts": pv.iteration_counts,
        "pv_thick_vals": [float(v) for v in thick_vals],
        "pv_thick_err": float(np.max(np.abs(thick_vals - pv_exact))),
        "pv_thick_iteration_counts": thick.iteration_counts,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default="127.0.0.1:12321", help="HOST:PORT of rank 0's rendezvous")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: one card per rank over NCCL (default); cpu: gloo")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds for the rendezvous and each collective")
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from . import mesh as pmesh

    if args.device == "cuda":
        torch.cuda.set_device(args.process_id % torch.cuda.device_count())
    pmesh.initialize_distributed(
        backend="nccl" if args.device == "cuda" else "gloo",
        init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes,
        rank=args.process_id,
        timeout=datetime.timedelta(seconds=args.timeout),
    )
    try:
        out = run_solves(n=args.n)
        out.update(process_id=args.process_id, world_size=dist.get_world_size(), backend=str(dist.get_backend()))
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def launch(num_processes: int = 2, n: int = 512, *, device: str = "cuda", timeout: float = 300.0,
           port: int | None = None) -> list[dict]:
    """Spawn ``num_processes`` OS processes running :func:`main` against a
    local rendezvous and return each one's result dict, in rank order.

    ``device='cuda'`` puts rank i on card i (NCCL); ``device='cpu'`` runs
    gloo ranks on the CPU.  Every process is killed and the call raises when
    one fails or the world outlives ``timeout`` seconds."""
    if port is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "lanczos_tpu_torch.parallel.mp_demo", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes), "--process-id", str(i), "--device", device,
             "--timeout", str(timeout), "--n", str(n)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(num_processes)
    ]
    results, errors = [], []
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 0.0))
            if p.returncode != 0:
                errors.append(f"process {i} rc={p.returncode}\n{err[-2000:]}")
            else:
                results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("multi-process launch failed:\n" + "\n".join(errors))
    return results


if __name__ == "__main__":
    sys.exit(main())
