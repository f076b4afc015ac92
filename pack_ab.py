#!/usr/bin/env python3
"""Times ``ShardedBSROperator.from_coo`` of the complex main path's operator
over a world of ranks for one checkout of lanczos_tpu_torch, and reports
each rank's host memory around it, so that two commits can be compared on
the same cards: ``python3 pack_ab.py --root DIR [--ranks 4] [--comm
gather|auto] [--n N] [--device cuda|cpu]``.

DIR holds the checkout (``.`` for this one, or a parent commit unpacked by
``git archive`` into a git-ignored directory); its ``lanczos_tpu_torch``
is imported from there.  Each rank is a fresh process (rank i on card i,
NCCL; gloo with ``--device cpu``) that builds the gauge chain's COO
(``parallel.engine_set.gauge_chain(n)``, n = 2**20 by default: 3.22 GB of
complex64 tiles in all) and packs it once with ``comm``.  Rank 0 prints one
JSON line: per rank the pack's seconds (to the operator's tiles on the
device), the peak host RSS in GB (``ru_maxrss``, the process's lifetime
peak) before the COO, after it and after the pack, the resolved comm and
the rank's tile shape; with the card's name and power limit from
``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

_RANK = r"""
import datetime, json, resource, sys, time
import numpy as np, torch, torch.distributed as dist
from lanczos_tpu_torch.parallel import mesh as pmesh
from lanczos_tpu_torch.parallel.engine_set import gauge_chain
from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

rank, ranks, init, device, comm, n = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
                                      int(sys.argv[6]))
def peak_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
if device == "cuda":
    torch.cuda.set_device(rank)
pmesh.initialize_distributed(backend="nccl" if device == "cuda" else "gloo", init_method=init, world_size=ranks,
                             rank=rank, timeout=datetime.timedelta(seconds=600))
mesh = pmesh.make_mesh()
dist.barrier()
before = peak_gb()
rows, cols, cvals, _phi, _mags = gauge_chain(n)
coo = peak_gb()
t0 = time.perf_counter()
op = ShardedBSROperator.from_coo(rows, cols, cvals, n, mesh, bm=128, bk=128, dtype=torch.complex64, comm=comm)
if device == "cuda":
    torch.cuda.synchronize()
pack_s = time.perf_counter() - t0
rec = torch.tensor([pack_s, before, coo, peak_gb()], dtype=torch.float64, device=mesh.device)
recs = [torch.zeros_like(rec) for _ in range(ranks)]
dist.all_gather(recs, rec)
if rank == 0:
    recs = [r.tolist() for r in recs]
    print(json.dumps({"phase": "pack_ab", "n": n, "ranks": ranks, "comm_requested": comm, "comm": op.comm,
                      "tiles_per_rank": list(op.blocks.shape), "dtype": str(op.blocks.dtype),
                      "pack_s_by_rank": [r[0] for r in recs], "peak_host_rss_gb_before_coo": [r[1] for r in recs],
                      "peak_host_rss_gb_after_coo": [r[2] for r in recs],
                      "peak_host_rss_gb_after_pack": [r[3] for r in recs]}), flush=True)
dist.destroy_process_group()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=".", help="the checkout whose lanczos_tpu_torch is measured")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--comm", choices=["gather", "ring", "footprint", "auto"], default="gather")
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // args.ranks)))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(args.ranks), f"tcp://127.0.0.1:{port}",
                               args.device, args.comm, str(args.n)], env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(args.ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(f"--- rank {r} rc={p.returncode}\n{out[-3000:]}", file=sys.stderr)
        return 1
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    if args.device == "cuda":
        try:
            rec["cards"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                          capture_output=True, text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            rec["cards"] = f"nvidia-smi failed: {e}"
    rec["root"] = args.root
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
