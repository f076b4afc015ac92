"""One rank of a gloo world for tests/test_torch_sharded.py.

Run as ``python tests/torch_sharded_world.py RANK WORLD RENDEZVOUS_FILE
INPUTS.npz OUT.npz``: joins the world through the file rendezvous, runs
every multi-rank check of the port for that world size on this rank's slab
and writes what the test compares (global vectors, resolved modes, error
texts) to ``OUT.npz``.  It imports torch and the port, never JAX; the
problems come from the numpy functions below, which the test also hands to
the JAX package, and ``INPUTS.npz`` carries the JAX operators' packed
arrays for the converters.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np

# The comm modes of ShardedBSROperator and the patterns they run on; each
# problem is (rows, cols, vals, n, bm, bk).
COMMS = ("gather", "ring", "footprint", "auto")
SOLVE_N = 128  # chain of the sharded solves (the lowest value converges as the Krylov space fills)
SOLVE_SEEDS = {"bsr": 5, "dia": 3}
DIA_OFFSETS = (-3, -1, 0, 2)
DIA_N = 512


def _chain(n, diag=None):
    i = np.arange(n - 1)
    rows, cols, vals = [i, i + 1], [i + 1, i], [np.full(n - 1, -1.0)] * 2
    if diag is not None:
        rows.append(np.arange(n))
        cols.append(np.arange(n))
        vals.append(diag)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def patterns() -> dict:
    """Banded (ring-able), scattered (ring refused), chain plus a few
    long-range couplings (the footprint's case) and rectangular tiles."""
    n = 300
    band = (*_chain(n, 0.1 * np.arange(n)), n, 8, 8)
    rng = np.random.default_rng(1)
    scatter = (rng.integers(0, n, 200), rng.integers(0, n, 200), rng.standard_normal(200), n, 8, 8)
    n_long = 1024
    r, c, v = ([a] for a in _chain(n_long))
    for d, cnt in ((n_long // 2, 12), (n_long // 4, 8)):
        pos = rng.choice(n_long - d, cnt, replace=False)
        w = rng.standard_normal(cnt)
        r += [pos, pos + d]
        c += [pos + d, pos]
        v += [w, w]
    long = (np.concatenate(r), np.concatenate(c), np.concatenate(v), n_long, 8, 8)
    rect = (*_chain(200), 200, 64, 128)
    return {"band": band, "scatter": scatter, "long": long, "rect": rect}


def pattern_x(n: int) -> np.ndarray:
    return np.random.default_rng(7).standard_normal(n)


def dia_problem():
    rng = np.random.default_rng(9)
    return list(DIA_OFFSETS), [rng.standard_normal(DIA_N) for _ in DIA_OFFSETS], DIA_N


def pv_problem():
    """The precise solve's problem: the chain with a seeded potential, its
    values in float32 (rows, cols, vals, n, bm, bk)."""
    n = SOLVE_N
    pot = np.random.default_rng(4).uniform(0.0, 1.0, n)
    return (*_chain(n, pot), n, 8, 8)


PV_SEED = 5  # the precise solve's start vector (float32 draws)


def dense_problem():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 64))
    return (a + a.T) / 2


def _matvec_checks(mesh, inputs, out):
    import torch

    from lanczos_tpu_torch import convert
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator, ShardedDIAOperator

    for name, (rows, cols, vals, n, bm, bk) in patterns().items():
        x = torch.from_numpy(pattern_x(n))
        for comm in COMMS:
            key = f"{name}.{comm}"
            try:
                op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=torch.float64, comm=comm)
            except ValueError as e:
                out[f"{key}.raised"] = np.array(str(e))
                continue
            out[f"{key}.comm"] = np.array(op.comm)
            out[f"{key}.words"] = np.array(op.footprint_words)
            out[f"{key}.y"] = op.gather(op.matvec(op.scatter(x))).numpy()
            if f"{key}.blocks" in inputs:  # the JAX operator's arrays, through the converter
                op2 = convert.sharded_bsr_operator_from_arrays(inputs[f"{key}.blocks"], inputs[f"{key}.col_blocks"],
                                                               n, mesh, comm=comm)
                out[f"{key}.comm_from_arrays"] = np.array(op2.comm)
                out[f"{key}.y_from_arrays"] = op2.gather(op2.matvec(op2.scatter(x))).numpy()

    offsets, diags, n = dia_problem()
    x = torch.from_numpy(pattern_x(n))
    op = ShardedDIAOperator.from_diagonals(offsets, diags, n, mesh)
    out["dia.y"] = op.gather(op.matvec(op.scatter(x))).numpy()
    op2 = convert.sharded_dia_operator_from_arrays(inputs["dia.offsets"], inputs["dia.data"], n, mesh)
    out["dia.y_from_arrays"] = op2.gather(op2.matvec(op2.scatter(x))).numpy()


def solve_ops(mesh):
    """The two sharded stencils of the solves, by name."""
    import torch

    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator, ShardedDIAOperator

    n = SOLVE_N
    return {
        "bsr": ShardedBSROperator.from_coo(*_chain(n), n, mesh, dtype=torch.float64),
        "dia": ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, mesh),
    }


def _solve_checks(mesh, out):
    import lanczos_tpu_torch as tl

    for name, op in solve_ops(mesh).items():
        for mode in ("hybrid", "fused"):
            eng = tl.LambdaLanczos(op, find_maximum=False, mode=mode)
            eng.eigenvalue_offset = -4.0
            eng.eps = 1e-12
            eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=SOLVE_SEEDS[name])
            val, vec = eng.run_one()
            key = f"solve.{name}.{mode}"
            out[f"{key}.val"] = np.array(val)
            out[f"{key}.vec"] = vec.numpy()
            out[f"{key}.iters"] = np.array(eng.iteration_counts)
            out[f"{key}.residual"] = np.array(eng.residuals([val], vec[None])[0])


def _api_checks(mesh, out):
    import torch

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import shard_operator

    a = dense_problem()
    op = shard_operator(tl.DenseOperator(a, device="cpu"), mesh)
    eng = tl.LambdaLanczos(op, find_maximum=True)
    eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=42)
    val, vec = eng.run_one()
    out["dense.val"] = np.array(val)
    out["dense.residual"] = np.array(np.linalg.norm(a @ vec.numpy() - val * vec.numpy()))
    try:
        shard_operator(tl.BSROperator.from_coo(*_chain(16), 16, bm=8, bk=8, dtype=torch.float64, device="cpu"), mesh)
    except TypeError as e:
        out["dense.bsr_refused"] = np.array(str(e))

    # Fresh draws: the same vector on every rank, a new one per call.
    init = tl.random_initializer(np.float64)
    out["seed.draws"] = np.stack([init(16), init(16)])

    # A second initialization is a no-op, whatever it is given.
    pmesh.initialize_distributed(backend="gloo", init_method="tcp://127.0.0.1:1", world_size=99, rank=98)
    out["noop.world"] = np.array(pmesh.make_mesh().size)

    ops = solve_ops(mesh)
    for name, attrs in (("thick", {"restart_policy": "thick"}), ("block", {"block_size": 2}),
                        ("precise_thick", {"precise_vectors": True, "restart_policy": "thick"})):
        eng2 = tl.LambdaLanczos(ops["bsr"], num_eigs=2)
        for attr, value in attrs.items():
            setattr(eng2, attr, value)
        try:
            eng2.run()
        except NotImplementedError as e:
            out[f"refused.{name}"] = np.array(str(e))
    try:
        tl.filtered_lanczos(ops["dia"], degree=32, mu=0.05, lo=-2.0, hi=2.0)
    except NotImplementedError as e:
        out["refused.filtered"] = np.array(str(e))
    # precise_vectors (ROADMAP item 10) on float32 slabs: the fused engine
    # over a float64 slab basis and the sharded float64 product.
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    rows, cols, vals, n, bm, bk = pv_problem()
    pv_op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=torch.float32)
    eng = tl.LambdaLanczos(pv_op, find_maximum=False, num_eigs=2)
    eng.precise_vectors = True
    eng.eps = 1e-12
    eng.init_vector = tl.fixed_seed_initializer(np.float32, seed=PV_SEED)
    vals_pv, vecs_pv = eng.run()
    out["pv.vals"] = np.asarray(vals_pv)
    out["pv.vecs"] = vecs_pv.numpy()
    out["pv.iters"] = np.array(eng.iteration_counts)
    x = torch.from_numpy(pattern_x(n))
    out["pv.y64"] = pv_op.gather(pv_op.matvec_f64(pv_op.scatter(x))).numpy()


def main(argv) -> int:
    rank, world, rendezvous, inputs_path, out_path = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    import torch.distributed as dist

    from lanczos_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    pmesh.initialize_distributed(backend="gloo", init_method=f"file://{rendezvous}", world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = pmesh.make_mesh()
        with np.load(inputs_path) as f:
            inputs = {k: f[k] for k in f.files}
        _matvec_checks(mesh, inputs, out)
        if world == 4:
            _solve_checks(mesh, out)
        else:
            _api_checks(mesh, out)
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
