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
import json
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
# dryrun_multichip's regimes the worlds leave out: 9 (the precise filtered
# solve, held here by the "filtered_precise" engine case) and 11 (the demo,
# held by test_mp_demo_two_ranks), ~8 s each over two gloo ranks.
DRYRUN_SKIP = (9, 11)


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


BF16_N = 256


def bf16_problem():
    """The bfloat16 solve's problem: the chain with a seeded potential
    (its tiles stored in bfloat16, its vectors float32)."""
    return (*_chain(BF16_N, np.random.default_rng(0).random(BF16_N)), BF16_N)


def bf16_solve(op):
    """The three lowest eigenvalues of ``op`` (bfloat16 tiles) by the fused
    engine over float32 vectors at eps 1e-6, from a fixed start."""
    import torch

    import lanczos_tpu_torch as tl

    eng = tl.LambdaLanczos(op, num_eigs=3, dtype=torch.float32, mode="fused")
    eng.eps = 1e-6
    eng.init_vector = tl.fixed_seed_initializer(np.float32, seed=11)
    return np.asarray(eng.run()[0]), np.array(eng.iteration_counts)


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


# ------------------------------------------------ engines over row slabs
#
# Every engine on a small gapped problem (``small_problem``: a few dozen
# iterations each, thick restarts forced by a 12-row cap), run by both
# worlds; and the JAX package's own sharded engine tests' cases, run by the
# 2-rank world only (``JAX_CASES``): tests/test_sharded.py:201 (expm),
# :227 (complex DIA), :364 (pv thick, BSR), :398 (precise filtered), :417
# (Chebyshev propagator), tests/test_block_lanczos.py:93 (block),
# tests/test_block_thick.py:236 (block thick) and
# tests/test_precise_thick.py:182 (pv thick, DIA).  Those take hundreds of
# iterations, thousands of small all-reduces, which a 4-rank gloo world
# on a loaded machine cannot finish inside its timeout.  Each problem is
# numpy; the parent runs the same cases through the port in one process
# (and the JAX cases through the JAX engines).

ENGINE_N = 256
SMALL_N = 128
EXPM_N = 128
FILTER_N = 1024
SMALL_FILTER_N = 256
CHEBY_N = 512
BLOCK_THICK_N = 512
JAX_CASES = ("pv_thick.bsr", "pv_thick.dia", "block.dia", "block_thick.dia", "filtered_precise")
EXPM_JAX_KEYS = ("expm.run_complex", "expm.run_complex.iters", "expm.cheby_f32", "expm.cheby_precise")


def chain_exact(n, k):
    return np.array([-2.0 * np.cos((j + 1) * np.pi / (n + 1)) for j in range(k)])


def small_problem():
    """The engines' small problem: the n = 128 chain with a potential
    uniform in [0, 1) from default_rng(4) and two deep sites (-3, -2.5),
    whose two bound states converge in a few dozen iterations; returns
    (potential, off-diagonal, dense)."""
    n = SMALL_N
    pot = np.random.default_rng(4).uniform(0.0, 1.0, n)
    pot[[n // 4, 3 * n // 4]] = [-3.0, -2.5]
    off = np.full(n, -1.0)
    return pot, off, np.diag(pot) + np.diag(off[: n - 1], 1) + np.diag(off[: n - 1], -1)


def complex_hops(n=EXPM_N):
    """tests/test_sharded.py:227's complex Hermitian chain: A[i, i+1] = t_i,
    A[i+1, i] = conj(t_i); returns (upper, lower) diagonals and the dense
    matrix."""
    rng = np.random.default_rng(12)
    t = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    upper = np.zeros(n, complex)
    upper[: n - 1] = t[: n - 1]
    lower = np.zeros(n, complex)
    lower[1:] = np.conj(t[: n - 1])
    i = np.arange(n - 1)
    dense = np.zeros((n, n), complex)
    dense[i, i + 1] = t[: n - 1]
    dense[i + 1, i] = np.conj(t[: n - 1])
    return upper, lower, dense


def block_thick_problem(n=BLOCK_THICK_N):
    """tests/test_block_thick.py:236's tridiagonal: main linspace(0, 6),
    off-diagonals -1; (main, off, dense)."""
    main = np.linspace(0.0, 6.0, n)
    off = np.full(n, -1.0)
    return main, off, np.diag(main) + np.diag(off[: n - 1], 1) + np.diag(off[: n - 1], -1)


def advancing_initializer(seed=2024):
    """tests/test_block_thick.py's init: a per-call-distinct draw from one
    advancing generator (the same on every rank)."""
    rng = np.random.default_rng(seed)
    return lambda n: rng.uniform(-1.0, 1.0, n)


def expm_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return v / np.linalg.norm(v)


def run_engines(make_dia, make_bsr, out, checkpoint_dir=None, jax_cases=True):
    """Every engine case on operators from ``make_dia(offsets, diagonals, n,
    dtype)`` and ``make_bsr(rows, cols, vals, n, dtype)`` (row-partitioned
    over the world, or the port's one-device operators on the CPU), into
    ``out``: values, gathered vectors, iteration counts, residuals;
    ``jax_cases`` adds the JAX tests' cases (``JAX_CASES`` and the
    Exponentiator's)."""
    import torch

    import lanczos_tpu_torch as tl

    f64, f32 = torch.float64, torch.float32

    def chain_dia(m, dtype=f64):
        return make_dia([-1, 1], [np.full(m, -1.0)] * 2, m, dtype)

    def solve(key, op, num_eigs, **attrs):
        eng = tl.LambdaLanczos(op, find_maximum=attrs.pop("find_maximum", False), num_eigs=num_eigs,
                               mode=attrs.pop("mode", "auto"))
        for k, v in attrs.items():
            setattr(eng, k, v)
        vals, vecs = eng.run()
        out[f"{key}.vals"] = np.asarray(vals)
        out[f"{key}.vecs"] = vecs.cpu().numpy()
        out[f"{key}.iters"] = np.asarray(eng.iteration_counts)
        out[f"{key}.res"] = np.asarray(eng.residuals(vals, vecs))

    pot, off, _dense = small_problem()
    n = SMALL_N

    def small_dia(dtype):
        return make_dia([-1, 0, 1], [off, pot, off], n, dtype)

    def small_bsr(dtype):
        return make_bsr(*_chain(n, pot), n, dtype)

    # two roots, no confirming round; a 12-row cap forces thick restarts
    small = dict(num_eigs_per_iteration=2, stop_when_full=True, max_restarts=64, eps=1e-12)
    thick = dict(small, restart_policy="thick", max_iteration=12, init_vector=tl.fixed_seed_initializer(np.float64, 3))
    solve("eng.thick_hybrid.small", small_dia(f64), 2, mode="hybrid", **thick)
    solve("eng.thick_fused.small", small_bsr(f64), 2, mode="fused", **thick)
    solve("eng.pv_thick.small", small_bsr(f32), 2, **dict(thick, precise_vectors=True,
                                                          init_vector=tl.fixed_seed_initializer(np.float32, 11)))
    solve("eng.block.small", small_dia(f64), 2, block_size=2, **dict(small, init_vector=tl.fixed_seed_initializer(
        np.float64, 8)))
    bt = dict(small, block_size=2, restart_policy="thick", max_iteration=12)
    solve("eng.block_thick.small", small_dia(f64), 2, **bt, init_vector=advancing_initializer())
    solve("eng.pv_block_thick.small", small_dia(f32), 2, precise_vectors=True, **bt,
          init_vector=advancing_initializer(5))

    upper, lower, _dense = complex_hops()
    cdia = make_dia([1, -1], [upper, lower], EXPM_N, torch.complex128)
    solve("eng.complex.dia", cdia, 1, find_maximum=True, init_vector=tl.fixed_seed_initializer(np.complex128, seed=5))
    i = np.arange(EXPM_N - 1)
    cbsr = make_bsr(np.concatenate([i, i + 1]), np.concatenate([i + 1, i]),
                    np.concatenate([upper[: EXPM_N - 1], lower[1:]]), EXPM_N, torch.complex128)
    solve("eng.complex.bsr", cbsr, 1, find_maximum=True, init_vector=tl.fixed_seed_initializer(np.complex128, seed=5))
    up48, lo48, _dense = complex_hops(48)
    i = np.arange(47)
    solve("eng.complex_block_thick.small", make_bsr(np.concatenate([i, i + 1]), np.concatenate([i + 1, i]),
                                                    np.concatenate([up48[:47], lo48[1:]]), 48, torch.complex128), 3,
          block_size=3, restart_policy="thick", max_iteration=24, eps=1e-12, max_restarts=32,
          init_vector=advancing_initializer(7))

    vals, vecs, info = tl.filtered_lanczos(chain_dia(SMALL_FILTER_N, f32), num_eigs=2, lo=-2.0, hi=2.0, precise=True)
    out["eng.filtered_precise.small.vals"] = np.asarray(vals)
    out["eng.filtered_precise.small.vecs"] = np.asarray(vecs)
    vals, vecs, info = tl.filtered_lanczos(chain_dia(CHEBY_N), num_eigs=2, sigma=0.3, lo=-2.0, hi=2.0, mu=1e-3,
                                           precise=True)
    out["eng.filtered_sigma.vals"] = np.asarray(vals)
    out["eng.filtered_sigma.vecs"] = np.asarray(vecs)
    if checkpoint_dir is not None:
        path = f"{checkpoint_dir}/filtered_ck.npz"
        runs = [tl.filtered_lanczos(chain_dia(CHEBY_N), num_eigs=3, degree=64, mu=0.05, lo=-2.0, hi=2.0,
                                    checkpoint_path=path)[0] for _ in range(2)]
        out["eng.filtered_checkpoint.vals"] = np.stack(runs)
    _expm_methods(make_dia, out, jax_cases)
    if not jax_cases:
        return

    m = ENGINE_N
    pv = dict(precise_vectors=True, restart_policy="thick", max_iteration=40, max_restarts=64, eps=1e-11,
              eigenvalue_offset=-4.0, mode="fused", init_vector=tl.fixed_seed_initializer(np.float32, seed=11))
    solve("eng.pv_thick.bsr", make_bsr(*_chain(m), m, f32), 1, **pv)
    solve("eng.pv_thick.dia", chain_dia(m, f32), 1, **pv)
    solve("eng.block.dia", chain_dia(m), 2, block_size=2, eigenvalue_offset=-4.0,
          init_vector=tl.fixed_seed_initializer(np.float64, seed=8))
    main, boff, _dense = block_thick_problem()
    solve("eng.block_thick.dia", make_dia([-1, 0, 1], [boff, main, boff], BLOCK_THICK_N, f64), 4, block_size=2,
          restart_policy="thick", max_iteration=64, eps=1e-11, max_restarts=24, init_vector=advancing_initializer())
    vals, vecs, info = tl.filtered_lanczos(chain_dia(FILTER_N, f32), num_eigs=2, lo=-2.0, hi=2.0, precise=True)
    out["eng.filtered_precise.vals"] = np.asarray(vals)
    out["eng.filtered_precise.vecs"] = np.asarray(vecs)
    out["eng.filtered_precise.res"] = np.asarray(info["residuals"])


def _expm_methods(make_dia, out, jax_cases):
    """Every Exponentiator method (both modes, real and complex, precise or
    not) on the n = 128 chain; with ``jax_cases`` first
    tests/test_sharded.py:201 and :417."""
    import torch

    import lanczos_tpu_torch as tl

    n = EXPM_N
    chain = make_dia([-1, 1], [np.full(n, -1.0)] * 2, n, torch.float64)
    if jax_cases:
        psi = np.zeros(n, complex)
        psi[n // 2] = 1.0
        o, it = tl.Exponentiator(chain, dtype=np.complex128).run(-1.5j, psi)
        out["expm.run_complex"] = o.cpu().numpy()
        out["expm.run_complex.iters"] = np.array(it)
        cheb = make_dia([-1, 1], [np.full(CHEBY_N, -1.0, np.float32)] * 2, CHEBY_N, torch.float32)
        v = expm_state(CHEBY_N, 0)
        ex = tl.Exponentiator(cheb, dtype=np.float32)
        (o_re, o_im), _ = ex.run_chebyshev(3j, v.real.astype(np.float32), v.imag.astype(np.float32), lo=-2.0, hi=2.0)
        out["expm.cheby_f32"] = o_re.double().cpu().numpy() + 1j * o_im.double().cpu().numpy()
        (p_re, p_im), _ = ex.run_chebyshev(3j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)
        out["expm.cheby_precise"] = p_re + 1j * p_im

    ex = tl.Exponentiator(chain)
    w = expm_state(n, 3)
    for mode in ("hybrid", "fused"):
        ex.mode = mode
        o, it = ex.run(-0.5, w.real)
        out[f"expm.run_{mode}"] = o.cpu().numpy()
        out[f"expm.run_{mode}.iters"] = np.array(it)
    ex.mode = "hybrid"
    o, _ = ex.run_grid([0.1, -0.3j, 0.5], w.real)
    out["expm.run_grid"] = o.cpu().numpy()
    (o_re, o_im), _ = ex.run_split(-0.4j, w.real, w.imag)
    out["expm.run_split"] = (o_re + 1j * o_im).cpu().numpy()
    o_re, o_im = ex.evolve(0.05j, w.real, w.imag, 4)
    out["expm.evolve"] = (o_re + 1j * o_im).cpu().numpy()
    o_re, o_im = ex.evolve(0.05j, w.real, w.imag, 4, krylov_dim=16, precise=True)
    out["expm.evolve_precise"] = o_re + 1j * o_im
    (o_re, o_im), _ = ex.run_chebyshev_grid([1j, 2j], w.real, w.imag, lo=-2.0, hi=2.0)
    out["expm.cheby_grid"] = (o_re + 1j * o_im).cpu().numpy()
    batch = np.stack([w.real, np.zeros(n), w.imag])
    o, iters = ex.run_batch(-0.3j, batch)
    out["expm.run_batch"] = o.cpu().numpy()
    out["expm.run_batch.iters"] = np.asarray(iters)
    o, _ = ex.taylor_run(0.2, w.real)
    out["expm.taylor"] = o.cpu().numpy()

    upper, lower, dense = complex_hops()
    hc = tl.Exponentiator(make_dia([1, -1], [upper, lower], n, torch.complex128))
    o, _ = hc.run(-0.7j, w)
    out["expm.herm_run"] = o.cpu().numpy()
    o_re, o_im = hc.evolve(0.05j, w.real, w.imag, 4)
    out["expm.herm_evolve"] = (o_re + 1j * o_im).cpu().numpy()
    (o_re, o_im), _ = hc.run_chebyshev(2j, w.real, w.imag, precise=True)
    out["expm.herm_cheby_precise"] = o_re + 1j * o_im


def _engine_checks(mesh, out, checkpoint_dir):
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator, ShardedDIAOperator

    def make_dia(offsets, diags, n, dtype):
        return ShardedDIAOperator.from_diagonals(offsets, [np.asarray(d) for d in diags], n, mesh, dtype=dtype)

    def make_bsr(rows, cols, vals, n, dtype):
        return ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8, dtype=dtype)

    run_engines(make_dia, make_bsr, out, checkpoint_dir, jax_cases=mesh.size == 2)


def one_process_ops():
    """``(make_dia, make_bsr)`` of the port's one-device operators on the
    CPU: the one-process solves the worlds are held to."""
    import lanczos_tpu_torch as tl

    def make_dia(offsets, diags, n, dtype):
        return tl.DIAOperator.from_diagonals(offsets, [np.asarray(d) for d in diags], n, dtype=dtype, device="cpu")

    def make_bsr(rows, cols, vals, n, dtype):
        return tl.BSROperator.from_coo(rows, cols, vals, n, bm=8, bk=8, dtype=dtype, device="cpu")

    return make_dia, make_bsr


CHECKPOINT_N = 128


def checkpoint_engine(op):
    """The checkpointed solve: three pairs, one a round (several rounds)."""
    import lanczos_tpu_torch as tl

    eng = tl.LambdaLanczos(op, num_eigs=3, mode="hybrid")
    eng.eps, eng.eigenvalue_offset, eng.num_eigs_per_iteration = 1e-12, -4.0, 1
    eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=3)
    return eng


def interrupted_checkpoint(op, path) -> None:
    """Run :func:`checkpoint_engine` under ``CheckpointedRun`` and stop it
    right after its first round's save: ``path`` then holds that round."""
    from lanczos_tpu_torch.solvers import lanczos as tlz
    from lanczos_tpu_torch.utils.checkpoint import CheckpointedRun

    class Interrupt(Exception):
        pass

    driver = tlz.deflation_driver

    def one_round(*args, after_round, **kwargs):
        def save_then_stop(manager, counts, finished):
            after_round(manager, counts, finished)
            raise Interrupt

        return driver(*args, after_round=save_then_stop, **kwargs)

    tlz.deflation_driver = one_round
    try:
        CheckpointedRun(checkpoint_engine(op), path).run()
    except Interrupt:
        pass
    finally:
        tlz.deflation_driver = driver


def _checkpoint_checks(mesh, out, tmpdir):
    """A file written by a one-process run (the parent's ``ck_one.npz``)
    resumed on the world's ranks, and a file written by the world
    (``ck_world.npz``) for the parent to resume in one process."""
    import shutil

    import torch.distributed as dist

    from lanczos_tpu_torch.parallel.sharded import ShardedDIAOperator
    from lanczos_tpu_torch.utils.checkpoint import CheckpointedRun

    n = CHECKPOINT_N

    def op():
        return ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, mesh)

    resumed = f"{tmpdir}/ck_one_resumed.npz"
    if mesh.rank == 0:
        shutil.copy(f"{tmpdir}/ck_one.npz", resumed)
    dist.barrier()
    eng = checkpoint_engine(op())
    vals, vecs = CheckpointedRun(eng, resumed).run()
    out["ck.from_one.vals"] = np.asarray(vals)
    out["ck.from_one.vecs"] = vecs.numpy()
    out["ck.from_one.iters"] = np.asarray(eng.iteration_counts)
    interrupted_checkpoint(op(), f"{tmpdir}/ck_world.npz")


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


# ------------------------------------------------- per-rank packing
#
# ShardedBSROperator.from_coo packs only this rank's row blocks; each case
# holds the result, bit for bit, to from_blocks over the whole pack (the
# packer on every row), and a spy on the packer records what it was handed.

PACK_DTYPES = ("float32", "float64", "complex64", "complex128", "bfloat16")
CANCEL_N = 512


def pack_patterns() -> dict:
    """``patterns()`` and a chain whose far tiles hold pairs that cancel
    and values that bfloat16 rounds to zero (1e-45, a float32 subnormal):
    the nonzero mask then depends on the sum in the tiles' dtype."""
    n = CANCEL_N
    rows, cols, vals = ([a] for a in _chain(n))
    pos = np.random.default_rng(3).choice(n - 300, 6, replace=False)
    rows += [pos, pos, pos + 300]
    cols += [pos + 300, pos + 300, pos]
    vals += [np.full(6, 1.5), np.full(6, -1.5), np.full(6, 1e-45)]
    return {**patterns(), "cancel": (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, 8, 8)}


def pack_values(vals, dtype_name):
    """The pattern's values for tiles of ``dtype_name``: complex for the
    complex dtypes."""
    return vals * (1 + 0.5j) if dtype_name.startswith("complex") else vals


def _same_bits(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.dtype != b.dtype or a.shape != b.shape:
            return False
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)) if a.dtype == torch.bfloat16
                    else torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return a == b


def pack_case(rows, cols, vals, n, bm, bk, dtype_name, comm, mesh):
    """One case on this rank: ``(record, from_coo's operator, from_blocks'
    operator)``, the operators None where both raised.  The record has the
    resolved ``comm`` (or the text ``raised``), ``same``: the tiles,
    ``col_blocks``, comm, ``footprint_words``, ring and footprint groups of
    the two operators equal bit for bit, and ``calls``: per packer call, the
    row extent it packed, the entries it was handed and whether they are
    exactly this rank's rows of the COO in their order, less the slab's
    first row."""
    import torch

    from lanczos_tpu_torch.core.types import pack_dtype
    from lanczos_tpu_torch.ops.operators import _pack_bsr
    from lanczos_tpu_torch.parallel import sharded

    dtype = getattr(torch, dtype_name)
    vals = pack_values(vals, dtype_name)
    q = int(np.lcm(np.lcm(bk, mesh.size * bm), mesh.size * bk))
    n_pad = -(-n // q) * q
    lo, hi = mesh.rank * n_pad // mesh.size, (mesh.rank + 1) * n_pad // mesh.size
    keep = (rows >= lo) & (rows < hi)
    calls = []

    def spy(r, c, v, extent, *args, **kwargs):
        exact = (r.shape == rows[keep].shape and np.array_equal(r + lo, rows[keep])
                 and np.array_equal(c, cols[keep]) and np.array_equal(v, vals[keep]))
        calls.append([int(extent), int(r.shape[0]), bool(exact)])
        return _pack_bsr(r, c, v, extent, *args, **kwargs)

    sharded._pack_bsr = spy
    try:
        try:
            op = sharded.ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=dtype, comm=comm)
        except ValueError as e:
            op = str(e)
    finally:
        sharded._pack_bsr = _pack_bsr
    whole, cb = _pack_bsr(rows, cols, vals, n_pad, bm, bk, pack_dtype(dtype), layout="rsmk")
    try:
        ref = sharded.ShardedBSROperator.from_blocks(torch.from_numpy(whole).to(dtype), cb, n, mesh, comm=comm)
    except ValueError as e:
        ref = str(e)
    rec = {"calls": calls}
    if isinstance(op, str) or isinstance(ref, str):
        rec.update(comm="raised", same=op == ref)
        return rec, None, None
    rec.update(comm=op.comm, words=op.footprint_words, same=all(
        _same_bits(getattr(op, k), getattr(ref, k))
        for k in ("blocks", "col_blocks", "comm", "footprint_words", "ring_groups", "footprint", "n_padded")))
    return rec, op, ref


def _pack_checks(mesh, out):
    """Every pack pattern, comm and tile dtype on this rank (``pack_case``),
    and both operators' products, bit for bit; into ``out["pack"]``."""
    import torch

    recs = []
    for name, (rows, cols, vals, n, bm, bk) in pack_patterns().items():
        for dtype_name in PACK_DTYPES:
            for comm in COMMS:
                rec, op, ref = pack_case(rows, cols, vals, n, bm, bk, dtype_name, comm, mesh)
                if op is not None:
                    vec = torch.float32 if dtype_name == "bfloat16" else getattr(torch, dtype_name)
                    x = torch.from_numpy(pack_values(pattern_x(n), dtype_name)).to(vec)
                    rec["same_product"] = _same_bits(op.matvec(op.scatter(x)), ref.matvec(ref.scatter(x)))
                recs.append({"pattern": name, "dtype": dtype_name, "comm_requested": comm, **rec})
    out["pack"] = np.array(json.dumps(recs))


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

    # bfloat16 tiles over the ranks (K2's bfloat16 instance on the card):
    # a product in the gather and ring schedules, one fused solve over
    # float32 slabs.
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    rows, cols, vals, n = bf16_problem()
    x = torch.from_numpy(pattern_x(n)).float()
    for comm in ("gather", "auto"):  # auto: the chain's ring groups, regrouped as bfloat16 words
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8, dtype=torch.bfloat16, comm=comm)
        out[f"bf16.{comm}.comm"] = np.array(op.comm)
        out[f"bf16.{comm}.dtype"] = np.array(str(op.blocks.dtype))
        out[f"bf16.{comm}.y"] = op.gather(op.matvec(op.scatter(x))).numpy()
    out["bf16.vals"], out["bf16.iters"] = bf16_solve(op)

    # Fresh draws: the same vector on every rank, a new one per call.
    init = tl.random_initializer(np.float64)
    out["seed.draws"] = np.stack([init(16), init(16)])

    # A second initialization is a no-op, whatever it is given.
    pmesh.initialize_distributed(backend="gloo", init_method="tcp://127.0.0.1:1", world_size=99, rank=98)
    out["noop.world"] = np.array(pmesh.make_mesh().size)

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


# ------------------------------------------------------------ 2-D grids
#
# The 4-rank world as a 2 x 2 GridMesh: the JAX tests' cases of the
# multislice and 2-D dense meshes (tests/test_sharded.py:254-335).

GRID_CHAIN_N = 1024  # the chain over the combined axes (:254)
GRID_SLICE_N = 32  # each slice's own symmetric matrix (:279)
GRID_DENSE_N = 64  # the 2-D dense operator (:313)


def slice_problems():
    """tests/test_sharded.py:279's two symmetric matrices and unit start
    vectors, one per slice."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, GRID_SLICE_N, GRID_SLICE_N))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    v0 = rng.standard_normal((2, GRID_SLICE_N))
    return a, v0 / np.linalg.norm(v0, axis=1, keepdims=True)


def dense_2d_problem():
    """tests/test_sharded.py:313's matrix and the vector of its matvec."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((GRID_DENSE_N, GRID_DENSE_N))
    return (a + a.T) / 2, rng.standard_normal(GRID_DENSE_N)


def _grid_checks(out):
    import os

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedDenseOperator, ShardedDIAOperator

    grid = pmesh.make_multislice_mesh(2)
    out["grid.shape"] = np.array(grid.shape)
    out["grid.coords"] = np.array(grid.coords)
    out["grid.sizes"] = np.array([grid.rows_mesh.size, grid.slices_mesh.size, grid.combined.size])
    out["grid.ranks"] = np.array([grid.rows_mesh.rank, grid.slices_mesh.rank, grid.combined.rank])
    for key, call in (("uneven", lambda: pmesh.make_multislice_mesh(3)),
                      ("uneven_hosts", lambda: pmesh.make_multislice_mesh())):
        os.environ["LOCAL_WORLD_SIZE"] = "3"
        try:
            call()
        except ValueError as e:
            out[f"grid.{key}_raised"] = np.array(str(e))
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]

    # The chain over the combined axes: n split over all four ranks.
    n = GRID_CHAIN_N
    op = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, grid.combined)
    out["grid.chain.y"] = op.gather(op.matvec(op.scatter(pattern_x(n)))).numpy()
    eng = tl.LambdaLanczos(op, find_maximum=False)
    eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=3)
    val, _vec = eng.run_one()
    out["grid.chain.val"] = np.array(val)

    # Independent solves over slices: each slice's own matrix over its rows.
    a, v0 = slice_problems()
    s = grid.coords[0]
    op = ShardedDenseOperator.from_dense(a[s], grid.rows_mesh)
    eng = tl.LambdaLanczos(op, find_maximum=True, mode="fused")
    eng.init_vector = lambda _n: v0[s]
    val, _vec = eng.run_one()
    out["grid.slice.val"] = np.array(val)
    out["grid.slice.iters"] = np.array(eng.iteration_counts)
    # The same solves from the default random start, slice s finding 1 + 2s
    # roots one a round: each slice draws a start a round over its own rows
    # group, once in slice 0 and four times in slice 1.
    eng = tl.LambdaLanczos(op, find_maximum=True, num_eigs=1 + 2 * s)
    eng.num_eigs_per_iteration = 1
    vals, _vecs = eng.run()
    out["grid.slice.default_vals"] = np.asarray(vals, dtype=np.float64)
    out["grid.slice.default_rounds"] = np.array(len(eng.iteration_counts))

    # The 2-D dense operator: rank (i, j) holds A[I_i, J_j].
    a2, x = dense_2d_problem()
    op = pmesh.shard_dense_operator_2d(a2, grid)
    out["grid.dense.y"] = op.gather(op.matvec(op.scatter(x))).numpy()
    eng = tl.LambdaLanczos(op, find_maximum=True)
    eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=31)
    val, vec = eng.run_one()
    out["grid.dense.val"] = np.array(val)
    out["grid.dense.residual"] = np.array(np.linalg.norm(a2 @ vec.numpy() - val * vec.numpy()))


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
        _pack_checks(mesh, out)
        # The port's dryrun_multichip in this world, less the two regimes
        # that take seconds over gloo (other items hold them here).
        from lanczos_tpu_torch.parallel import multichip

        out["dryrun"] = np.array(json.dumps(multichip.dryrun_multichip(world, emit=None, skip=DRYRUN_SKIP)))
        tmpdir = str(Path(inputs_path).parent)
        if world == 4:
            _solve_checks(mesh, out)
            _grid_checks(out)
        else:
            _api_checks(mesh, out)
            _checkpoint_checks(mesh, out, tmpdir)
        _engine_checks(mesh, out, tmpdir)
        if world == 4:  # the engines' set of multichip --engines at its CPU size
            from lanczos_tpu_torch.parallel.engine_set import SMALL, engine_set

            out["engine_set"] = np.array(json.dumps(engine_set(mesh, sizes=SMALL, emit=None, workdir=tmpdir)))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
