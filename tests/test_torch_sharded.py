"""The row-partitioned path of the PyTorch port (``lanczos_tpu_torch.parallel``)
and kernel K2 (canonical-layout BSR SpMV), against the JAX package.

Kernel K2's plain version is held against ``bsr_matvec_pallas`` in interpret
mode.  The multi-rank checks run in spawned gloo worlds of 2 and 4 ranks on
the CPU (``tests/torch_sharded_world.py``, one spawn per world size, each
under a timeout) and are compared with the JAX package's sharded operators
and solves on meshes of as many of the conftest's virtual devices, built
once per test run from the same numpy inputs (``tests/torch_run_once.py``:
one world of each size, whichever xdist workers run the items).  Everything
is float64; the tolerances are stated where they are used.  The card's
tests (``gpu`` marker) run K2 against its plain version and a one-rank NCCL
solve.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import torch_sharded_world as world_script  # noqa: E402
from torch_run_once import once  # noqa: E402

from lanczos_tpu_torch.ops import spmv  # noqa: E402
from lanczos_tpu_torch.parallel import mp_demo, multichip  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WORLD_TIMEOUT_S = 300  # a hung world fails its tests instead of running into tier-1's clock
TOL = 1e-12  # float64 sums in another order (plain einsum, gather vs halos, JAX vs PyTorch)


# ---------------------------------------------------------------- K2 plain


def _random_rsmk(r, s, bm, bk, c_rows, dtype, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((r, s, bm, bk)).astype(dtype)
    col_blocks = rng.integers(0, c_rows, (r, s)).astype(np.int32)
    x = rng.standard_normal(c_rows * bk).astype(dtype)
    return blocks, col_blocks, x


K2_CASES = {
    "square": (16, 3, 8, 8, 16),  # x the whole vector: C = R*bm/bk
    "payload": (16, 3, 8, 8, 5),  # a footprint payload: C < R*bm/bk
    "rect": (6, 2, 64, 128, 3),  # bm != bk (tests/test_sharded.py:82-100)
}


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from lanczos_tpu.ops import pallas_spmv

    r, s, bm, bk, c_rows = K2_CASES[case]
    # float32 against the interpret-mode Pallas kernel, which accumulates in
    # float32 (preferred_element_type) whatever its input: the float32 bar.
    blocks, cb, x = _random_rsmk(r, s, bm, bk, c_rows, np.float32, seed=3)
    want = np.asarray(pallas_spmv.bsr_matvec_pallas(jnp.asarray(blocks), jnp.asarray(cb), jnp.asarray(x),
                                                    interpret=True))
    got = spmv.bsr_matvec_rsmk(torch.from_numpy(blocks), torch.from_numpy(cb), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # float64 against the JAX package's plain version and a dense product: 1e-12.
    blocks, cb, x = _random_rsmk(r, s, bm, bk, c_rows, np.float64, seed=4)
    want = np.asarray(pallas_spmv.bsr_matvec_reference(jnp.asarray(blocks), jnp.asarray(cb), jnp.asarray(x)))
    dense = np.zeros((r * bm, c_rows * bk))
    for i in range(r):
        for j in range(s):
            dense[i * bm:(i + 1) * bm, cb[i, j] * bk:(cb[i, j] + 1) * bk] += blocks[i, j]
    got = spmv.bsr_matvec_rsmk(torch.from_numpy(blocks), torch.from_numpy(cb), torch.from_numpy(x).view(c_rows, bk),
                               n_out=r * bm - 3).numpy()
    np.testing.assert_allclose(got, want[: r * bm - 3], rtol=TOL, atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(got, (dense @ x)[: r * bm - 3], rtol=TOL, atol=TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="x table"):
        spmv.bsr_matvec_rsmk(torch.from_numpy(blocks), torch.from_numpy(cb), torch.zeros(bk, dtype=torch.float64),
                             col_bound=c_rows)


# ------------------------------------------------------- the JAX references


def _jax_mesh(w):
    import jax
    from lanczos_tpu.parallel import mesh as pmesh

    return pmesh.make_mesh(jax.devices()[:w])


def _jax_refs(w):
    """The packed arrays the world of ``w`` ranks converts, and a function
    that computes the JAX package's results for every check of that world
    (the shard_map compiles and solves), to call while the world runs."""
    import jax.numpy as jnp
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.parallel.sharded import ShardedBSROperator, ShardedDIAOperator, shard_operator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    mesh = _jax_mesh(w)
    refs, inputs, matvecs = {}, {}, {}
    for name, (rows, cols, vals, n, bm, bk) in world_script.patterns().items():
        dense = np.zeros((n, n))
        np.add.at(dense, (rows, cols), vals)
        x = world_script.pattern_x(n)
        refs[f"{name}.dense_y"] = dense @ x
        for comm in world_script.COMMS:
            key = f"{name}.{comm}"
            try:
                op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=jnp.float64, comm=comm)
            except ValueError:
                refs[f"{key}.raised"] = True
                continue
            refs[f"{key}.comm"] = op.comm
            hops = op.footprint[1] if op.footprint is not None else ()
            refs[f"{key}.words"] = sum(send.shape[1] * op.bk for (_h, _b, _c, send) in hops)
            # one matvec (one shard_map compile) per mode the pattern resolves to
            matvecs.setdefault(f"{name}.{op.comm}.y_jax", (op, x))
            matvecs[f"{key}.y"] = (op, x)
            inputs[f"{key}.blocks"] = np.asarray(op.blocks)
            inputs[f"{key}.col_blocks"] = np.asarray(op.col_blocks)

    offsets, diags, n = world_script.dia_problem()
    dia = ShardedDIAOperator.from_diagonals(offsets, diags, n, mesh)
    dense = np.zeros((n, n))
    for d, diag in zip(offsets, diags):
        i = np.arange(max(0, -d), min(n, n - d))
        dense[i, i + d] = diag[i]
    refs["dia.dense_y"] = dense @ world_script.pattern_x(n)
    inputs["dia.offsets"] = np.asarray(dia.offsets)
    inputs["dia.data"] = np.asarray(dia.data)

    def finish():
        done = {}
        for key, (op, x) in matvecs.items():
            y_key = key if key.endswith("y_jax") else key.rsplit(".", 2)[0] + f".{op.comm}.y_jax"
            if y_key not in done:
                done[y_key] = np.asarray(op.matvec(jnp.asarray(x)))
            refs[key] = done[y_key]
        refs["dia.y"] = np.asarray(dia.matvec(jnp.asarray(world_script.pattern_x(n))))
        if w == 4:
            m = world_script.SOLVE_N
            ops = {
                "bsr": ShardedBSROperator.from_coo(*world_script._chain(m), m, mesh, dtype=jnp.float64),
                "dia": ShardedDIAOperator.from_diagonals([-1, 1], [np.full(m, -1.0)] * 2, m, mesh),
            }
            for name, op in ops.items():
                for mode in ("hybrid", "fused"):
                    eng = LambdaLanczos(op, find_maximum=False, mode=mode)
                    eng.eigenvalue_offset = -4.0
                    eng.eps = 1e-12
                    eng.init_vector = fixed_seed_initializer(np.float64, seed=world_script.SOLVE_SEEDS[name])
                    val, _vec = eng.run_one()
                    refs[f"solve.{name}.{mode}.val"] = float(val)
                    refs[f"solve.{name}.{mode}.iters"] = list(eng.iteration_counts)
            refs.update(_jax_grid_refs())
        else:
            eng = LambdaLanczos(shard_operator(DenseOperator(jnp.asarray(world_script.dense_problem())), mesh),
                                find_maximum=True)
            eng.init_vector = fixed_seed_initializer(np.float64, seed=42)
            refs["dense.val"] = float(eng.run_one()[0])
        return refs

    return inputs, finish


def _jax_grid_refs():
    """The JAX package on the 2-D meshes of tests/test_sharded.py:254-335,
    over the first four devices: the chain over the combined axes of a
    (2, 2) multislice mesh, the batched fused solves over its slices and
    the dense operator on a (2, 2) (rows, cols) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.parallel.mesh import make_multislice_mesh, shard_dense_operator_2d
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator
    from lanczos_tpu.solvers.lanczos_fused import fused_krylov
    from lanczos_tpu.utils.random import fixed_seed_initializer

    refs = {}
    grid = make_multislice_mesh(2, devices=jax.devices()[:4])
    n = world_script.GRID_CHAIN_N
    op = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, grid, axis_name=("slices", "rows"))
    refs["grid.chain.y"] = np.asarray(op.matvec(jnp.asarray(world_script.pattern_x(n))))
    eng = LambdaLanczos(op, find_maximum=False)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    refs["grid.chain.val"] = float(eng.run_one()[0])

    a, v0 = world_script.slice_problems()
    m = world_script.GRID_SLICE_N

    def one(a_i, v_i):
        return fused_krylov(DenseOperator(a_i, m), v_i, jnp.zeros((1, m)), jnp.zeros((1,)), 1e-10, 0.0, nroot=1,
                            m_cap=m, find_maximum=True)[4]

    a_s = jax.device_put(jnp.asarray(a), NamedSharding(grid, P("slices", "rows", None)))
    v_s = jax.device_put(jnp.asarray(v0), NamedSharding(grid, P("slices", "rows")))
    refs["grid.slice.vals"] = np.asarray(jax.jit(jax.vmap(one))(a_s, v_s))[:, 0]

    a2, _x = world_script.dense_2d_problem()
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("rows", "cols"))
    eng = LambdaLanczos(DenseOperator(shard_dense_operator_2d(jnp.asarray(a2), mesh2), a2.shape[0]), find_maximum=True)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=31)
    refs["grid.dense.val"] = float(eng.run_one()[0])
    return refs


def _start_world(w, tmp: Path, inputs: dict):
    """Start ``tests/torch_sharded_world.py`` as ``w`` gloo ranks; returns
    the processes, for :func:`_join_world`."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [
        subprocess.Popen([sys.executable, str(HERE / "torch_sharded_world.py"), str(r), str(w), str(tmp / "rendezvous"),
                          str(tmp / "inputs.npz"), str(tmp / f"out{r}.npz")],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(w)
    ]


def _join_world(procs, tmp: Path, started) -> list[dict]:
    """Every rank's outputs, in rank order.  All ranks are killed if one
    fails or the world outlives WORLD_TIMEOUT_S from ``started``."""
    deadline = started + datetime.timedelta(seconds=WORLD_TIMEOUT_S)
    errors = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 0.0))
            if p.returncode != 0:
                errors.append(f"rank {r} rc={p.returncode}\n{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    outs = []
    for r in range(len(procs)):
        with np.load(tmp / f"out{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def _world(w, tmp: Path):
    """The JAX references and the outputs of a world of ``w`` ranks, run in
    ``tmp``; the references are computed while the world runs."""
    inputs, jax_refs = _jax_refs(w)
    if w == 2:  # a one-process checkpoint for the world to resume
        make_dia, _make_bsr = world_script.one_process_ops()
        n = world_script.CHECKPOINT_N
        world_script.interrupted_checkpoint(make_dia([-1, 1], [np.full(n, -1.0)] * 2, n, torch.float64),
                                            str(tmp / "ck_one.npz"))
    started = datetime.datetime.now()
    procs = _start_world(w, tmp, inputs)
    try:
        refs = jax_refs()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    refs["tmpdir"] = tmp
    return refs, _join_world(procs, tmp, started)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return once("torch_sharded.world2", tmp_path_factory, lambda tmp: _world(2, tmp))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return once("torch_sharded.world4", tmp_path_factory, lambda tmp: _world(4, tmp))


def _one_process(tmp: Path):
    out = {}
    make_dia, make_bsr = world_script.one_process_ops()
    world_script.run_engines(make_dia, make_bsr, out, str(tmp), jax_cases=False)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The engine cases of both worlds run by the port in one process on the
    CPU (the solves each world is held to at 1e-12)."""
    return once("torch_sharded.one_process", tmp_path_factory, _one_process)


@pytest.fixture(scope="module")
def jax_engines(tmp_path_factory):
    """The JAX package's engines on the JAX tests' cases, on one device (its
    own tests hold its sharded runs to these at 1e-11): once per run."""
    return once("torch_sharded.jax_engines", tmp_path_factory, lambda _tmp: _jax_engines())


def _jax_engines():
    import jax.numpy as jnp
    from lanczos_tpu import Exponentiator, LambdaLanczos, filtered_lanczos
    from lanczos_tpu.ops.operators import DIAOperator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    refs = {}
    n = world_script.ENGINE_N

    def chain_dia(m, dtype=np.float64):
        return DIAOperator.from_diagonals([-1, 1], [np.full(m, -1.0, dtype)] * 2, m)

    def solve(op, num_eigs, **attrs):
        eng = LambdaLanczos(op, find_maximum=attrs.pop("find_maximum", False), num_eigs=num_eigs,
                            dtype=attrs.pop("dtype", None), mode=attrs.pop("mode", "auto"))
        for k, v in attrs.items():
            setattr(eng, k, v)
        return np.sort(np.asarray(eng.run()[0]))

    pv = dict(dtype=np.float32, mode="fused", precise_vectors=True, restart_policy="thick", max_iteration=40,
              max_restarts=64, eps=1e-11, eigenvalue_offset=-4.0, init_vector=fixed_seed_initializer(np.float32, seed=11))
    # one JAX pv thick solve of the chain serves both of its storage forms
    refs["pv_thick.dia"] = refs["pv_thick.bsr"] = solve(chain_dia(n, np.float32), 1, **pv)
    refs["block.dia"] = solve(chain_dia(n), 2, block_size=2, eigenvalue_offset=-4.0,
                              init_vector=fixed_seed_initializer(np.float64, seed=8))
    main, off, _dense = world_script.block_thick_problem()
    init = world_script.advancing_initializer()
    refs["block_thick.dia"] = solve(
        DIAOperator.from_diagonals([-1, 0, 1], [off, main, off], world_script.BLOCK_THICK_N), 4, block_size=2,
        restart_policy="thick", max_iteration=64, eps=1e-11, max_restarts=24, init_vector=lambda k: jnp.asarray(init(k)))
    upper, lower, _dense = world_script.complex_hops()
    refs["complex.dia"] = solve(DIAOperator.from_diagonals([1, -1], [upper, lower], world_script.EXPM_N), 1,
                                find_maximum=True, init_vector=fixed_seed_initializer(np.complex128, seed=5))
    refs["filtered_precise"] = np.asarray(filtered_lanczos(chain_dia(world_script.FILTER_N, np.float32), num_eigs=2,
                                                           lo=-2.0, hi=2.0, precise=True)[0])
    psi = np.zeros(world_script.EXPM_N, complex)
    psi[world_script.EXPM_N // 2] = 1.0
    refs["expm.run_complex"] = np.asarray(Exponentiator(chain_dia(world_script.EXPM_N), dtype=np.complex128)
                                          .run(-1.5j, jnp.asarray(psi))[0])
    v = world_script.expm_state(world_script.CHEBY_N, 0)
    ex = Exponentiator(chain_dia(world_script.CHEBY_N, np.float32), dtype=np.float32)
    (o_re, o_im), _ = ex.run_chebyshev(3j, v.real.astype(np.float32), v.imag.astype(np.float32), lo=-2.0, hi=2.0)
    refs["expm.cheby_f32"] = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    return refs


def _same_on_every_rank(outs, key):
    for r, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out[key], outs[0][key], err_msg=f"rank {r} differs from rank 0 in {key}")
    return outs[0][key]


# --------------------------------------------------------------- matvecs


@pytest.mark.parametrize("comm", world_script.COMMS)
@pytest.mark.parametrize("w", [2, 4])
def test_sharded_bsr_matvec(request, w, comm):
    refs, outs = request.getfixturevalue(f"world{w}")
    for name in world_script.patterns():
        key = f"{name}.{comm}"
        if refs.get(f"{key}.raised"):  # explicit ring on a scattered pattern raises in both
            assert "ring" in str(_same_on_every_rank(outs, f"{key}.raised")), key
            continue
        assert f"{key}.raised" not in outs[0], (key, outs[0].get(f"{key}.raised"))
        assert str(_same_on_every_rank(outs, f"{key}.comm")) == refs[f"{key}.comm"], key
        assert str(_same_on_every_rank(outs, f"{key}.comm_from_arrays")) == refs[f"{key}.comm"], key
        # the words each rank receives per matvec: JAX's sum_h F_h * bk
        # (tests/test_transfer_guard.py:193-226)
        assert int(_same_on_every_rank(outs, f"{key}.words")) == refs[f"{key}.words"], key
        y = _same_on_every_rank(outs, f"{key}.y")
        scale = np.abs(refs[f"{name}.dense_y"]).max()
        np.testing.assert_allclose(y, refs[f"{key}.y"], rtol=TOL, atol=TOL * scale, err_msg=key)
        np.testing.assert_allclose(y, refs[f"{name}.dense_y"], rtol=TOL, atol=TOL * scale, err_msg=key)
        np.testing.assert_allclose(_same_on_every_rank(outs, f"{key}.y_from_arrays"), y, rtol=TOL,
                                   atol=TOL * scale, err_msg=key)
    # The exchanges themselves ran: explicit footprint on every world, auto's
    # footprint on the long-range pattern at 4 ranks, and explicit ring
    # refused on the scattered pattern there (2 ranks are all one hop apart).
    resolved = {refs.get(f"{name}.{comm}.comm") for name in world_script.patterns()}
    if comm == "footprint" or (comm == "auto" and w == 4):
        assert "footprint" in resolved
    if comm == "ring":
        assert "ring" in resolved and (w == 2 or refs.get("scatter.ring.raised"))


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_dia_matvec(request, w):
    refs, outs = request.getfixturevalue(f"world{w}")
    scale = np.abs(refs["dia.dense_y"]).max()
    for key in ("dia.y", "dia.y_from_arrays"):
        y = _same_on_every_rank(outs, key)
        np.testing.assert_allclose(y, refs["dia.y"], rtol=TOL, atol=TOL * scale, err_msg=key)
        np.testing.assert_allclose(y, refs["dia.dense_y"], rtol=TOL, atol=TOL * scale, err_msg=key)


# ------------------------------------------------------ per-rank packing


@pytest.mark.parametrize("w", [2, 4])
def test_rank_packs_only_its_rows(request, w):
    # ShardedBSROperator.from_coo packs each rank's row blocks alone: on
    # every pattern, comm and tile dtype each rank's tiles, col_blocks,
    # resolved comm, footprint words and schedule groups, and its product,
    # equal bit for bit those of from_blocks over the whole pack; the
    # packer was handed exactly the rank's entries, once, for its rows.
    _refs, outs = request.getfixturevalue(f"world{w}")
    patterns = world_script.pack_patterns()
    by_rank = [json.loads(str(o["pack"])) for o in outs]
    keys = [(x["pattern"], x["dtype"], x["comm_requested"]) for x in by_rank[0]]
    assert set(keys) == {(name, dt, comm) for name in patterns for dt in world_script.PACK_DTYPES
                         for comm in world_script.COMMS}
    for i, (name, _dt, _comm) in enumerate(keys):
        rows, _cols, _vals, n, bm, bk = patterns[name]
        q = int(np.lcm(np.lcm(bk, w * bm), w * bk))
        recs = [by_rank[r][i] for r in range(w)]
        for r, rec in enumerate(recs):
            assert rec["same"] and rec.get("same_product", True), (r, rec)
            assert len(rec["calls"]) == 1 and rec["calls"][0][0] == -(-n // q) * q // w and rec["calls"][0][2], (r, rec)
            assert rec["comm"] == recs[0]["comm"], (r, rec, recs[0])  # every rank resolves alike
        assert sum(rec["calls"][0][1] for rec in recs) == len(rows)  # every entry packed once, by its row's rank
    resolved = {key: x["comm"] for key, x in zip(keys, by_rank[0])}
    if w == 4:  # the far tiles' sums decide: 1e-45 survives in float32, rounds away in bfloat16
        assert resolved[("cancel", "bfloat16", "auto")] == "ring"
        assert resolved[("cancel", "float32", "auto")] == "footprint"
        assert resolved[("scatter", "float64", "ring")] == "raised"


def test_rank_pack_matches_whole_pack():
    # The same cases in this process for every rank of 1 to 4 (a RowMesh
    # without a process group: packing runs no collective), every tile
    # dtype in one item (the suite's item count decides how xdist's load
    # scheduler deals the JAX package's tests: ROADMAP.md, Tier-1 facts).
    from lanczos_tpu_torch.parallel.mesh import RowMesh

    for size in (1, 2, 3, 4):
        for rank in range(size):
            mesh = RowMesh(None, rank, size, torch.device("cpu"))
            for name, (rows, cols, vals, n, bm, bk) in world_script.pack_patterns().items():
                for dtype in world_script.PACK_DTYPES:
                    for comm in world_script.COMMS:
                        rec, _op, _ref = world_script.pack_case(rows, cols, vals, n, bm, bk, dtype, comm, mesh)
                        case = (size, rank, name, dtype, comm, rec)
                        assert rec["same"], case
                        assert len(rec["calls"]) == 1 and rec["calls"][0][2], case


# ----------------------------------------------------------------- solves


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
@pytest.mark.parametrize("op", ["bsr", "dia"])
def test_sharded_lanczos_four_ranks(world4, op, mode):
    refs, outs = world4
    key = f"solve.{op}.{mode}"
    n = world_script.SOLVE_N
    val = float(_same_on_every_rank(outs, f"{key}.val"))
    vec = _same_on_every_rank(outs, f"{key}.vec")
    assert vec.shape == (n,)
    assert abs(val + 2.0 * np.cos(np.pi / (n + 1))) < 1e-10
    assert abs(val - refs[f"{key}.val"]) < 1e-10
    assert list(_same_on_every_rank(outs, f"{key}.iters")) == refs[f"{key}.iters"]
    assert float(_same_on_every_rank(outs, f"{key}.residual")) < 1e-8  # through the sharded matvec
    assert abs(np.linalg.norm(vec) - 1.0) < 1e-12


# ---------------------------------------------------------- 2-D grids


@pytest.mark.parametrize("case", ["layout", "combined_axes", "slices", "slices_default_start", "dense_2d"])
def test_grid_mesh(world4, case):
    # The 4-rank world as a 2 x 2 GridMesh against the JAX package's 2-D
    # meshes on four devices (tests/test_sharded.py:254-335), float64.
    refs, outs = world4
    if case == "layout":
        assert [tuple(o["grid.coords"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]  # slice-major
        assert tuple(_same_on_every_rank(outs, "grid.shape")) == (2, 2)
        assert tuple(_same_on_every_rank(outs, "grid.sizes")) == (2, 2, 4)  # rows, slices, combined
        # (rank in rows_mesh, in slices_mesh, in combined) of each rank
        assert [tuple(o["grid.ranks"]) for o in outs] == [(0, 0, 0), (1, 0, 1), (0, 1, 2), (1, 1, 3)]
        # an uneven world raises: 3 slices, hosts of LOCAL_WORLD_SIZE=3
        assert "do not split into 3 equal slices" in str(_same_on_every_rank(outs, "grid.uneven_raised"))
        assert "LOCAL_WORLD_SIZE=3" in str(_same_on_every_rank(outs, "grid.uneven_hosts_raised"))
    elif case == "combined_axes":
        n = world_script.GRID_CHAIN_N
        dense = np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
        y = _same_on_every_rank(outs, "grid.chain.y")
        np.testing.assert_allclose(y, dense @ world_script.pattern_x(n), rtol=0, atol=1e-12)
        np.testing.assert_allclose(y, refs["grid.chain.y"], rtol=0, atol=1e-12)
        val = float(_same_on_every_rank(outs, "grid.chain.val"))
        assert abs(val + 2 * np.cos(np.pi / (n + 1))) < 1e-10
        assert abs(val - refs["grid.chain.val"]) < 1e-12
    elif case == "slices":
        a, _v0 = world_script.slice_problems()
        exact = np.linalg.eigvalsh(a)[:, -1]
        for r, out in enumerate(outs):
            s = r // 2  # the slice of rank r, each solving its own matrix over its two rows ranks
            assert abs(float(out["grid.slice.val"]) - exact[s]) < 1e-10, (r, out["grid.slice.val"], exact[s])
            assert abs(float(out["grid.slice.val"]) - refs["grid.slice.vals"][s]) < 1e-8  # JAX's bar (:310)
        assert float(outs[0]["grid.slice.val"]) != float(outs[2]["grid.slice.val"])
    elif case == "slices_default_start":
        # Random starts drawn over each slice's own rows group: the slices
        # draw a different number of times (one a round: one round in slice
        # 0, three roots and a confirming round in slice 1), and the two
        # ranks of a slice draw alike (bit-identical values).
        a, _v0 = world_script.slice_problems()
        exact = np.linalg.eigvalsh(a)[:, ::-1]
        rounds = [int(o["grid.slice.default_rounds"]) for o in outs]
        assert rounds[0] == rounds[1] == 1 and rounds[2] == rounds[3] > 3, rounds
        for s in range(2):
            o0, o1 = outs[2 * s], outs[2 * s + 1]
            np.testing.assert_array_equal(o0["grid.slice.default_vals"], o1["grid.slice.default_vals"])
            np.testing.assert_allclose(o0["grid.slice.default_vals"], exact[s, :1 + 2 * s], rtol=0, atol=1e-10)
    else:
        a2, x = world_script.dense_2d_problem()
        np.testing.assert_allclose(_same_on_every_rank(outs, "grid.dense.y"), a2 @ x, rtol=0, atol=1e-11)
        val = float(_same_on_every_rank(outs, "grid.dense.val"))
        assert abs(val - np.linalg.eigvalsh(a2)[-1]) < 1e-10
        assert abs(val - refs["grid.dense.val"]) < 1e-12
        assert float(_same_on_every_rank(outs, "grid.dense.residual")) < 1e-8


# -------------------------------------------------- API around the world


def test_shard_operator_dense(world2):
    refs, outs = world2
    val = float(_same_on_every_rank(outs, "dense.val"))
    assert abs(val - np.linalg.eigvalsh(world_script.dense_problem())[-1]) < 1e-10
    assert abs(val - refs["dense.val"]) < 1e-10
    assert float(_same_on_every_rank(outs, "dense.residual")) < 1e-8
    assert "cannot auto-shard BSROperator" in str(_same_on_every_rank(outs, "dense.bsr_refused"))


def test_bfloat16_tiles_over_two_ranks(world2):
    # bfloat16 tiles (storage only) over 2 gloo ranks against the port's
    # one-process operator on the same tiles: the product in the gather and
    # ring schedules within 1e-6 of max |y| and the fused solve's values
    # (over the ring operator) within 1e-6 relative (float32 sums in
    # another order, the reductions over the ranks).
    import lanczos_tpu_torch as tl

    _refs, outs = world2
    rows, cols, vals, n = world_script.bf16_problem()
    one = tl.BSROperator.from_coo(rows, cols, vals, n, bm=8, bk=8, dtype=torch.bfloat16, device="cpu")
    want_y = one.matvec(torch.from_numpy(world_script.pattern_x(n)).float()).numpy()
    want_vals, _ = world_script.bf16_solve(one)
    for comm, resolved in (("gather", "gather"), ("auto", "ring")):
        assert str(_same_on_every_rank(outs, f"bf16.{comm}.comm")) == resolved
        assert str(_same_on_every_rank(outs, f"bf16.{comm}.dtype")) == "torch.bfloat16"
        y = _same_on_every_rank(outs, f"bf16.{comm}.y")
        np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-6 * np.abs(want_y).max())
    np.testing.assert_allclose(_same_on_every_rank(outs, "bf16.vals"), want_vals, rtol=1e-6)


def test_seed_broadcast_and_second_initialization(world2):
    _refs, outs = world2
    draws = _same_on_every_rank(outs, "seed.draws")  # rank 0's entropy, broadcast
    assert draws.shape == (2, 16) and not np.array_equal(draws[0], draws[1])
    assert int(_same_on_every_rank(outs, "noop.world")) == 2


def test_unsupported_engines_raise(world2, world4, one_process, jax_engines):
    # ROADMAP item 13: the thick, block, block-thick and filtered
    # engines, precise or not, complex input, checkpoints and every
    # Exponentiator method run over row-partitioned operators.  On 2 and 4
    # ranks each returns the port's one-process solve within 1e-12 (float64
    # values; unit overlaps of the gathered vectors) at its bar against the
    # exact values; on 2 ranks the JAX tests' own cases also meet those
    # tests' bars and agree with the JAX engines there.  The fused
    # engine's precise_vectors on two ranks as before: the values within
    # 1e-12 of the single-process solve and of the float32 entries'
    # spectrum, float32 eigenvectors, the slabs' float64 product at 1e-13.
    refs2, outs = world2
    import scipy.linalg as sla

    import lanczos_tpu_torch as tl

    exact = world_script.chain_exact
    n = world_script.ENGINE_N
    _pot, _off, small = world_script.small_problem()
    small32 = small.copy()
    small32[np.diag_indices_from(small)] = _pot.astype(np.float32)  # the float32 entries the precise engines see
    w_small, w_small32 = np.linalg.eigvalsh(small), np.linalg.eigvalsh(small32)
    bars = {  # case: (exact values, bar); the JAX tests' own cases first (the 2-rank world only)
        "pv_thick.bsr": (exact(n, 1), 1e-9),  # tests/test_sharded.py:364
        "pv_thick.dia": (exact(n, 1), 1e-9),  # tests/test_precise_thick.py:182
        "block.dia": (exact(n, 2), 1e-9),  # tests/test_block_lanczos.py:93
        "block_thick.dia": (np.linalg.eigvalsh(world_script.block_thick_problem()[2])[:4], 1e-10),  # :236
        "filtered_precise": (exact(world_script.FILTER_N, 2), 1e-11),  # test_sharded.py:398
        "complex.dia": (np.linalg.eigvalsh(world_script.complex_hops()[2])[-1:], 1e-10),  # test_sharded.py:227
        "complex.bsr": (np.linalg.eigvalsh(world_script.complex_hops()[2])[-1:], 1e-10),
        "thick_hybrid.small": (w_small[:2], 1e-10),
        "thick_fused.small": (w_small[:2], 1e-10),
        "pv_thick.small": (w_small32[:2], 1e-10),
        "block.small": (w_small[:2], 1e-10),
        "block_thick.small": (w_small[:2], 1e-10),
        "pv_block_thick.small": (w_small32[:2], 1e-10),
        "complex_block_thick.small": (np.linalg.eigvalsh(world_script.complex_hops(48)[2])[:3], 1e-10),
        "filtered_precise.small": (exact(world_script.SMALL_FILTER_N, 2), 1e-11),
    }
    w_sigma = np.linalg.eigvalsh(np.diag(np.full(world_script.CHEBY_N - 1, -1.0), 1)
                                 + np.diag(np.full(world_script.CHEBY_N - 1, -1.0), -1))
    bars["filtered_sigma"] = (np.sort(w_sigma[np.argsort(np.abs(w_sigma - 0.3))[:2]]), 1e-10)
    for w, (_refs_w, world) in ((2, world2), (4, world4)):
        for case, (want, bar) in bars.items():
            key = f"eng.{case}"
            if w == 4 and case in world_script.JAX_CASES:
                assert f"{key}.vals" not in world  # the 2-rank world's alone
                continue
            got = np.sort(_same_on_every_rank(world, f"{key}.vals"))
            assert np.max(np.abs(got - want)) < bar, (w, case, got, want)
            if case in jax_engines:
                assert np.max(np.abs(got - np.sort(jax_engines[case]))) < 2 * bar, (w, case, jax_engines[case])
            vecs = _same_on_every_rank(world, f"{key}.vecs")
            assert vecs.shape[0] == len(want) and np.all(np.isfinite(vecs)), (case, vecs.shape)
            if case in world_script.JAX_CASES:
                continue  # held to the JAX test's bar and engine; the 1e-12 check is the small cases'
            one = np.sort(one_process[f"{key}.vals"])
            assert np.max(np.abs(got - one)) <= 1e-12, (w, case, got, one)
            one_vecs = one_process[f"{key}.vecs"]
            assert vecs.shape == one_vecs.shape, (case, vecs.shape)
            order, one_order = np.argsort(_same_on_every_rank(world, f"{key}.vals")), np.argsort(one_process[f"{key}.vals"])
            overlaps = np.abs(np.sum(np.conj(vecs[order]) * one_vecs[one_order], axis=1))
            assert np.all(overlaps >= 1 - 1e-6), (w, case, overlaps)
            if f"{key}.res" in world and not case.startswith("filtered"):
                assert np.max(_same_on_every_rank(world, f"{key}.res")) < 1e-8, (w, case)
            if f"{key}.iters" in world and "block_thick" not in case:
                # (the block-thick engines repair dead start rows with fresh
                # entropy, so their counts may differ at the rounding level)
                assert list(world[f"{key}.iters"]) == list(one_process[f"{key}.iters"]), (w, case)
        ck = _same_on_every_rank(world, "eng.filtered_checkpoint.vals")
        np.testing.assert_allclose(ck[1], ck[0], rtol=0, atol=1e-12)  # resumed from the world's own file

        # The Exponentiator: tests/test_sharded.py:201 and :417 (2 ranks),
        # then every method against the one-process port at 1e-12 of the
        # state's scale.
        if w == 2:
            cn = world_script.EXPM_N
            dense = np.diag(np.full(cn - 1, -1.0), 1) + np.diag(np.full(cn - 1, -1.0), -1)
            psi = np.zeros(cn, complex)
            psi[cn // 2] = 1.0
            out = _same_on_every_rank(world, "expm.run_complex")
            assert abs(np.linalg.norm(out) - 1.0) < 1e-12
            assert 1.0 - abs(np.vdot(sla.expm(-1.5j * dense) @ psi, out)) < 1e-12
            np.testing.assert_allclose(out, jax_engines["expm.run_complex"], rtol=0, atol=1e-12)
            m = world_script.CHEBY_N
            a = np.diag(np.full(m - 1, -1.0), 1) + np.diag(np.full(m - 1, -1.0), -1)
            truth = sla.expm(3j * a) @ world_script.expm_state(m, 0)
            assert np.linalg.norm(_same_on_every_rank(world, "expm.cheby_f32") - truth) < 5e-6
            assert np.linalg.norm(jax_engines["expm.cheby_f32"] - truth) < 5e-6
            assert np.linalg.norm(_same_on_every_rank(world, "expm.cheby_precise") - truth) < 1e-12
        for key in [k for k in one_process if k.startswith("expm.")]:
            got, want = _same_on_every_rank(world, key), one_process[key]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(np.abs(want).max(), 1.0), err_msg=key)

    # Checkpoints across world sizes: a one-process file resumed on two
    # ranks, and the two ranks' file resumed in one process, each against
    # the uninterrupted one-process run.
    from lanczos_tpu_torch.utils.checkpoint import CheckpointedRun, load_state

    make_dia, _make_bsr = world_script.one_process_ops()
    cn = world_script.CHECKPOINT_N

    def chain():
        return make_dia([-1, 1], [np.full(cn, -1.0)] * 2, cn, torch.float64)

    whole = world_script.checkpoint_engine(chain())
    vals_whole, vecs_whole = whole.run()
    assert len(whole.iteration_counts) > 1
    np.testing.assert_allclose(_same_on_every_rank(outs, "ck.from_one.vals"), vals_whole, rtol=0, atol=1e-12)
    assert list(_same_on_every_rank(outs, "ck.from_one.iters")) == whole.iteration_counts
    np.testing.assert_allclose(np.abs(np.sum(outs[0]["ck.from_one.vecs"] * vecs_whole.numpy(), axis=1)), 1.0,
                               atol=1e-10)
    path = str(refs2["tmpdir"] / "ck_world.npz")
    manager, counts = load_state(path, device="cpu")
    assert len(manager) == 1 and counts == whole.iteration_counts[:1]
    resumed = world_script.checkpoint_engine(chain())
    vals, _vecs = CheckpointedRun(resumed, path).run()
    np.testing.assert_allclose(vals, vals_whole, rtol=0, atol=1e-12)
    assert resumed.iteration_counts == whole.iteration_counts

    rows, cols, vals, n, bm, bk = world_script.pv_problem()
    op = tl.BSROperator.from_coo(rows, cols, vals, n, bm=bm, bk=bk, dtype=torch.float32, device="cpu")
    eng = tl.LambdaLanczos(op, find_maximum=False, num_eigs=2)
    eng.precise_vectors = True
    eng.eps = 1e-12
    eng.init_vector = tl.fixed_seed_initializer(np.float32, seed=world_script.PV_SEED)
    one, one_vecs = eng.run()
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals.astype(np.float32).astype(np.float64))
    truth = np.linalg.eigvalsh(dense)[:2]
    two = _same_on_every_rank(outs, "pv.vals")
    assert np.max(np.abs(np.sort(two) - truth)) < 1e-12 and np.max(np.abs(np.sort(two) - np.sort(one))) < 1e-12
    vecs = _same_on_every_rank(outs, "pv.vecs")
    assert vecs.dtype == np.float32 and vecs.shape == (2, n) == tuple(one_vecs.shape)
    np.testing.assert_allclose(np.abs(np.sum(vecs.astype(np.float64) * one_vecs.double().numpy(), axis=1)), 1.0,
                               atol=1e-6)
    y = _same_on_every_rank(outs, "pv.y64")
    want = dense @ world_script.pattern_x(n)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_mp_demo_two_ranks():
    results = mp_demo.launch(2, n=128, device="cpu", timeout=WORLD_TIMEOUT_S)
    assert [r["process_id"] for r in results] == [0, 1]
    for r in results:
        assert r["world_size"] == 2 and r["backend"] == "gloo"
        assert r["stencil_err"] < 1e-11, r
        assert r["pv_err"] < 1e-12 and r["pv_vec_dtype"] == "torch.float32", r
        # the JAX demo's precise thick part: under a 48-row cap, at 1e-12
        assert r["pv_thick_err"] < 1e-12, r
    keys = ("stencil_val", "stencil_vec_sum", "iteration_counts", "pv_vals", "pv_iteration_counts",
            "pv_thick_vals", "pv_thick_iteration_counts")
    assert {k: results[0][k] for k in keys} == {k: results[1][k] for k in keys}  # the same bits


# ------------------------------------------- dryrun_multichip in the worlds


def _dryrun_truths():
    """Each regime of the JAX dryrun (``__graft_entry__.dryrun_multichip``):
    its values' truths and bars, recomputed here from its seeds; both worlds
    hold two slices of the batch axis."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 64, 64))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    chain = {m: -2.0 * np.cos(np.pi / (m + 1)) for m in (128, 256)}
    return {  # regime: (truth of each value, bar, relative?)
        1: (np.linalg.eigvalsh(a.astype(np.float32).astype(np.float64))[:, -1], 5e-2, True),
        2: ([chain[128]], 5e-2, False), 3: ([chain[256]], 5e-2, False), 4: ([chain[256]], 5e-2, False),
        5: ([chain[128]], 5e-2, False), 6: ([chain[256]] * 2, 5e-2, False), 7: ([chain[256]], 1e-8, False),
        8: ([chain[128]], 1e-8, False), 10: ([1.0, 1.0], np.array([1e-4, 1e-10]), False),
    }


@pytest.mark.parametrize("regime", [1, 2, 3, 4, 5, 6, 7, 8, 10])
@pytest.mark.parametrize("w", [2, 4])
def test_dryrun_multichip_regime(request, w, regime):
    # The port's dryrun_multichip inside the gloo world of w ranks: each
    # regime's values against the JAX dryrun's truth at its bar, and every
    # rank of a solve with the same bits.  Regimes 9 and 11 are left out
    # there (world_script.DRYRUN_SKIP) and recorded as skipped.
    _refs, outs = request.getfixturevalue(f"world{w}")
    by_rank = [{rec["regime"]: rec for rec in json.loads(str(o["dryrun"]))} for o in outs]
    assert all(set(recs) == set(range(1, 12)) for recs in by_rank)
    assert all(by_rank[0][k]["skipped"] for k in world_script.DRYRUN_SKIP)
    rec = by_rank[0][regime]
    assert rec["ok"] and rec["same_bits"] and rec["world"] == w, rec
    # every rank printed the same values (each slice's rows under regimes 1 and 6)
    assert all(recs[regime]["values"] == rec["values"] for recs in by_rank)
    truth, bar, relative = _dryrun_truths()[regime]
    got = np.ravel(rec["values"])
    err = np.abs(got - np.asarray(truth)) / (np.abs(truth) if relative else 1.0)
    assert np.all(err < bar), (regime, got, truth)


# ------------------------------------------- the engines' set in the worlds

# Its cases by group (engine_set.GROUPS) at engine_set.SMALL.
ENGINE_SET_CASES = {
    "f32": ("thick", "block_thick", "checkpoint_resumed"),
    "pv": ("pv_thick",),
    "footprint": ("footprint_main_path", "scattered_gather", "scattered_footprint", "scattered_auto"),
    "bf16": ("bf16_fused", "bf16_precise"),
    "dia": ("filtered_degree64", "evolve_4x0.05i", "chebyshev_5i", "expm_fused_vs_hybrid"),
    "complex": ("complex_main_path", "complex_main_path_auto", "complex_evolve_precise", "complex128_run",
                "complex128_dia_run"),
}


@pytest.fixture(scope="module")
def engine_set_one(tmp_path_factory):
    """``multichip --engines``' set at its CPU size in a one-rank gloo world
    in this process: the one-process run the four ranks are held to."""
    return once("torch_sharded.engine_set_one", tmp_path_factory, _engine_set_one)


def _engine_set_one(tmp: Path):
    import torch.distributed as dist

    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.engine_set import SMALL, engine_set

    assert not dist.is_initialized()
    pmesh.initialize_distributed(backend="gloo", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
    try:
        return engine_set(pmesh.make_mesh(), sizes=SMALL, emit=None, workdir=str(tmp))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("group", list(ENGINE_SET_CASES))
def test_engine_set_four_ranks(world4, engine_set_one, group):
    # The engines' set (engine_set.engine_set, multichip --engines on the
    # cards) at engine_set.SMALL inside the 4-rank gloo world over the plain
    # kernels: every case met its bar inside the set, every rank holds the
    # same bits and recorded the same values, and the values equal the
    # one-process run's: within 1e-12 of their scale for the float64-grade
    # cases (bars <= 1e-10: the precise and complex128 ones), within 1e-6
    # for the float32 ones (float32 sums in another order: four partial
    # sums where one rank makes one).
    _refs, outs = world4
    by_rank = [json.loads(str(o["engine_set"])) for o in outs]
    assert list(by_rank[0]) == [c for cases in ENGINE_SET_CASES.values() for c in cases]
    for case in ENGINE_SET_CASES[group]:
        recs = [r[case] for r in by_rank]
        rec = recs[0]
        assert rec["world"] == 4 and all(r["same_bits"] and r["values"] == rec["values"] for r in recs), case
        one = engine_set_one["complex_main_path" if case == "complex_main_path_auto" else case]
        assert one["world"] == 1 and one["same_bits"]
        got, want = np.asarray(rec["values"]), np.asarray(one["values"])
        tol = 1e-12 if rec["bar"] <= 1e-10 else 1e-6
        assert got.shape == want.shape and np.max(np.abs(got - want)) <= tol * max(np.abs(want).max(), 1.0), (
            case, got, want)
        if "max_err" in rec:
            assert rec["max_err"] <= rec["bar"], rec
        else:
            assert rec.get("angle_to_one_device", rec.get("rel_err_to_hybrid")) <= rec["bar"], rec
    if group == "f32":
        ck = by_rank[0]["checkpoint_resumed"]
        assert ck["saved_counts"] == ck["whole_iteration_counts"][:1] == ck["iteration_counts"][:1]
    if group == "footprint":
        recs = by_rank[0]
        assert recs["footprint_main_path"]["comm"] == "footprint" and recs["footprint_main_path"]["hops"] == [-1, 1]
        assert recs["scattered_gather"]["comm"] == "gather"
        for case in ("scattered_footprint", "scattered_auto"):
            assert recs[case]["comm"] == "footprint" and recs[case]["hops"] == [-2, -1, 1, 2], recs[case]
            assert 4 * recs[case]["words_received_per_matvec"] <= recs[case]["gather_words_received"]
        assert all(engine_set_one[c]["comm"] == "gather" for c in ENGINE_SET_CASES["footprint"])
    if group == "complex":
        assert by_rank[0]["complex_main_path_auto"]["comm"] == "ring"


def test_multichip_launch_ends_a_world_with_a_dead_rank():
    # The launcher's drill: rank 1 exits once the world is up, rank 0 blocks
    # in the dryrun's first collective; the launch kills it and raises.
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[.*\b1\b.*\] failed"):
        multichip.launch(2, device="cpu", timeout=WORLD_TIMEOUT_S, abort_rank=1)
    assert time.monotonic() - t0 < 60


def test_initialize_distributed_fails_loudly():
    script = (
        "import datetime\n"
        "from lanczos_tpu_torch.parallel.mesh import initialize_distributed\n"
        "try:\n"
        "    initialize_distributed(backend='gloo', init_method='tcp://127.0.0.1:1', world_size=2, rank=1,\n"
        "                           timeout=datetime.timedelta(seconds=3))\n"
        "except Exception as e:\n"
        "    print('RAISED:' + type(e).__name__)\n"
        "else:\n"
        "    print('SILENT')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=120)
    assert "SILENT" not in proc.stdout, (proc.stdout, proc.stderr[-1000:])
    assert "RAISED:" in proc.stdout or proc.returncode != 0, (proc.stdout, proc.stderr[-1000:])


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 and NCCL have no CPU mode (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k2_kernel_matches_plain(cuda):
    for dtype, tol in ((np.float32, 1e-6), (np.float64, 1e-12)):
        for case, (r, s, bm, bk, c_rows) in {**K2_CASES, "main": (64, 3, 128, 128, 64), "odd_bk": (5, 4, 16, 6, 7)}.items():
            blocks, cb, x = (torch.from_numpy(a).to(cuda) for a in _random_rsmk(r, s, bm, bk, c_rows, dtype, seed=5))
            before = spmv.bsr_matvec_rsmk.launches
            got = spmv.bsr_matvec_rsmk(blocks, cb, x, n_out=r * bm - 1)
            assert spmv.bsr_matvec_rsmk.launches == before + 1
            want = spmv.bsr_matvec_reference(blocks, cb, x, layout="rsmk")[: r * bm - 1]
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
            assert err <= tol, (case, dtype, err)
    # K2's complex instances (ROADMAP item 13) and K1x-rsmk's complex
    # form: against the plain version, twice bit for bit, counted by dtype.
    rng = np.random.default_rng(6)
    for case, (r, s, bm, bk, c_rows) in {**K2_CASES, "odd_bk": (5, 4, 16, 6, 7), "bk8192": (3, 2, 16, 8192, 2)}.items():
        for tile, xt, tol in ((np.complex64, np.complex64, 1e-5), (np.complex128, np.complex128, 1e-12),
                              (np.complex64, np.complex128, 1e-13)):
            blocks = (rng.standard_normal((r, s, bm, bk)) + 1j * rng.standard_normal((r, s, bm, bk))).astype(tile)
            cb = rng.integers(0, c_rows, (r, s)).astype(np.int32)
            x = (rng.standard_normal(c_rows * bk) + 1j * rng.standard_normal(c_rows * bk)).astype(xt)
            bd, cd, xd = (torch.from_numpy(a).to(cuda) for a in (blocks, cb, x))
            wide = tile != xt
            count = ((lambda: spmv.bsr_matvec_rsmk_c64x128.launches) if wide else
                     (lambda: spmv.bsr_matvec_rsmk.launches_by_dtype[bd.dtype]))
            before = count()
            got, again = spmv.bsr_matvec_rsmk(bd, cd, xd, n_out=r * bm - 1), spmv.bsr_matvec_rsmk(bd, cd, xd)
            torch.cuda.synchronize()
            assert count() == before + 2 and got.dtype == xd.dtype, (case, tile, xt)
            assert torch.equal(got, again[: r * bm - 1])
            want = spmv.bsr_matvec_reference(torch.from_numpy(blocks).to(torch.complex128), torch.from_numpy(cb),
                                             torch.from_numpy(x).to(torch.complex128), layout="rsmk")[: r * bm - 1]
            err = float((got.cpu().to(torch.complex128) - want).abs().max() / want.abs().max())
            assert err <= tol, (case, tile, xt, err)


@pytest.mark.gpu
def test_sharded_solve_nccl_world_of_one(cuda, tmp_path):
    import torch.distributed as dist
    from scipy.linalg import eigvalsh_tridiagonal

    import lanczos_tpu_torch as tl
    from lanczos_tpu_torch.parallel import mesh as pmesh
    from lanczos_tpu_torch.parallel.sharded import ShardedBSROperator

    torch.cuda.set_device(0)
    pmesh.initialize_distributed(backend="nccl", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                                 rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        # A chain with one deep site: its bound state, the one root the
        # engine tracks, converges in a few dozen iterations (the bare
        # chain's edge needs about n).
        n = 4096
        pot = np.zeros(n)
        pot[n // 2] = -3.0
        op = ShardedBSROperator.from_coo(*world_script._chain(n, pot), n, pmesh.make_mesh(), dtype=torch.float64)
        assert op.device.type == "cuda" and op.comm == "gather"
        eng = tl.LambdaLanczos(op, find_maximum=False)
        eng.num_eigs_per_iteration = 1
        eng.init_vector = tl.fixed_seed_initializer(np.float64, seed=5)
        before = spmv.bsr_matvec_rsmk.launches
        val, vec = eng.run_one()
        assert eng._resolve_mode() == "fused" and spmv.bsr_matvec_rsmk.launches > before
        exact = eigvalsh_tridiagonal(pot, -np.ones(n - 1), select="i", select_range=(0, 0))[0]
        assert abs(val - exact) < 1e-10
        assert eng.residuals([val], vec[None])[0] < 1e-8
    finally:
        dist.destroy_process_group()


_MESH_DEVICE_RANK = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from lanczos_tpu_torch.parallel import mesh as pmesh
from lanczos_tpu_torch.utils.random import random_initializer
rank = int(sys.argv[1])
# No set_device first: a launcher that leaves card 0 current on every rank.
pmesh.initialize_distributed(backend="nccl", init_method=sys.argv[2], world_size=2, rank=rank,
                             timeout=datetime.timedelta(seconds=60))
m = pmesh.make_mesh()
draw = random_initializer(np.float64)(4)  # the seed broadcast, on the current device
print(torch.cuda.current_device(), m.device.index, *draw.tolist(), flush=True)
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_make_mesh_makes_the_rank_card_current(cuda, tmp_path):
    # Two NCCL ranks whose launcher sets no card: make_mesh makes each
    # rank's card current, so the seed broadcast runs on two cards (on one
    # card NCCL fails or hangs) and both ranks draw the same vector.
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this host has {torch.cuda.device_count()}")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_DEVICE_RANK, str(r), f"file://{tmp_path / 'rdv'}"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o.strip().splitlines()[-1].split() for o in outs]
    assert [(int(ln[0]), int(ln[1])) for ln in lines] == [(0, 0), (1, 1)], outs
    assert lines[0][2:] == lines[1][2:]


@pytest.mark.gpu
def test_nccl_world_of_four(cuda):
    # The dryrun over four NCCL ranks, one a card, through the module's
    # launcher: every regime at its JAX bar with the same bits on every
    # rank; then the drill, a rank that dies with the world running, ends
    # the launch with an error.
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, this host has {torch.cuda.device_count()}")
    records = multichip.launch(4, timeout=900)
    assert records[0]["phase"] == "world" and records[0]["backend"] == "nccl" and records[0]["world"] == 4
    regimes = {rec["regime"]: rec for rec in records[1:]}
    assert set(regimes) == set(range(1, 12))
    for rec in regimes.values():
        assert rec["ok"] and rec["same_bits"] and "skipped" not in rec, rec
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[.*\b2\b.*\] failed"):
        multichip.launch(4, timeout=300, abort_rank=2)


@pytest.mark.gpu
def test_nccl_engines_world_of_four(cuda, tmp_path):
    # multichip --engines over four NCCL ranks, one a card: every collective
    # kind in every vector dtype, then every case of the engines' set at the
    # one-card phases' widths, each at its bar with the same bits on every
    # rank and its kernel instances launched on every rank; the footprint
    # cases resolve to the footprint.  Apart from test_nccl_world_of_four so
    # that each stays inside its launcher's timeout.  Records print (-s).
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, this host has {torch.cuda.device_count()}")
    from lanczos_tpu_torch.parallel.engine_set import FULL

    records = multichip.launch(4, engines=True, timeout=1500, log_dir=str(tmp_path))
    for rec in records:
        print(json.dumps(rec))
    assert records[0]["phase"] == "world" and records[0]["backend"] == "nccl" and records[0]["world"] == 4
    assert records[1]["phase"] == "multichip_collectives" and records[1]["ok"], records[1]
    cases = {rec["case"]: rec for rec in records if rec.get("phase") == "multichip_engines"}
    want = [c.replace("64", str(FULL.degree)).replace("4x", f"{FULL.steps}x") if c.startswith(("filtered", "evolve"))
            else c for cs in ENGINE_SET_CASES.values() for c in cs]
    assert list(cases) == want and records[-1]["phase"] == "multichip_engines_done"
    for rec in cases.values():
        assert rec["world"] == 4 and rec["same_bits"], rec
        assert all(n > 0 for counts in rec["need"].values() for n in counts), rec
    for case in ("footprint_main_path", "scattered_footprint", "scattered_auto"):
        assert cases[case]["comm"] == "footprint", cases[case]
    assert cases["complex_main_path_auto"]["comm"] == "ring"
