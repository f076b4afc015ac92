"""The row-partitioned path of the PyTorch port (``lanczos_tpu_torch.parallel``)
and kernel K2 (canonical-layout BSR SpMV), against the JAX package.

Kernel K2's plain version is held against ``bsr_matvec_pallas`` in interpret
mode.  The multi-rank checks run in spawned gloo worlds of 2 and 4 ranks on
the CPU (``tests/torch_sharded_world.py``, one spawn per world size, each
under a timeout) and are compared with the JAX package's sharded operators
and solves on meshes of as many of the conftest's virtual devices, built
once per module from the same numpy inputs.  Everything is float64; the
tolerances are stated where they are used.  The card's tests (``gpu``
marker) run K2 against its plain version and a one-rank NCCL solve.
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_sharded_world as world_script  # noqa: E402

from lanczos_tpu_torch.ops import spmv  # noqa: E402
from lanczos_tpu_torch.parallel import mp_demo  # noqa: E402

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
    """The JAX package's results for every check of a world of ``w`` ranks,
    and the packed arrays the world converts."""
    import jax.numpy as jnp
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.parallel.sharded import ShardedBSROperator, ShardedDIAOperator, shard_operator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    mesh = _jax_mesh(w)
    refs, inputs = {}, {}
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
            y_key = f"{name}.{op.comm}.y_jax"
            if y_key not in refs:
                refs[y_key] = np.asarray(op.matvec(jnp.asarray(x)))
            refs[f"{key}.y"] = refs[y_key]
            inputs[f"{key}.blocks"] = np.asarray(op.blocks)
            inputs[f"{key}.col_blocks"] = np.asarray(op.col_blocks)

    offsets, diags, n = world_script.dia_problem()
    op = ShardedDIAOperator.from_diagonals(offsets, diags, n, mesh)
    refs["dia.y"] = np.asarray(op.matvec(jnp.asarray(world_script.pattern_x(n))))
    dense = np.zeros((n, n))
    for d, diag in zip(offsets, diags):
        i = np.arange(max(0, -d), min(n, n - d))
        dense[i, i + d] = diag[i]
    refs["dia.dense_y"] = dense @ world_script.pattern_x(n)
    inputs["dia.offsets"] = np.asarray(op.offsets)
    inputs["dia.data"] = np.asarray(op.data)

    if w == 4:
        n = world_script.SOLVE_N
        ops = {
            "bsr": ShardedBSROperator.from_coo(*world_script._chain(n), n, mesh, dtype=jnp.float64),
            "dia": ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, mesh),
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
    else:
        eng = LambdaLanczos(shard_operator(DenseOperator(jnp.asarray(world_script.dense_problem())), mesh),
                            find_maximum=True)
        eng.init_vector = fixed_seed_initializer(np.float64, seed=42)
        refs["dense.val"] = float(eng.run_one()[0])
    return refs, inputs


def _spawn_world(w, tmp: Path, inputs: dict) -> list[dict]:
    """Run ``tests/torch_sharded_world.py`` as ``w`` gloo ranks; every rank's
    outputs, in rank order.  All ranks are killed if one fails or the world
    outlives WORLD_TIMEOUT_S."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, str(HERE / "torch_sharded_world.py"), str(r), str(w), str(tmp / "rendezvous"),
                          str(tmp / "inputs.npz"), str(tmp / f"out{r}.npz")],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(w)
    ]
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=WORLD_TIMEOUT_S)
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
    for r in range(w):
        with np.load(tmp / f"out{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def _world(w, tmp_path_factory):
    refs, inputs = _jax_refs(w)
    return refs, _spawn_world(w, tmp_path_factory.mktemp(f"world{w}"), inputs)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


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


# -------------------------------------------------- API around the world


def test_shard_operator_dense(world2):
    refs, outs = world2
    val = float(_same_on_every_rank(outs, "dense.val"))
    assert abs(val - np.linalg.eigvalsh(world_script.dense_problem())[-1]) < 1e-10
    assert abs(val - refs["dense.val"]) < 1e-10
    assert float(_same_on_every_rank(outs, "dense.residual")) < 1e-8
    assert "cannot auto-shard BSROperator" in str(_same_on_every_rank(outs, "dense.bsr_refused"))


def test_seed_broadcast_and_second_initialization(world2):
    _refs, outs = world2
    draws = _same_on_every_rank(outs, "seed.draws")  # rank 0's entropy, broadcast
    assert draws.shape == (2, 16) and not np.array_equal(draws[0], draws[1])
    assert int(_same_on_every_rank(outs, "noop.world")) == 2


def test_unsupported_engines_raise(world2):
    _refs, outs = world2
    for name in ("thick", "block", "filtered"):
        assert "item 13" in str(_same_on_every_rank(outs, f"refused.{name}")), name
    for name in ("precise", "matvec_df"):
        assert "item 10" in str(_same_on_every_rank(outs, f"refused.{name}")), name


def test_mp_demo_two_ranks():
    results = mp_demo.launch(2, n=128, device="cpu", timeout=WORLD_TIMEOUT_S)
    assert [r["process_id"] for r in results] == [0, 1]
    for r in results:
        assert r["world_size"] == 2 and r["backend"] == "gloo"
        assert r["stencil_err"] < 1e-11, r
        assert "item 10" in r["pv_thick"]
    keys = ("stencil_val", "stencil_vec_sum", "iteration_counts")
    assert {k: results[0][k] for k in keys} == {k: results[1][k] for k in keys}  # the same bits


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
