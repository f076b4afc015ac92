"""Hygiene of the PyTorch port: no JAX behind it, the kernel build command,
the CPU paths launching no kernel, the CUDA card as the default device, and
the refusals of what is not ported."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_jax_release import release_jax_executables  # noqa: E402,F401

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import _build  # noqa: E402
from lanczos_tpu_torch.ops import cgs, cheby, spmv, sturm_check  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, lanczos_tpu_torch, lanczos_tpu_torch.convert;"
        "import lanczos_tpu_torch.solvers.thick_restart, lanczos_tpu_torch.solvers.block_lanczos;"
        "import lanczos_tpu_torch.solvers.block_thick, lanczos_tpu_torch.solvers.filtered;"
        "import lanczos_tpu_torch.ops.cheby, lanczos_tpu_torch.ops.filters, lanczos_tpu_torch.utils.estimate;"
        "from lanczos_tpu_torch import filtered_lanczos;"
        "import lanczos_tpu_torch.parallel, lanczos_tpu_torch.parallel.mesh, lanczos_tpu_torch.parallel.sharded;"
        "import lanczos_tpu_torch.parallel.mp_demo;"
        "import lanczos_tpu_torch.experiments, lanczos_tpu_torch.experiments._timing;"
        "import lanczos_tpu_torch.experiments.bcgs_kernel, lanczos_tpu_torch.experiments.bcgs_kernel2;"
        "import lanczos_tpu_torch.experiments.bcgs_kernel3, lanczos_tpu_torch.experiments.bcgs_k2_tiny;"
        "import lanczos_tpu_torch.experiments.carry_copy_bench, lanczos_tpu_torch.experiments.spmv_bench;"
        "import lanczos_tpu_torch.solvers.exponentiator, lanczos_tpu_torch.solvers.cheby_expm;"
        "from lanczos_tpu_torch import Exponentiator;"
        "import lanczos_tpu_torch.utils.checkpoint, lanczos_tpu_torch.ops.sturm_check, lanczos_tpu_torch.utils.stats;"
        "from lanczos_tpu_torch import COOOperator, CSROperator, SumOperator, ScaledOperator, DenseDFOperator;"
        "import lanczos_tpu_torch.core.df64;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lanczos_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nvcc_command_targets_hopper_and_names_every_source():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {p.name for p in (REPO / "lanczos_tpu_torch" / "csrc").glob("*.cu")}
    assert {"bsr_spmv.cu", "cgs.cu", "cgs_block.cu", "cheby_chain.cu", "cgs_variants.cu", "row_set.cu",
            "spmv_variants.cu", "sturm_check.cu"} <= {
        p.name for p in srcs
    }
    nvcc = "/usr/local/cuda/bin/nvcc"
    objs = [f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):  # one compiler per source, run side by side
        cmd = _build.nvcc_compile_command(src, obj, nvcc=nvcc)
        assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
        assert "-c" in cmd and "-O3" in cmd and "-std=c++17" in cmd and str(src) in cmd
        assert not any(c.startswith("-I") for c in cmd)  # plain C interface: no PyTorch headers
    cmd = _build.nvcc_link_command(objs, "out.so", nvcc=nvcc)
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert "-shared" in cmd and all(o in cmd for o in objs)
    # the library name follows the sources
    assert _build._library_path(srcs).parent == _build.BUILD_DIR


def test_cpu_paths_launch_no_kernel():
    n = 40
    i = np.arange(n - 1)
    rows, cols = np.concatenate([i, i + 1]), np.concatenate([i + 1, i])
    op = tl.BSROperator.from_coo(rows, cols, -np.ones(2 * (n - 1)), n, bm=8, bk=8, dtype=torch.float64, device="cpu")
    k1, k3, k4 = spmv.bsr_matvec.launches, cgs.cgs_pass.launches, cgs.cgs_pass_block.launches
    k5 = cheby.cheby_chain_apply.launches
    k2 = spmv.bsr_matvec_rsmk.launches
    k6 = sturm_check.sturm_check.launches
    y = op.matvec(torch.ones(n, dtype=torch.float64))
    assert y.shape == (n,)
    rsmk = op.blocks.permute(0, 2, 1, 3).contiguous()
    assert torch.equal(spmv.bsr_matvec_rsmk(rsmk, op.col_blocks, torch.ones(op.n_padded, dtype=torch.float64))[:n], y)
    eng = tl.LambdaLanczos(op, mode="fused")
    eng.run()
    eng = tl.LambdaLanczos(op, num_eigs=2)
    eng.block_size = 2
    eng.restart_policy = "thick"
    eng.run()
    dia = tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, device="cpu")
    tl.filtered_lanczos(dia, degree=32, mu=0.05, lo=-2.0, hi=2.0,
                        configure=lambda e: setattr(e.operator, "use_fused", True))
    assert spmv.bsr_matvec.launches == k1
    assert cgs.cgs_pass.launches == k3
    assert cgs.cgs_pass_block.launches == k4
    assert cheby.cheby_chain_apply.launches == k5
    assert spmv.bsr_matvec_rsmk.launches == k2
    assert sturm_check.sturm_check.launches == k6  # the fused engine's checks took the plain version


def _pv_chain(pkg, n, nb=None):
    """The JAX pv tests' DIA problems in either package (float32 storage):
    the -1 chain, or with ``nb`` its block-diagonal copies of the nb-site
    chain (every eigenvalue of multiplicity n/nb); the analytic values."""
    off = np.ones(n - 1, np.float32)
    if nb is not None:
        off[nb - 1 :: nb] = 0.0
    diags = [np.concatenate([[0.0], -off]).astype(np.float32), np.concatenate([-off, [0.0]]).astype(np.float32)]
    kw = {"device": "cpu"} if pkg is tl else {}
    op = pkg.DIAOperator.from_diagonals([-1, 1], diags, n, **kw)
    m = n if nb is None else nb
    return op, np.sort(-2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1)))


@pytest.mark.parametrize(
    "setting",
    [
        {"precise_vectors": True},
        {"precise_vectors": True, "block_size": 3, "restart_policy": "thick"},
        {"precise_vectors": True, "restart_policy": "thick"},
    ],
)
def test_unported_options_raise(setting):
    # The precise-vector engines (ROADMAP item 10, ported): the fused,
    # block-thick and thick engines over a float64 basis against the JAX
    # package's double-float engines on the JAX tests' problems
    # (tests/test_lanczos.py::test_precise_vectors_reference_grade_f32,
    # tests/test_precise_thick.py::test_pv_block_thick_degenerate and
    # ::test_pv_thick_matches_pv_plain_on_chain), each at the JAX bar
    # against the analytic values and within 2e-12 (1e-10 restarted) of
    # the JAX values; the JAX guards stay.
    pytest.importorskip("jax")
    import lanczos_tpu

    from lanczos_tpu.utils.random import fixed_seed_initializer as jax_seeded

    block = setting.get("block_size", 1) > 1
    thick = setting.get("restart_policy") == "thick"
    if block:  # three copies of the multiplicity-4 lowest value
        n, nb, num_eigs, eps, bar, agree = 512, 128, 3, 1e-12, 1e-10, 1e-10
        extra = {"eigenvalue_offset": -4.0, "max_iteration": 96, "max_restarts": 32}
    elif thick:
        n, nb, num_eigs, eps, bar, agree = 256, None, 2, 1e-13, 1e-11, 1e-10
        extra = {"eigenvalue_offset": -4.0, "max_iteration": 40}
    else:  # runs to space exhaustion
        n, nb, num_eigs, eps, bar, agree = 256, None, 2, 1e-13, 1e-12, 2e-12
        extra = {}
    found = []
    for pkg, seeded in ((lanczos_tpu, jax_seeded), (tl, tl.fixed_seed_initializer)):
        op, exact = _pv_chain(pkg, n, nb)
        kw = {"device": "cpu"} if pkg is tl else {}
        eng = pkg.LambdaLanczos(op, find_maximum=False, num_eigs=num_eigs, dtype=np.float32, mode="fused", **kw)
        for name, value in {**setting, **extra}.items():
            setattr(eng, name, value)
        eng.eps = eps
        if block:
            rng = np.random.default_rng(3)  # distinct start rows, the same in both packages
            eng.init_vector = lambda n_, rng=rng: rng.uniform(-1.0, 1.0, n_).astype(np.float32)
        else:
            eng.init_vector = seeded(np.float32, seed=7)
        vals, vecs = eng.run()
        found.append(np.sort(np.asarray(vals, np.float64)))
        truth = np.full(num_eigs, exact[0]) if block else exact[:num_eigs]
        assert np.max(np.abs(found[-1] - truth)) < bar, (pkg.__name__, found[-1] - truth)
        assert eng.stats.unconverged_rounds == 0
    assert vecs.dtype == torch.float32 and vecs.shape == (num_eigs, n)  # the storage dtype, as in JAX
    assert np.max(np.abs(found[1] - found[0])) < agree
    if not (block or thick):
        # The JAX guards: hybrid mode and the plain block engine refuse,
        # complex storage is refused.
        a = np.eye(8, dtype=np.float32)
        for kwargs, attrs, error in (({"mode": "hybrid"}, {}, ValueError), ({}, {"block_size": 2}, ValueError),
                                     ({"dtype": np.complex64}, {}, TypeError)):
            eng = tl.LambdaLanczos(a.astype(kwargs.get("dtype", np.float32)), device="cpu", **kwargs)
            eng.precise_vectors = True
            for name, value in attrs.items():
                setattr(eng, name, value)
            with pytest.raises(error):
                eng.run()


def test_tridiagonal_native_backend_solves():
    # The port's own g++ build of the native QL solver, with no QL block
    # left unconverged.
    eng = tl.LambdaLanczos(np.diag([1.0, 2.0, 3.0, 4.0]), device="cpu")
    eng.tridiag_backend = "native"
    val, vec = eng.run_one()
    assert abs(val - 1.0) < 1e-13
    assert abs(abs(float(vec[0])) - 1.0) < 1e-13
    assert eng.stats.tridiag_unconverged == 0


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        tl.LambdaLanczos(np.ones((3, 4)), device="cpu")
    with pytest.raises(ValueError):
        tl.LambdaLanczos(lambda x: x)  # matrix-free needs size and dtype
    with pytest.raises(ValueError):
        tl.LambdaLanczos(np.eye(3), mode="gpu", device="cpu").run()
    blocks = torch.zeros((2, 4, 1, 4))
    with pytest.raises(ValueError):
        spmv.bsr_matvec(blocks, torch.zeros((2, 1), dtype=torch.int32), torch.zeros(9))
    with pytest.raises(ValueError):
        cgs.cgs_pass(torch.zeros(5), torch.zeros((3, 4)), 1)
    with pytest.raises(TypeError):
        tl.BSROperator.from_coo([0], [0], np.array([1j]), 4, bm=4, bk=4, device="cpu")
    with pytest.raises(ValueError):
        cgs.cgs_pass_block(torch.zeros((2, 5)), torch.zeros((3, 4)), 1)
    with pytest.raises(ValueError):
        tl.DIAOperator([-1, 1], torch.zeros((2, 5)), 4)


def test_matrix_free_operator_on_cpu():
    n = 30

    def mv(x):
        return -torch.roll(x, 1) - torch.roll(x, -1)

    eng = tl.LambdaLanczos(mv, n, dtype=np.float64, device="cpu")
    eng.init_vector = tl.fixed_seed_initializer(np.float64)
    val, vec = eng.run_one()
    assert abs(val + 2.0) < 1e-12
    assert eng.residuals([val], vec[None])[0] < 1e-10


def _chain(n=16):
    i = np.arange(n - 1)
    return np.concatenate([i, i + 1]), np.concatenate([i + 1, i]), -np.ones(2 * (n - 1)), n


DEFAULT_DEVICE_CONSTRUCTIONS = {
    "bsr_from_coo": lambda: tl.BSROperator.from_coo(*_chain(), bm=8, bk=8, dtype=torch.float64),
    "dense": lambda: tl.DenseOperator(np.eye(4)),
    "dia_from_diagonals": lambda: tl.DIAOperator.from_diagonals([-1, 1], [-np.ones(16)] * 2, 16),
    "function": lambda: tl.FunctionOperator(lambda x: x, 4, torch.float64),
    "lambda_lanczos": lambda: tl.LambdaLanczos(np.eye(4)),
}


def test_default_device_without_cuda_raises():
    # Host data goes to the card unless the caller asks for the CPU; with no
    # card every such construction fails instead of landing on the CPU.
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device (see test_default_device_is_the_card)")
    for what, construct in DEFAULT_DEVICE_CONSTRUCTIONS.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            construct()
            pytest.fail(f"{what} built without a CUDA device")


def test_explicit_cpu_device_and_operator_device_kept():
    op = tl.BSROperator.from_coo(*_chain(), bm=8, bk=8, dtype=torch.float64, device="cpu")
    assert op.device.type == "cpu"
    eng = tl.LambdaLanczos(op, device="cuda")  # an operator keeps its own device
    assert eng.operator is op
    assert tl.DenseOperator(torch.eye(3), device="cpu").device.type == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_default_device_is_the_card(cuda):
    for what, construct in DEFAULT_DEVICE_CONSTRUCTIONS.items():
        obj = construct()
        op = obj.operator if isinstance(obj, tl.LambdaLanczos) else obj
        assert op.device.type == "cuda", what
