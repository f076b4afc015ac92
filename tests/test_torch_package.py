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

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import _build  # noqa: E402
from lanczos_tpu_torch.ops import cgs, cheby, spmv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, lanczos_tpu_torch, lanczos_tpu_torch.convert;"
        "import lanczos_tpu_torch.solvers.thick_restart, lanczos_tpu_torch.solvers.block_lanczos;"
        "import lanczos_tpu_torch.solvers.block_thick, lanczos_tpu_torch.solvers.filtered;"
        "import lanczos_tpu_torch.ops.cheby, lanczos_tpu_torch.ops.filters, lanczos_tpu_torch.utils.estimate;"
        "from lanczos_tpu_torch import filtered_lanczos;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lanczos_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nvcc_command_targets_hopper_and_names_every_source():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {p.name for p in (REPO / "lanczos_tpu_torch" / "csrc").glob("*.cu")}
    assert {"bsr_spmv.cu", "cgs.cu", "cgs_block.cu", "cheby_chain.cu"} <= {p.name for p in srcs}
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
    y = op.matvec(torch.ones(n, dtype=torch.float64))
    assert y.shape == (n,)
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


@pytest.mark.parametrize(
    "setting",
    [
        {"precise_vectors": True},
        {"precise_vectors": True, "block_size": 2},
        {"precise_vectors": True, "restart_policy": "thick"},
    ],
)
def test_unported_options_raise(setting):
    # The precise-vector engines wait for ROADMAP item 10; the block and
    # thick engines themselves are ported.
    eng = tl.LambdaLanczos(np.eye(4) * 2.0, device="cpu")
    for name, value in setting.items():
        setattr(eng, name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run()


def test_tridiagonal_native_backend_raises():
    eng = tl.LambdaLanczos(np.diag([1.0, 2.0, 3.0, 4.0]), device="cpu")
    eng.tridiag_backend = "native"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run()


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
