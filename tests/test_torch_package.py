"""Hygiene of the PyTorch port: no JAX behind it, the kernel build command,
the CPU paths launching no kernel, and the refusals of what is not ported."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import lanczos_tpu_torch as tl  # noqa: E402
from lanczos_tpu_torch import _build  # noqa: E402
from lanczos_tpu_torch.ops import cgs, spmv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, lanczos_tpu_torch, lanczos_tpu_torch.convert;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lanczos_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nvcc_command_targets_hopper_and_names_every_source():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {p.name for p in (REPO / "lanczos_tpu_torch" / "csrc").glob("*.cu")}
    assert {"bsr_spmv.cu", "cgs.cu"} <= {p.name for p in srcs}
    cmd = _build.nvcc_command(srcs, "out.so", nvcc="/usr/local/cuda/bin/nvcc")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert all(str(s) in cmd for s in srcs)
    assert not any(c.startswith("-I") for c in cmd)  # plain C interface: no PyTorch headers
    # the library name follows the sources
    assert _build._library_path(srcs).parent == _build.BUILD_DIR


def test_cpu_paths_launch_no_kernel():
    n = 40
    i = np.arange(n - 1)
    rows, cols = np.concatenate([i, i + 1]), np.concatenate([i + 1, i])
    op = tl.BSROperator.from_coo(rows, cols, -np.ones(2 * (n - 1)), n, bm=8, bk=8, dtype=torch.float64)
    k1, k3 = spmv.bsr_matvec.launches, cgs.cgs_pass.launches
    y = op.matvec(torch.ones(n, dtype=torch.float64))
    assert y.shape == (n,)
    eng = tl.LambdaLanczos(op, mode="fused")
    eng.run()
    assert spmv.bsr_matvec.launches == k1
    assert cgs.cgs_pass.launches == k3


@pytest.mark.parametrize(
    "setting",
    [("precise_vectors", True), ("block_size", 2), ("restart_policy", "thick")],
)
def test_unported_options_raise(setting):
    eng = tl.LambdaLanczos(np.eye(4) * 2.0)
    setattr(eng, *setting)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run()


def test_tridiagonal_native_backend_raises():
    eng = tl.LambdaLanczos(np.diag([1.0, 2.0, 3.0, 4.0]))
    eng.tridiag_backend = "native"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run()


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        tl.LambdaLanczos(np.ones((3, 4)))
    with pytest.raises(ValueError):
        tl.LambdaLanczos(lambda x: x)  # matrix-free needs size and dtype
    with pytest.raises(ValueError):
        tl.LambdaLanczos(np.eye(3), mode="gpu").run()
    blocks = torch.zeros((2, 4, 1, 4))
    with pytest.raises(ValueError):
        spmv.bsr_matvec(blocks, torch.zeros((2, 1), dtype=torch.int32), torch.zeros(9))
    with pytest.raises(ValueError):
        cgs.cgs_pass(torch.zeros(5), torch.zeros((3, 4)), 1)
    with pytest.raises(TypeError):
        tl.BSROperator.from_coo([0], [0], np.array([1j]), 4, bm=4, bk=4)


def test_matrix_free_operator_on_cpu():
    n = 30

    def mv(x):
        return -torch.roll(x, 1) - torch.roll(x, -1)

    eng = tl.LambdaLanczos(mv, n, dtype=np.float64)
    eng.init_vector = tl.fixed_seed_initializer(np.float64)
    val, vec = eng.run_one()
    assert abs(val + 2.0) < 1e-12
    assert eng.residuals([val], vec[None])[0] < 1e-10
