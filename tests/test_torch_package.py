"""Hygiene of the PyTorch port: no JAX behind it, every public name of the
JAX package at its module path, the kernel build command, the CPU paths
launching no kernel, the CUDA card as the default device, and the refusals
of what is not ported."""

import ast
import re
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
        "import lanczos_tpu_torch.parallel.mp_demo, lanczos_tpu_torch.parallel.multichip;"
        "import lanczos_tpu_torch.experiments, lanczos_tpu_torch.experiments._timing;"
        "import lanczos_tpu_torch.experiments.bcgs_kernel, lanczos_tpu_torch.experiments.bcgs_kernel2;"
        "import lanczos_tpu_torch.experiments.bcgs_kernel3, lanczos_tpu_torch.experiments.bcgs_k2_tiny;"
        "import lanczos_tpu_torch.experiments.carry_copy_bench, lanczos_tpu_torch.experiments.spmv_bench;"
        "import lanczos_tpu_torch.solvers.exponentiator, lanczos_tpu_torch.solvers.cheby_expm;"
        "from lanczos_tpu_torch import Exponentiator;"
        "import lanczos_tpu_torch.utils.checkpoint, lanczos_tpu_torch.ops.sturm_check, lanczos_tpu_torch.utils.stats;"
        "from lanczos_tpu_torch import COOOperator, CSROperator, SumOperator, ScaledOperator, DenseDFOperator;"
        "import lanczos_tpu_torch.core.df64, lanczos_tpu_torch.samples, lanczos_tpu_torch.solvers.exponentiator_precise;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lanczos_tpu', 'ml_dtypes')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # Nor does any source of the package (the samples run when imported), nor
    # chip_smoke.py: the card's machine has no JAX and no ml_dtypes (bfloat16
    # tiles are carried as their bits, core/types.from_numpy).
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lanczos_tpu|ml_dtypes)(\.|\s|$)", re.M)
    sources = [*(REPO / "lanczos_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    assert not [p for p in sources if jax_import.search(p.read_text())]


# The JAX package's Pallas modules became the CUDA kernels' wrappers, and
# two of their functions carry the kernels' names.
_PORTED_AS = {"ops/pallas_spmv.py": "ops/spmv.py", "ops/pallas_cgs.py": "ops/cgs.py", "ops/pallas_cheby.py": "ops/cheby.py"}
_RENAMED = {("ops/pallas_spmv.py", "bsr_matvec_pallas_t"): "bsr_matvec",
            ("ops/pallas_spmv.py", "bsr_matvec_pallas"): "bsr_matvec_rsmk"}
# Deliberate non-ports, each with its reason: a module-level name, "*"
# (the whole module), "Class.member", "*.member" (every class of the
# module) or "function(keyword=)" / "Class.method(keyword=)".
_DF64 = "double-float words stand in for float64, which the card has (ROADMAP item 10)"
_PYTREE = "JAX pytree registration: the port's operators are plain Python objects"
_PALLAS = "the TPU's Pallas/XLA choice: the wrappers dispatch on the tensor's device"
_INTERPRET = "Pallas interpret mode: the plain versions run on CPU tensors"
_VMEM = "the TPU's VMEM tiling: the CUDA kernels plan their own tiles"
_AXES = "jax.sharding mesh axes and device lists: a process group has ranks, not named axes or devices"
_NOT_PORTED = {
    "__init__.py": {"enable_compilation_cache": "XLA's compilation cache"},
    "core/df64.py": dict.fromkeys(("two_sum", "two_prod", "df_add", "df_sub", "df_mul", "df_recip", "df_sqrt",
                                   "df_sum", "df_sum_axis", "dot_df", "df_matmul", "df_split", "df_join"), _DF64),
    "core/linalg.py": {**dict.fromkeys(("inner_prod_df", "inner_prod_df_df", "orthogonalize_cgs2_df",
                                        "orthogonalize_cgs2_df_coeffs", "orthogonalize_cgs2_dfdf_coeffs"), _DF64),
                       "orthogonalize_bcgs_dyn(chunk=)": _VMEM, "orthogonalize_bcgs_dyn(use_pallas=)": _PALLAS,
                       "orthogonalize_bcgs_dyn_coeffs(chunk=)": _VMEM},
    "core/tridiagonal.py": {"extremal_eigenvalues_device_df": _DF64},
    "native/build.py": {"shared_object_path(build=)": "the port builds a missing library at first use; "
                                                      "library_path() names it without building"},
    "ops/filters.py": {"*.tree_flatten": _PYTREE, "*.tree_unflatten": _PYTREE},
    "ops/hermitian_split.py": {"*.tree_flatten": _PYTREE, "*.tree_unflatten": _PYTREE},
    "ops/operators.py": {"*.tree_flatten": _PYTREE, "*.tree_unflatten": _PYTREE, "BSROperator.use_pallas": _PALLAS,
                         "BSROperator.from_coo(use_pallas=)": _PALLAS},
    "ops/pallas_cgs.py": {"pallas_cgs_fits": "the TPU dispatch test: the wrappers dispatch on the tensor's device",
                          "cgs_pass(chunk=)": _VMEM, "cgs_pass(interpret=)": _INTERPRET,
                          "cgs_pass_block(chunk=)": _VMEM, "cgs_pass_block(interpret=)": _INTERPRET},
    "ops/pallas_cheby.py": {"cheby_chain_apply(interpret=)": _INTERPRET, "cheby_chain_apply(s=)": _VMEM,
                            "cheby_chain_fits(s=)": _VMEM, "cheby_chain_fits(itemsize=)": _VMEM},
    "ops/pallas_spmv.py": {"bsr_matvec_pallas(interpret=)": _INTERPRET, "bsr_matvec_pallas_t(interpret=)": _INTERPRET,
                           "bsr_matvec_pallas_t(blocks_t=)": "the Pallas kernel's pre-transposed tiles: K1 streams "
                                                             "the rmsk tiles it is given as blocks"},
    "parallel/mesh.py": {"row_sharding": _AXES, "replicated_sharding": _AXES, "make_mesh(axis_name=)": _AXES,
                         "make_mesh(devices=)": _AXES, "make_multislice_mesh(devices=)": _AXES,
                         "make_multislice_mesh(dcn_axis=)": _AXES, "make_multislice_mesh(ici_axis=)": _AXES,
                         "pad_to_multiple(axis_name=)": _AXES, "shard_vector(axis_name=)": _AXES,
                         "shard_dense_operator(axis_name=)": _AXES, "shard_dense_operator_2d(mesh=)": _AXES,
                         "shard_dense_operator_2d(row_axis=)": _AXES, "shard_dense_operator_2d(col_axis=)": _AXES},
    "parallel/mp_demo.py": {"launch(local_devices=)": "virtual CPU devices per JAX process: a rank holds one device"},
    "parallel/sharded.py": {"*.tree_flatten": _PYTREE, "*.tree_unflatten": _PYTREE, "*.axis_name": _AXES,
                            "ShardedBSROperator.from_coo(axis_name=)": _AXES,
                            "ShardedDIAOperator.from_diagonals(axis_name=)": _AXES,
                            "shard_operator(axis_name=)": _AXES},
    "solvers/block_thick.py": {"block_thick_iteration_fused_pv": _DF64},
    "solvers/cheby_expm.py": dict.fromkeys(("chebyshev_expm_apply_hermitian(split_op=)",
                                            "chebyshev_expm_grid_hermitian(split_op=)"),
                                           "the port's first argument is op, a complex operator or a split one"),
    "solvers/thick_restart.py": {"thick_lanczos_iteration_fused_pv": _DF64},
    "utils/compile_cache.py": {"*": "XLA's compilation cache"},
}


def _public_names(path):
    """A module's ``__all__``, else its top-level public functions and
    classes, read from the source."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _bound_names(path):
    """Every name a module binds at its top level (definitions, assignments,
    imports), and a package's submodules."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    if path.name == "__init__.py":
        names |= {p.stem for p in path.parent.glob("*.py")} | {p.name for p in path.parent.iterdir() if p.is_dir()}
    return names


def _definitions(path):
    return {n.name: n for n in ast.parse(path.read_text()).body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _keywords(fn):
    """A function's parameter names but self and cls, and whether it takes
    ``**kwargs``."""
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} - {"self", "cls"}, a.kwarg is not None


def _members(cls, classes=None):
    """A class's public members (and ``__init__``): methods and properties
    (not their setters), class attributes and dataclass fields, each with
    its function or None.  Given ``classes`` (the port's classes by name),
    also what its methods store on ``self`` and what it inherits."""
    out = {}
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            if not any(isinstance(d, ast.Attribute) and d.attr in ("setter", "deleter") for d in node.decorator_list):
                out[node.name] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = None
        elif isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
    if classes is not None:
        for node in ast.walk(cls):
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self"
                    and isinstance(node.ctx, ast.Store)):
                out.setdefault(node.attr, None)
        for base in cls.bases:
            base = classes.get(getattr(base, "id", getattr(base, "attr", None)))
            if base is not None and base is not cls:
                for name, fn in _members(base, classes).items():
                    out.setdefault(name, fn)
    return {k: v for k, v in out.items() if not k.startswith("_") or k == "__init__"}


def _member_gaps(jax_root, port_root):
    """The public members and keyword arguments of the JAX package's public
    classes and functions that their counterparts in the port lack, as
    ``rel:Class.member``, ``rel:function(kw=)`` and
    ``rel:Class.method(kw=)``."""
    classes = {}
    for path in port_root.rglob("*.py"):
        for name, node in _definitions(path).items():
            if isinstance(node, ast.ClassDef):
                classes.setdefault(name, node)
    gaps = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        target = port_root / _PORTED_AS.get(rel, rel)
        if not target.exists():
            continue
        jax_defs, port_defs = _definitions(path), _definitions(target)
        for name in sorted(_public_names(path)):
            j, p = jax_defs.get(name), port_defs.get(_RENAMED.get((rel, name), name))
            pairs = []
            if isinstance(j, ast.ClassDef) and isinstance(p, ast.ClassDef):
                jm, pm = _members(j), _members(p, classes)
                gaps += [f"{rel}:{name}.{m}" for m in sorted(set(jm) - set(pm))]
                pairs = [(f"{name}.{m}", jm[m], pm[m]) for m in sorted(set(jm) & set(pm))
                         if jm[m] is not None and isinstance(pm[m], ast.FunctionDef)]
            elif isinstance(j, ast.FunctionDef) and isinstance(p, ast.FunctionDef):
                pairs = [(name, j, p)]
            for label, jf, pf in pairs:
                (want, _), (have, var) = _keywords(jf), _keywords(pf)
                if not var:
                    gaps += [f"{rel}:{label}({k}=)" for k in sorted(want - have)]
    return gaps


def _listed(gap):
    """The entry of ``_NOT_PORTED`` that covers a member gap, else None."""
    rel, name = gap.split(":", 1)
    entries = _NOT_PORTED.get(rel, {})
    if name in entries:
        return name
    if "(" not in name and f"*.{name.split('.', 1)[-1]}" in entries:
        return f"*.{name.split('.', 1)[-1]}"
    return None


def test_every_jax_public_name_has_a_counterpart():
    # Every public name of every JAX module at its path in the port, and
    # every public member and keyword argument of its public classes and
    # functions, but the deliberate non-ports.
    jax_root, port_root = REPO / "lanczos_tpu", REPO / "lanczos_tpu_torch"
    missing = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        skip = _NOT_PORTED.get(rel, {})
        if "*" in skip:
            continue
        target = port_root / _PORTED_AS.get(rel, rel)
        have = _bound_names(target) if target.exists() else set()
        missing += [f"{rel}:{name}" for name in sorted(_public_names(path) - set(skip))
                    if _RENAMED.get((rel, name), name) not in have]
    gaps = _member_gaps(jax_root, port_root)
    missing += [gap for gap in gaps if _listed(gap) is None]
    assert not missing, missing
    # The list of non-ports names only what the JAX package has and the
    # port lacks: JAX public names, and members and keywords that are gaps.
    used = {(gap.split(":", 1)[0], _listed(gap)) for gap in gaps}
    for rel, names in _NOT_PORTED.items():
        assert (jax_root / rel).exists(), rel
        plain = {n for n in names if n != "*" and "." not in n and "(" not in n}
        assert plain <= _public_names(jax_root / rel), rel
        assert {(rel, n) for n in set(names) - plain - {"*"}} <= used, (rel, sorted(set(names) - plain - {"*"}))


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


@pytest.mark.parametrize("member", ["bsr_sizes", "dia_ndiag", "dia_to_dense", "fused_krylov_precise_vectors"])
def test_members_match_the_jax_package(member):
    # The members the parity check found missing, ported: each against the
    # JAX package's on the same numpy data.
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import lanczos_tpu
    from lanczos_tpu.solvers.lanczos_fused import fused_krylov as jax_fused

    from lanczos_tpu_torch.solvers.lanczos_fused import fused_krylov

    n = 70
    rng = np.random.default_rng(8)
    if member == "bsr_sizes":  # rectangular tiles tell bm from bk
        rows, cols = rng.integers(0, n, 300), rng.integers(0, n, 300)
        vals = rng.standard_normal(300)
        ours = tl.BSROperator.from_coo(rows, cols, vals, n, bm=8, bk=16, dtype=torch.float32, device="cpu")
        theirs = lanczos_tpu.BSROperator.from_coo(rows, cols, vals, n, bm=8, bk=16, dtype=jnp.float32)
        names = ("bm", "bk", "s_max", "n_padded", "nnz_dense", "layout")
        assert [getattr(ours, k) for k in names] == [getattr(theirs, k) for k in names]
        return
    diags = [rng.standard_normal(n) for _ in range(3)]
    ours = tl.DIAOperator.from_diagonals([-2, 0, 3], diags, n, device="cpu")
    theirs = lanczos_tpu.DIAOperator.from_diagonals([-2, 0, 3], diags, n)
    if member == "dia_ndiag":
        assert ours.ndiag == theirs.ndiag == 3
    elif member == "dia_to_dense":
        dense = ours.to_dense()
        assert dense.dtype == torch.float64 and dense.device.type == "cpu"
        np.testing.assert_array_equal(dense.numpy(), np.asarray(theirs.to_dense()))
    else:  # the full space (eps < 0: never stop) of a float32 chain with a potential, over a float64 basis
        n = 64
        pot = rng.uniform(0.0, 1.0, n).astype(np.float32)
        off = np.full(n, -1.0, np.float32)
        v0 = rng.choice([-0.125, 0.125], n).astype(np.float32)  # a unit norm in float32 and float64 alike
        exact = np.linalg.eigvalsh(np.diag(pot.astype(np.float64)) - np.eye(n, k=1) - np.eye(n, k=-1))[:2]
        evs = []
        for pkg, fused, conv in ((lanczos_tpu, jax_fused, jnp.asarray),
                                 (tl, fused_krylov, lambda a: torch.from_numpy(np.asarray(a)))):
            kw = {"device": "cpu"} if pkg is tl else {}
            op = pkg.DIAOperator.from_diagonals([-1, 0, 1], [off, pot, off], n, **kw)
            u, alpha, beta, itern, ev = fused(op, conv(v0), conv(np.zeros((1, n), np.float32)),
                                              conv(np.zeros(1, np.float32)), -1.0, 0.0, nroot=2, m_cap=n,
                                              find_maximum=False, precise_vectors=True)
            assert np.asarray(u).dtype == np.float32  # the storage dtype, as in JAX
            evs.append(np.sort(np.asarray(ev, np.float64)))
        # The check's values (a multisection's resolution) in both packages,
        # and the port's float64 tridiagonal exact to float64's rounding.
        assert np.max(np.abs(np.asarray(evs) - exact)) < 1e-7
        m = int(itern)
        t = np.diag(alpha[:m].numpy()) + np.diag(beta[: m - 1].numpy(), 1) + np.diag(beta[: m - 1].numpy(), -1)
        assert alpha.dtype == torch.float64 and np.max(np.abs(np.linalg.eigvalsh(t)[:2] - exact)) < 1e-12


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
