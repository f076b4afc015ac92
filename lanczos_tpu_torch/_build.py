"""Build and load the port's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface and are compiled at
first use by ``nvcc`` into one shared library, loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes: one
``nvcc -c`` per source, all started together, then one link.

The library lands in ``build/`` beside this file under a name keyed by a
hash of the sources and the commands, so an edited source rebuilds and an
unchanged one is reused.  Objects and the library are written under
temporary names and the library is renamed into place, so processes that
build at the same time never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "sources", "nvcc_compile_command", "nvcc_link_command", "library", "check"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_DBL = ctypes.c_double
# name -> (restype, argtypes)
_SIGNATURES = {
    "lt_bsr_spmv_f32": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_f64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_f32": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_f64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_f32x64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_f32x64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_c64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_c128": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_c64x128": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_c64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_c128": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_c64x128": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_bf16": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_bf16": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_bf16x64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_rsmk_bf16x64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _P]),
    "lt_bsr_spmv_info": (_INT, [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]),
    "lt_bsr_spmv_bf16x64_info": (_INT, [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]),
    "lt_bsr_spmv_bf16x64_forced": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _I64, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_pass_f32": (_INT, [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_pass_f64": (_INT, [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_pass_c64": (_INT, [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_pass_c128": (_INT, [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_project_occupancy": (_INT, [_INT, _INT, ctypes.POINTER(_INT)]),
    "lt_cgs_block_pass_f32": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_block_pass_f64": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_block_pass_c64": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_block_pass_c128": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_cgs_block_info": (_INT, [_INT, _INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]),
    "lt_cheby_chain_f32": (_INT, [_INT, _P, ctypes.POINTER(_INT), _INT, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_cheby_chain_info": (_INT, [_INT, ctypes.POINTER(_INT), _INT, _INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]),
    "lt_cgsv_grid_shadow": (_INT, [_I64, _INT, ctypes.POINTER(_INT)]),
    "lt_bcgs_ring_f32": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_bcgs_ring_f64": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _P]),
    "lt_bcgs_ring_info": (_INT, [_INT, _INT, _INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]),
    "lt_cgsv_shadow_pass": (_INT, [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P]),
    "lt_row_set_f32": (_INT, [_P, _P, _P, _INT, _I64, _INT, _P]),
    "lt_row_set_f64": (_INT, [_P, _P, _P, _INT, _I64, _INT, _P]),
    "lt_spmv_v2_f32": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _INT, _INT, _INT, _INT, _INT, _I64, _INT, _P]),
    "lt_spmv_v2_f64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _I64, _INT, _INT, _INT, _INT, _INT, _I64, _INT, _P]),
    "lt_spmv_v2_info": (_INT, [_INT, _INT, _INT, _I64, _INT, ctypes.POINTER(_INT)]),
    "lt_spmv_v3_f32": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _I64, _INT, _P]),
    "lt_spmv_v3_f64": (_INT, [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _I64, _INT, _P]),
    "lt_sturm_check_f32": (_INT, [_P] * 9 + [_INT] * 7 + [_DBL, _DBL] + [_INT] * 5 + [_P]),
    "lt_sturm_check_f64": (_INT, [_P] * 9 + [_INT] * 7 + [_DBL, _DBL] + [_INT] * 5 + [_P]),
    "lt_error_string": (ctypes.c_char_p, [_INT]),
}


def sources() -> list[Path]:
    """Every CUDA translation unit of the port, in a stable order."""
    return sorted(CSRC_DIR.glob("*.cu"))


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]  # Hopper with its architecture-specific instructions


def nvcc_compile_command(src, obj, nvcc: str = "nvcc") -> list[str]:
    """The command that compiles one source into a relocatable object for
    ``sm_90a``."""
    return [str(nvcc), *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c", str(src), "-o", str(obj)]


def nvcc_link_command(objs, output, nvcc: str = "nvcc") -> list[str]:
    """The command that links the objects into the shared library ``output``."""
    return [str(nvcc), *_ARCH, "-shared", "-o", str(output), *[str(o) for o in objs]]


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of lanczos_tpu_torch are built from source at first use"
        )
    return found


def _library_path(srcs) -> Path:
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(nvcc_compile_command("src", "obj") + nvcc_link_command([], "out")).encode())
    return BUILD_DIR / f"liblanczos_tpu_torch_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    srcs = sources()
    objs = [path.with_name(f"{path.stem}.{s.stem}.{tag}.o") for s in srcs]
    tmp = path.with_name(f"{path.name}.{tag}.tmp")
    try:
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for cmd in (nvcc_compile_command(s, o, nvcc=nvcc) for s, o in zip(srcs, objs))
        ]
        failed = []
        for cmd, proc in procs:  # wait for every compiler before reporting
            _out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = nvcc_link_command(objs, tmp, nvcc=nvcc)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for f in [*objs, tmp]:
            f.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has no
    library in ``build/`` yet."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = _library_path(sources())
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = _LIB.lt_error_string(code).decode() if _LIB is not None else ""
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
