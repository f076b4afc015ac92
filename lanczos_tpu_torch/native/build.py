"""Build and load the port's host library: ``host_kernels.cpp`` compiled by
``g++`` into a shared object with a plain C interface, loaded with
``ctypes``.

The flags are the JAX package's (``-O3 -std=c++17 -shared -fPIC
-fvisibility=default``), so with the same compiler both packages' native
solvers give the same bits.  The library lands in ``build/`` beside the
CUDA library (:mod:`lanczos_tpu_torch._build`), never beside the source,
under a name keyed by a hash of the source and the command; it is written
under a temporary name and renamed into place, so processes that build at
the same time never load a half-written file.  A failed build raises with
the compiler's message.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .._build import BUILD_DIR

__all__ = ["SOURCE", "gxx_command", "library_path", "shared_object_path"]

SOURCE = Path(__file__).resolve().parent / "host_kernels.cpp"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=default"]


def gxx_command(src, output, gxx: str = "g++") -> list[str]:
    """The command that compiles ``src`` into the shared library ``output``."""
    return [str(gxx), *_FLAGS, str(src), "-o", str(output)]


def library_path() -> Path:
    """Where the library of this source and command lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(gxx_command("src", "out")).encode())
    return BUILD_DIR / f"libhost_kernels_{h.hexdigest()[:16]}.so"


def shared_object_path() -> Path:
    """The library's path, built first if it is not there yet."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native tridiagonal backends are built from source")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        cmd = gxx_command(SOURCE, tmp, gxx=gxx)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path
