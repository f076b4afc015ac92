"""E2b at a small size against float64 classical GS (port of
``experiments/pallas_bcgs_k2_tiny.py``).

The JAX probe checked that the single-drain kernel compiles and is right
at (cap 257, n = 2**16, k = 100) before the full-size study ran.  Here
the inputs are the probe's own (``default_rng(0)``, float64 draws rounded
to float32, strong live-row components), the pass is
:func:`.bcgs_kernel2.cgs_single_pass`, and the reference is classical GS
in numpy float64.

Run on the card: ``python -m lanczos_tpu_torch.experiments.bcgs_k2_tiny``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _timing
from .bcgs_kernel2 import make_pass

__all__ = ["probe", "main"]


def probe(device="cuda", n: int = 1 << 16, cap: int = 257, k: int = 100) -> dict:
    """One E2b pass on ``device`` (``"cpu"`` takes the plain version):
    ``rel_err_vs_f64_cgs`` is max |pass - float64 CGS| / max |v|, and
    ``first_call_s`` the first call's host seconds (the kernel build
    included on a fresh CUDA process)."""
    device = _timing.resolve_device(device)
    rng = np.random.default_rng(0)
    basis_np = rng.standard_normal((cap, n)).astype(np.float32)
    basis_np /= np.linalg.norm(basis_np, axis=1, keepdims=True)
    v_np = rng.standard_normal(n).astype(np.float32)
    v_np += basis_np[:8].sum(axis=0) * 100.0
    basis = torch.from_numpy(basis_np).to(device)
    v = torch.from_numpy(v_np).to(device)

    one_pass = make_pass(64, 2048, cap)
    t0 = time.perf_counter()
    got = one_pass(v.clone(), basis, k).cpu().numpy().astype(np.float64)
    first_call_s = time.perf_counter() - t0

    b = basis_np.astype(np.float64)
    vv = v_np.astype(np.float64)
    ref = vv - (b[:k] @ vv) @ b[:k]
    return {"rel_err_vs_f64_cgs": float(np.abs(got - ref).max() / np.abs(v_np).max()), "first_call_s": first_call_s}


def main(device="cuda") -> None:
    out = probe(_timing.cuda_device(device))
    print(f"first call: {out['first_call_s']:.1f} s", flush=True)
    print(f"rel err vs f64 CGS: {out['rel_err_vs_f64_cgs']:.2e}", flush=True)


if __name__ == "__main__":
    main()
