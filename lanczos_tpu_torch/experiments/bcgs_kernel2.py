"""E2b: the classical Gram-Schmidt pass in a single drain, one CUDA launch
against K3's three (port of ``experiments/pallas_bcgs_kernel2.py``).

The pass is classical GS over the live rows, what K3 computes: every
coefficient against the original v, then one update,
``v - (B[:k] v) B[:k]``.  On the TPU "single drain" meant one data
dependency for the whole pass; on the H100 it is one cooperative launch
with one grid barrier (``csrc/cgs_variants.cu``).  The study's
``precision`` choice has no counterpart: the kernel multiplies in full
float32 (the TPU's DEFAULT precision is its bf16 MXU passes).

Run on the card: ``python -m lanczos_tpu_torch.experiments.bcgs_kernel2``.
"""

from __future__ import annotations

import torch

from ..core import linalg
from ..ops import cgs
from . import _cgs_variants, _timing

__all__ = ["cgs_single_pass", "cgs_single_pass_reference", "make_pass", "check", "main"]


# The plain version is K3's: v - (B[:k] v) B[:k], a new tensor.
cgs_single_pass_reference = cgs.cgs_pass_reference


def cgs_single_pass(v, basis, k: int):
    """E2b: one classical GS pass of ``v`` against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/cgs_variants.cu`` once (float32 or
    float64; other dtypes raise), overwrites ``v`` with the result, returns
    it and counts the launch in ``cgs_single_pass.launches``; ``k == 0``
    launches nothing.  On CPU tensors it returns
    :func:`cgs_single_pass_reference`.  Callers use the return value.
    """
    k = _cgs_variants.validate("cgs_single_pass", v, basis, k)
    if v.device.type == "cpu":
        return cgs_single_pass_reference(v, basis, k)
    if k == 0:
        return v
    _cgs_variants.launch("cgs_single_pass (E2b)", v, basis, k)
    cgs_single_pass.launches += 1
    return v


cgs_single_pass.launches = 0


def make_pass(chunk: int, bn: int, cap_rows: int):
    """``one_pass(v, basis, k)``, the JAX study's signature.  ``chunk``,
    ``bn`` and ``cap_rows`` size the TPU kernel's tiles and scratch and
    change nothing here."""
    del chunk, bn, cap_rows
    return cgs_single_pass


def _correctness(basis, v) -> list[str]:
    vmax = float(v.abs().max())
    lines = []
    for k in (3, 100, 256):
        got = cgs_single_pass(v.clone(), basis, k)
        ref = linalg.orthogonalize_bcgs_dyn(v.clone(), basis, k, passes=1)  # K3 on CUDA
        lines.append(f"prec=HIGH k={k}: rel err vs cgs_pass = {_cgs_variants.rel_err(got, ref, vmax):.2e}")
    return lines


def check(n: int = 1 << 22, cap: int = 257, device="cuda", seed: int = 0) -> list[str]:
    """The JAX study's correctness lines, on ``device`` (``"cpu"`` takes the
    plain versions): E2b against the port's classical pass for k in (3,
    100, 256), relative to max |v|, on a v with strong live-row
    components."""
    device = _timing.resolve_device(device)
    basis, v = _cgs_variants.make_data(cap, n, seed, strong=True)
    return _correctness(torch.from_numpy(basis).to(device), torch.from_numpy(v).to(device))


def main(device="cuda") -> None:
    """The study at its own size, (257, 2**22) float32: the correctness
    lines, then ms per pass by the marginal method (4 and 12 chained
    passes) of K3 and of E2b for k in (64, 128, 256).  GB/s are on
    2 k n 4 bytes.  Then both at k = 256 over widths around 2**22: E2b's
    persistent CTAs each own whole column tiles, so its rate follows how
    evenly the tiles divide among them, K3's (a CTA per tile) should not."""
    device = _timing.cuda_device(device)
    print(torch.cuda.get_device_name(device), flush=True)
    n, cap = 1 << 22, 257
    basis, v = (torch.from_numpy(a).to(device) for a in _cgs_variants.make_data(cap, n, strong=True))
    print("data ready", flush=True)
    for line in _correctness(basis, v):
        print(line, flush=True)
    work = v.clone()
    for name, one_pass in (("K3 (three launches)", cgs.cgs_pass), ("single drain", cgs_single_pass)):
        for k in (64, 128, 256):

            # Eager passes are never folded, so the chain needs no perturbation.
            def chain(r, k=k, one_pass=one_pass):
                for _ in range(r):
                    one_pass(work, basis, k)

            t = _timing.marginal(chain, 4, 12, device=device)
            print(f"{name} k={k:3d}: {t * 1e3:6.3f} ms ({2 * k * n * 4 / t / 1e9:5.0f} GB/s)", flush=True)
    del basis, v, work
    print(f"grid: {_cgs_variants.grid(torch.empty((1, n), device=device))} CTAs at n = {n}", flush=True)
    k = 256
    gen = torch.Generator(device=device).manual_seed(1)
    for width in range(15 * n // 16, 19 * n // 16 + 1, n // 32):
        rows = torch.randn((k, width), generator=gen, device=device)
        w = torch.randn(width, generator=gen, device=device)
        line = f"n={width:8d}"
        for name, one_pass in (("K3", cgs.cgs_pass), ("single drain", cgs_single_pass)):

            def chain(r, one_pass=one_pass):
                for _ in range(r):
                    one_pass(w, rows, k)

            t = _timing.marginal(chain, 4, 12, device=device)
            line += f"  {name} {t * 1e3:6.3f} ms ({2 * k * width * 4 / t / 1e9:5.0f} GB/s)"
        print(line, flush=True)
        del rows, w


if __name__ == "__main__":
    main()
