"""E2c: the classical pass whose projection reads a bf16 shadow of the
basis (port of ``experiments/pallas_bcgs_kernel3.py``).

A classical pass reads the k live rows twice, once for the coefficients
and once for the update.  The coefficients can come from a bf16 copy of
the rows: their error from bf16 rounding is about |e| |w| / sqrt(n), far
below the selective reorthogonalization's sqrt(eps) trigger at large n,
while the update must read the float32 rows (its error lands in w).  A
pass then moves k n (2 + 4) bytes, 0.75 of the float32 pass's.  An engine
would keep the shadow current with one bf16 row write per iteration (the
row write of :mod:`.carry_copy_bench`) and hold half as much again of the
basis in device memory.

On CUDA tensors :func:`cgs_shadow_pass` runs ``csrc/cgs_variants.cu``: E2b's
kernel with the projection reading bf16 rows, 8 values per 16-byte load,
accumulated in float32.

Run on the card: ``python -m lanczos_tpu_torch.experiments.bcgs_kernel3``.
"""

from __future__ import annotations

import torch

from ..core import linalg
from . import _cgs_variants, _timing

__all__ = ["cgs_shadow_pass", "cgs_shadow_pass_reference", "make_shadow", "make_pass", "check", "main"]


def make_shadow(basis):
    """The bf16 shadow of a float32 basis, rounded to nearest even, as
    ``astype(jnp.bfloat16)`` rounds it."""
    return basis.to(torch.bfloat16)


def cgs_shadow_pass_reference(v, basis_bf, basis, k: int):
    """Plain PyTorch: ``c = basis_bf[:k].float() @ v; v - c @ basis[:k]``;
    returns a new tensor."""
    k = int(k)
    if k <= 0:
        return v
    c = basis_bf[:k].float() @ v
    return v - c @ basis[:k]


def cgs_shadow_pass(v, basis_bf, basis, k: int):
    """E2c: one classical GS pass of ``v`` against rows [0, k) of ``basis``,
    its coefficients measured against the bf16 shadow ``basis_bf``.

    On CUDA tensors this launches ``csrc/cgs_variants.cu`` once (a float32
    basis with a bfloat16 shadow of its shape; other dtypes raise),
    overwrites ``v`` with the result, returns it and counts the launch in
    ``cgs_shadow_pass.launches``; ``k == 0`` launches nothing.  On CPU
    tensors it returns :func:`cgs_shadow_pass_reference`.  Callers use the
    return value.
    """
    k = _cgs_variants.validate("cgs_shadow_pass", v, basis, k)
    if basis_bf.shape != basis.shape:
        raise ValueError(f"cgs_shadow_pass: shadow of shape {tuple(basis_bf.shape)} for a basis of {tuple(basis.shape)}")
    if v.device.type == "cpu":
        return cgs_shadow_pass_reference(v, basis_bf, basis, k)
    if basis.dtype != torch.float32 or basis_bf.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"cgs_shadow_pass takes a float32 basis with a bfloat16 shadow on CUDA, got {basis.dtype} / {basis_bf.dtype}"
        )
    if basis_bf.device != v.device or not basis_bf.is_contiguous():
        raise ValueError("cgs_shadow_pass: the shadow must be contiguous and on v's device")
    if k == 0:
        return v
    _cgs_variants.launch("cgs_shadow_pass (E2c)", v, basis, k, shadow=basis_bf)
    cgs_shadow_pass.launches += 1
    return v


cgs_shadow_pass.launches = 0


def make_pass(chunk: int, bn: int, cap_rows: int):
    """``one_pass(v, basis_bf, basis, k)``, the JAX study's signature.
    ``chunk``, ``bn`` and ``cap_rows`` size the TPU kernel's tiles and
    scratch and change nothing here."""
    del chunk, bn, cap_rows
    return cgs_shadow_pass


def overlap(basis, w, k: int) -> float:
    """The largest live-row overlap left in ``w``: max |B[:k] w| / |w|."""
    return float((basis[:k] @ w).abs().max() / torch.linalg.vector_norm(w))


def _correctness(basis, basis_bf, v) -> list[str]:
    lines = []
    for k in (3, 100, 256):
        got = cgs_shadow_pass(v.clone(), basis_bf, basis, k)
        ref = linalg.orthogonalize_bcgs_dyn(v.clone(), basis, k, passes=1)  # K3 on CUDA
        lines.append(f"k={k}: overlap after v3 pass = {overlap(basis, got, k):.2e}"
                     f"  after f32 pass = {overlap(basis, ref, k):.2e}")
    return lines


def check(n: int = 1 << 22, cap: int = 257, device="cuda", seed: int = 0) -> list[str]:
    """The JAX study's correctness lines, on ``device`` (``"cpu"`` takes the
    plain versions): the live-row overlap left after one E2c pass and after
    one float32 classical pass, for k in (3, 100, 256), on a v with strong
    live-row components."""
    device = _timing.resolve_device(device)
    basis, v = _cgs_variants.make_data(cap, n, seed, strong=True)
    basis = torch.from_numpy(basis).to(device)
    return _correctness(basis, make_shadow(basis), torch.from_numpy(v).to(device))


def main(device="cuda") -> None:
    """The study at its own size, (257, 2**22) float32 and its shadow: the
    correctness lines, then ms per pass by the marginal method (4 and 12
    chained passes) for k in (64, 128, 256), as GB/s on its own k n 6
    bytes and on the float32 pass's 2 k n 4."""
    device = _timing.cuda_device(device)
    print(torch.cuda.get_device_name(device), flush=True)
    n, cap = 1 << 22, 257
    basis, v = (torch.from_numpy(a).to(device) for a in _cgs_variants.make_data(cap, n, strong=True))
    basis_bf = make_shadow(basis)
    print("data ready", flush=True)
    for line in _correctness(basis, basis_bf, v):
        print(line, flush=True)
    work = v.clone()
    for k in (64, 128, 256):

        # Eager passes are never folded, so the chain needs no perturbation.
        def chain(r, k=k):
            for _ in range(r):
                cgs_shadow_pass(work, basis_bf, basis, k)

        t = _timing.marginal(chain, 4, 12, device=device)
        print(f"k={k:3d}: v3 {t * 1e3:6.3f} ms ({k * n * 6 / t / 1e9:5.0f} GB/s eff, "
              f"{2 * k * n * 4 / t / 1e9:5.0f} GB/s f32-equiv)", flush=True)


if __name__ == "__main__":
    main()
