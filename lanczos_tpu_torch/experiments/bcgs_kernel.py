"""E2a: the block-MGS Gram-Schmidt pass as one CUDA launch, against K3
(port of ``experiments/pallas_bcgs_kernel.py``).

The pass walks rows [0, k) of a fixed-capacity basis in chunks of
``chunk`` rows, in order, and projects each chunk out of the current v:
``v -= (B[c0:c1] v) B[c0:c1]`` with ``c1 = min(c0 + chunk, k)``.  That is
block MGS, what the JAX study's docstring and the XLA chunk loop of
``lanczos_tpu.core.linalg.orthogonalize_bcgs_dyn`` compute.  The Pallas
kernel itself, run through the Pallas interpreter, returns v minus the
last chunk's projection alone once ``k > chunk`` (ROADMAP queue 3); the
port is held to block MGS.

On CUDA tensors :func:`bcgs_mgs_pass` runs ``csrc/bcgs_ring.cu``: one
cooperative launch per pass, one grid barrier per chunk, each CTA's range
of v on chip for the whole pass where it fits (``_cgs_variants.mgs_plan``)
and the rows streamed through a bulk-copy ring.

Run on the card: ``python -m lanczos_tpu_torch.experiments.bcgs_kernel``.
"""

from __future__ import annotations

import torch

from ..core import linalg
from . import _cgs_variants, _timing

__all__ = ["bcgs_mgs_pass", "bcgs_mgs_pass_reference", "make_pass", "check", "main"]


def bcgs_mgs_pass_reference(v, basis, k: int, chunk: int):
    """Plain PyTorch block MGS over rows [0, k) in chunks of ``chunk``;
    returns a new tensor."""
    k, chunk = int(k), int(chunk)
    for c0 in range(0, k, chunk):
        rows = basis[c0 : min(c0 + chunk, k)]
        v = v - (rows @ v) @ rows
    return v


def bcgs_mgs_pass(v, basis, k: int, chunk: int):
    """E2a: one block-MGS pass of ``v`` against rows [0, k) of ``basis``.

    On CUDA tensors this launches ``csrc/bcgs_ring.cu`` once (float32 or
    float64; other dtypes raise), cut by ``_cgs_variants.mgs_plan``,
    overwrites ``v`` with the result, returns
    it and counts the launch in ``bcgs_mgs_pass.launches``; ``k == 0``
    launches nothing.  On CPU tensors it returns
    :func:`bcgs_mgs_pass_reference`.  Callers use the return value.
    """
    k = _cgs_variants.validate("bcgs_mgs_pass", v, basis, k)
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"bcgs_mgs_pass: chunk must be positive, got {chunk}")
    if v.device.type == "cpu":
        return bcgs_mgs_pass_reference(v, basis, k, chunk)
    if k == 0:
        return v
    _cgs_variants.mgs_launch("bcgs_mgs_pass (E2a)", v, basis, k, chunk)
    bcgs_mgs_pass.launches += 1
    return v


bcgs_mgs_pass.launches = 0


def make_pass(chunk: int, bn: int | None = None):
    """``one_pass(v, basis, k)``, the JAX study's signature.  ``bn`` is the
    TPU kernel's column tile and changes nothing here."""
    del bn

    def one_pass(v, basis, k):
        return bcgs_mgs_pass(v, basis, k, chunk)

    return one_pass


def _correctness(basis, v) -> list[str]:
    lines = []
    chunk, bn = 64, 2048
    one_pass = make_pass(chunk, bn)
    for k in (3, 64, 100, 256):
        # The port's production pass (K3 on CUDA) plays the XLA chunk loop's part.
        ref = linalg.orthogonalize_bcgs_dyn(v.clone(), basis, k, passes=1)
        got = one_pass(v.clone(), basis, k)
        plain = bcgs_mgs_pass_reference(v, basis, k, chunk)
        lines.append(f"chunk={chunk} bn={bn} k={k}: rel err vs cgs_pass = {_cgs_variants.rel_err(got, ref):.2e}"
                     f"  vs plain = {_cgs_variants.rel_err(got, plain):.2e}")
    return lines


def check(n: int = 1 << 22, cap: int = 257, device="cuda", seed: int = 0) -> list[str]:
    """The JAX study's correctness lines, on ``device`` (``"cpu"`` takes the
    plain versions): E2a at chunk 64 for k in (3, 64, 100, 256) against
    the port's classical pass and against its own plain version."""
    device = _timing.resolve_device(device)
    basis, v = _cgs_variants.make_data(cap, n, seed)
    return _correctness(torch.from_numpy(basis).to(device), torch.from_numpy(v).to(device))


def main(device="cuda") -> None:
    """The study at its own size, (257, 2**22) float32: the correctness
    lines, then ms per pass by the marginal method (4 and 12 chained
    passes) for chunk in (32, 64, 128) and k in (64, 128, 256), with K3
    beside chunk 64.  GB/s are on 2 k n 4 bytes."""
    device = _timing.cuda_device(device)
    print(torch.cuda.get_device_name(device), flush=True)
    n, cap = 1 << 22, 257
    basis, v = (torch.from_numpy(a).to(device) for a in _cgs_variants.make_data(cap, n))
    for line in _correctness(basis, v):
        print(line, flush=True)
    work = v.clone()
    for chunk in (32, 64, 128):
        for k in (64, 128, 256):
            bytes_pass = 2 * k * n * 4

            # Eager passes are never folded, so the chain needs no perturbation.
            def chain(r, k=k, chunk=chunk):
                for _ in range(r):
                    bcgs_mgs_pass(work, basis, k, chunk)

            t = _timing.marginal(chain, 4, 12, device=device)
            line = f"chunk={chunk:3d} k={k:3d}: cuda {t * 1e3:6.3f} ms ({bytes_pass / t / 1e9:5.0f} GB/s)"
            if chunk == 64:

                def chain_k3(r, k=k):
                    for _ in range(r):
                        linalg.orthogonalize_bcgs_dyn(work, basis, k, passes=1)

                t3 = _timing.marginal(chain_k3, 4, 12, device=device)
                line += f"   K3 {t3 * 1e3:6.3f} ms ({bytes_pass / t3 / 1e9:5.0f} GB/s)"
            print(line, flush=True)


if __name__ == "__main__":
    main()
