"""What the three CGS-pass studies (E2a-c) share: the argument checks and
the launch of ``csrc/cgs_variants.cu``, the studies' inputs, and their
error measure."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

__all__ = ["validate", "grid", "launch", "make_data", "rel_err"]

_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K3 for complex and bfloat16 bases"


def validate(name: str, v, basis, k) -> int:
    """Check a pass's operands and return ``k`` as an int.  On CUDA the
    kernel takes contiguous float32 or float64 tensors of one dtype on one
    device; anything else raises."""
    k = int(k)
    cap, n = basis.shape
    if v.shape != (n,) or not 0 <= k <= cap:
        raise ValueError(f"{name}: v of shape {tuple(v.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if v.device.type == "cpu":
        return k
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {v.device}")
    if basis.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"{name} takes float32/float64 bases on CUDA, got {basis.dtype}; see {_DTYPE_ITEM}")
    if v.dtype != basis.dtype:
        raise TypeError(f"{name}: v dtype {v.dtype} differs from the basis dtype {basis.dtype}")
    if basis.device != v.device:
        raise ValueError(f"{name}: v and basis must be on one device")
    if not (basis.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    return k


def grid(basis, shadow=None) -> int:
    """The CTAs of the persistent cooperative grid a pass over this CUDA
    basis launches: as many as fit on the card at once, at most one per
    column tile."""
    lib = _build.library()
    if shadow is not None:
        grid_fn = lib.lt_cgsv_grid_shadow
    elif basis.dtype == torch.float32:
        grid_fn = lib.lt_cgsv_grid_f32
    else:
        grid_fn = lib.lt_cgsv_grid_f64
    ctas = ctypes.c_int(0)
    _build.check(grid_fn(basis.shape[1], basis.device.index, ctypes.byref(ctas)), "cgs_variants: cooperative grid")
    return ctas.value


def launch(what: str, v, basis, k: int, chunk: int, shadow=None):
    """One cooperative launch of ``csrc/cgs_variants.cu`` over validated
    CUDA operands, overwriting ``v``: block MGS in chunks of ``chunk`` rows
    (one chunk when ``chunk >= k``), with the coefficients measured against
    the bf16 ``shadow`` when one is given."""
    lib = _build.library()
    n = basis.shape[1]
    dev = v.device
    ctas = grid(basis, shadow)
    chunk = min(chunk, k)
    halves = 1 if chunk == k else 2  # the partials are double-buffered by chunk parity
    part = torch.empty(halves * chunk * ctas, dtype=basis.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if shadow is not None:
        err = lib.lt_cgsv_shadow_pass(shadow.data_ptr(), basis.data_ptr(), v.data_ptr(), part.data_ptr(), n, k,
                                      ctas, dev.index, stream)
    else:
        fn = lib.lt_cgsv_pass_f32 if basis.dtype == torch.float32 else lib.lt_cgsv_pass_f64
        err = fn(basis.data_ptr(), v.data_ptr(), part.data_ptr(), n, k, chunk, ctas, dev.index, stream)
    _build.check(err, what)
    return v


def make_data(cap: int, n: int, seed: int = 0, strong: bool = False):
    """The studies' float32 inputs from ``numpy.random.default_rng(seed)``:
    a (cap, n) basis of unit rows and a vector v, plus 100 times the sum of
    the first eight rows when ``strong`` (large live-row components, as
    ``pallas_bcgs_kernel2.py`` and ``pallas_bcgs_kernel3.py`` make them)."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((cap, n), dtype=np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    v = rng.standard_normal(n, dtype=np.float32)
    if strong:
        v += basis[:8].sum(axis=0) * 100.0
    return basis, v


def rel_err(got, want, scale=None) -> float:
    """max |got - want| over ``scale`` (default max |want|), in float64."""
    err = float((got.double() - want.double()).abs().max())
    return err / float(want.double().abs().max() if scale is None else scale)
