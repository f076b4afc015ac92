"""Dtype policy and scalar-type utilities (PyTorch port of
``lanczos_tpu.core.types``).

Eigenvalues, alpha/beta recurrence scalars and tolerances are always *real*
even when the operator is complex Hermitian, and inner products conjugate
their first argument (reference: include/lambda_lanczos/util/common.hpp:80-134).

Every function here takes a ``torch.dtype`` or anything ``numpy.dtype``
accepts, so configurations carried over from the JAX package (numpy dtypes)
and tensors' own dtypes go through one set of rules.

bfloat16 is a *storage* dtype (BSR tiles): numpy has no counterpart for it
unless ``ml_dtypes`` is installed, and the port never imports that.  Host
packing runs in float32 (:func:`pack_dtype`) and casts once with
``Tensor.to(torch.bfloat16)``, which rounds to nearest even as
``ml_dtypes``' ``astype`` does; a numpy bfloat16 array (``np.asarray`` of a
JAX one) is carried as its 16-bit words (:func:`from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "to_torch_dtype",
    "to_numpy_dtype",
    "real_dtype",
    "is_complex_dtype",
    "machine_eps",
    "default_lanczos_eps",
    "default_exponentiator_eps",
    "typed_conj",
    "is_bfloat16",
    "pack_dtype",
    "from_numpy",
]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def to_torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` for a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"no torch counterpart for dtype {dtype!r}") from None


def to_numpy_dtype(dtype) -> np.dtype:
    """The ``numpy.dtype`` for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_NP[dtype]
        except KeyError:
            raise TypeError(f"no numpy counterpart for dtype {dtype}") from None
    return np.dtype(dtype)


def real_dtype(dtype) -> torch.dtype:
    """Map a (possibly complex) dtype to its real counterpart
    (``util::real_t<T>``, reference common.hpp:80-102)."""
    dtype = to_torch_dtype(dtype)
    return dtype.to_real() if dtype.is_complex else dtype


def is_complex_dtype(dtype) -> bool:
    return to_torch_dtype(dtype).is_complex


def machine_eps(dtype) -> float:
    """Machine epsilon of the *real* counterpart of ``dtype``."""
    return float(torch.finfo(real_dtype(dtype)).eps)


def default_lanczos_eps(dtype) -> float:
    """Default eigensolver threshold ``machine_eps * 1e3``
    (reference lambda_lanczos.hpp:150)."""
    return machine_eps(dtype) * 1e3


def default_exponentiator_eps(dtype) -> float:
    """Default exponentiator threshold ``machine_eps * 1e2``
    (reference exponentiator.hpp:58)."""
    return machine_eps(dtype) * 1e2


def typed_conj(x: torch.Tensor) -> torch.Tensor:
    """Conjugate that is a no-op for real tensors (``util::typed_conj``,
    reference common.hpp:112-134)."""
    return x.conj() if x.is_complex() else x


def is_bfloat16(dtype) -> bool:
    """True for ``torch.bfloat16`` and for a numpy bfloat16 dtype
    (``ml_dtypes``', which JAX installs), known by its name and size."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return getattr(dtype, "name", None) == "bfloat16" and getattr(dtype, "itemsize", None) == 2


def pack_dtype(dtype) -> np.dtype:
    """The numpy dtype host packing builds an array of storage ``dtype``
    in: its own, float32 for bfloat16 (cast once after packing, with
    ``Tensor.to``)."""
    return np.dtype(np.float32) if is_bfloat16(dtype) else to_numpy_dtype(dtype)


def from_numpy(a) -> torch.Tensor:
    """``torch.from_numpy`` of a C-contiguous copy of ``a``; a numpy
    bfloat16 array, which ``torch.from_numpy`` refuses, goes as its 16-bit
    words and is viewed as ``torch.bfloat16``: the same bits, no
    ``ml_dtypes`` import."""
    a = np.asarray(a)
    if is_bfloat16(a.dtype):
        return torch.from_numpy(np.array(a.view(np.int16), order="C")).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))
