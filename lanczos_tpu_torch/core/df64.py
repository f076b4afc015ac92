"""Word-pair split and join (port of the two conversions of
``lanczos_tpu.core.df64``).

The JAX package carries its precise tier as double-float word pairs
(hi, lo), because the TPU has no float64.  The port computes that tier in
native float64 (``LinearOperator.matvec_f64``), so of the df64 module only
the conversions remain: :func:`join` turns a pair into float64 and
:func:`split` a float64 value into its pair, for code that still holds word
pairs (``matvec_df``).  The error-free arithmetic (``two_sum``,
``two_prod``, ``df_mul``, ``df_sum_axis``, ``df_matmul``) has no
counterpart: a float64 product of float32 values is exact.
"""

from __future__ import annotations

import torch

__all__ = ["split", "join"]


def split(x64, dtype=torch.float32):
    """``(hi, lo)``: ``hi`` the rounding of ``x64`` to ``dtype``, ``lo`` the
    remainder rounded to ``dtype`` (complex128 splits into complex64)."""
    hi = x64.to(dtype)
    lo = (x64 - hi.to(x64.dtype)).to(dtype)
    return hi, lo


def join(hi, lo):
    """``hi + lo`` in float64 (complex128 for complex words); either word
    may be ``None`` for zero."""
    wide = torch.complex128 if (hi is not None and hi.is_complex()) or (lo is not None and lo.is_complex()) else torch.float64
    if hi is None:
        return lo.to(wide)
    return hi.to(wide) if lo is None else hi.to(wide) + lo.to(wide)
