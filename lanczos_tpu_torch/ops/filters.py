"""Chebyshev spectral-filter operator B = T_p((A - c)/e) (port of
``lanczos_tpu.ops.filters``).

Wrapping the operator in a degree-p Chebyshev polynomial damps the unwanted
part of the spectrum into [-1, 1] and grows the wanted mu-band like
cosh(p sqrt(2 mu/e)), so Lanczos on B converges in tens of iterations with
a basis of a few dozen rows, and each filtered iteration is a chain of p
matvecs with no basis traffic (Zhou & Saad's Chebyshev-filtered subspace
iteration; ChASE).  ``filtered_lanczos`` runs the ordinary engines on B.

Two routes apply the filter, as in the JAX package:

* the default: the three-term recurrence as a Python loop of
  ``op.matvec`` (the JAX package's ``lax.scan``);
* ``use_fused=True`` on a float32 DIA operator of bandwidth 1..8 and a
  vector: the chain of :mod:`lanczos_tpu_torch.ops.cheby` over rows
  prescaled once per operator, kernel K5 on CUDA tensors and its plain
  version on CPU tensors.  Off by default, as in the JAX package; the
  default on the card is a decision for measurements (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import real_dtype, to_numpy_dtype
from . import cheby
from .operators import DIAOperator, LinearOperator

__all__ = ["ChebyshevFilterOperator"]

_DF_ITEM = "ROADMAP.md, module item 10 (precise paths on native float64)"


class ChebyshevFilterOperator(LinearOperator):
    """B = T_p((A - c)/e) for a Hermitian ``op``.  Build with
    :meth:`from_interval`.

    ``c`` and ``e`` are rounded to the operator's real dtype once, here, and
    stay fixed for the operator's lifetime.  ``side`` says which side of the
    damp window holds the amplified band (-1 below, +1 above): with even
    degree both sides amplify positively, so :meth:`invert_value` needs it.
    """

    def __init__(self, op, c, e, degree: int = 8, side: int = -1, use_fused: bool = False):
        rdt = to_numpy_dtype(real_dtype(op.dtype))
        self.op = op
        self.c = float(rdt.type(float(c)))
        self.e = float(rdt.type(float(e)))
        self.degree = int(degree)
        self.side = int(side)
        self.use_fused = bool(use_fused)
        self._prescaled = None  # (rows, offsets) of the fused route, made at its first use

    @property
    def n(self):
        return self.op.n

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @classmethod
    def from_interval(cls, op, degree: int, lo: float, hi: float, mu: float, *, find_maximum: bool = False):
        """Filter amplifying the mu-band at the wanted end of [lo, hi].

        ``find_maximum=False`` damps [lo+mu, hi] (bottom band amplified);
        ``find_maximum=True`` damps [lo, hi-mu].  ``[lo, hi]`` must enclose
        the whole spectrum: an eigenvalue outside the damp window on the far
        side is amplified exponentially and destroys the solve.
        """
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        if not (0 < mu < (hi - lo)):
            raise ValueError(f"mu must lie in (0, hi-lo), got {mu}")
        if degree < 2:
            raise ValueError("degree must be >= 2")
        a, b = (lo + mu, hi) if not find_maximum else (lo, hi - mu)
        return cls(op, 0.5 * (a + b), 0.5 * (b - a), int(degree), side=(1 if find_maximum else -1))

    def _fused_ok(self, x) -> bool:
        """The fused chain's conditions (the JAX package's, with the CUDA
        plan's limit in place of its VMEM budget): opted in, a float32 DIA
        operator of bandwidth 1..8, a float32 vector.  Whether the kernel
        builds is not asked: on CUDA a build failure raises."""
        if not self.use_fused:
            return False
        op = self.op
        if not isinstance(op, DIAOperator) or x.ndim != 1:
            return False
        if x.dtype != torch.float32 or op.dtype != torch.float32:
            return False
        w = max((abs(o) for o in op.offsets), default=0)
        if w == 0 or w > 8:
            return False
        return cheby.cheby_chain_fits(len(op.offsets) + (0 not in op.offsets), w)

    def matvec(self, x):
        op = self.op
        if self._fused_ok(x):
            if self._prescaled is None:
                self._prescaled = cheby.prescale(op.data, op.offsets, self.c, self.e)
            return cheby.chain_apply_prescaled(*self._prescaled, x, self.degree)
        c, e = self.c, self.e
        t_prev, t = x, (op.matvec(x) - c * x) / e
        for _ in range(self.degree - 1):
            t_prev, t = t, 2.0 * (op.matvec(t) - c * t) / e - t_prev
        return t

    def matvec_df(self, x_hi, x_lo):
        raise NotImplementedError(f"the double-float filter application is not ported; see {_DF_ITEM}")

    def invert_value(self, b):
        """Host inverse of the filter map on the amplified side: the
        A-eigenvalue lambda with T_p((lambda - c)/e) = b, in float64 by the
        stable form |y| - 1 = 2 sinh^2(acosh(b)/(2p)).  An error eps_b in b
        maps back as eps_b / T_p'(lambda).  Values b <= 1 (the damped bulk)
        return NaN."""
        b = np.asarray(b, np.float64)
        p = float(self.degree)
        c, e = self.c, self.e
        with np.errstate(invalid="ignore"):
            u = np.arccosh(np.maximum(b, 1.0))
            ym1 = 2.0 * np.sinh(u / (2.0 * p)) ** 2  # |y| - 1 >= 0
            lam = np.where(b > 1.0, (c - e - e * ym1) if self.side < 0 else (c + e + e * ym1), np.nan)
        return lam

    def eval_scalar(self, x):
        """Host T_p((x - c)/e) in float64, by the cos/cosh closed forms so
        that |y| > 1 does not overflow the recurrence."""
        y = (np.asarray(x, np.float64) - self.c) / self.e
        p = self.degree
        out = np.empty_like(y)
        inside = np.abs(y) <= 1.0
        out[inside] = np.cos(p * np.arccos(np.clip(y[inside], -1.0, 1.0)))
        yo = y[~inside]
        out[~inside] = np.sign(yo) ** p * np.cosh(p * np.arccosh(np.abs(yo)))
        return out
