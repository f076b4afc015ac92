"""Linear-operator layer (port of ``lanczos_tpu.ops.operators``, main-path
subset): the reference's pluggable ``mv_mul`` closure
(lambda_lanczos.hpp:120-126) as a small protocol — ``n``, ``dtype``,
``device`` and ``matvec(x) -> A @ x`` on tensors of that device, plus
``matvec_rows`` for a (b, n) block of row vectors (the block engines).

Operators hold their tensors; the device is theirs.  A constructor that
takes host data (numpy arrays, CPU tensors, callables) puts the operator on
the CUDA card unless its ``device=`` argument says otherwise, and raises
when there is no card: pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import to_numpy_dtype, to_torch_dtype
from . import spmv

__all__ = [
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "BSROperator",
    "DIAOperator",
    "ShiftSquaredOperator",
    "as_operator",
    "resolve_device",
]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when PyTorch sees none (the port never falls back to the CPU
    unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lanczos_tpu_torch puts operators on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class LinearOperator:
    """Protocol: ``n`` (dimension), ``dtype`` (a ``torch.dtype``),
    ``device``, and ``matvec``."""

    n: int

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def matvec(self, x):
        raise NotImplementedError

    def matvec_rows(self, x):
        """``A`` applied to every row of a (b, n) block: one matvec per row
        (the JAX package's ``vmap(op.matvec)``); operators with a batched
        product override it."""
        return torch.stack([self.matvec(row) for row in x])


class FunctionOperator(LinearOperator):
    """Matrix-free operator from a callable ``fn(x) -> A @ x`` on tensors
    (the raw ``std::function`` matvec, sample3_dynamic.cpp:17-22)."""

    def __init__(self, fn, n: int, dtype, device=None):
        self.fn = fn
        self.n = int(n)
        self._dtype = to_torch_dtype(dtype)
        self._device = resolve_device(device)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def matvec(self, x):
        return self.fn(x)


class DenseOperator(LinearOperator):
    """Dense symmetric/Hermitian operator (sample1_simple.cpp:22-28);
    ``a`` is anything ``torch.as_tensor`` takes.  A CUDA tensor stays on its
    device; host data goes to ``device`` (default: the card)."""

    def __init__(self, a, device=None):
        if device is None and isinstance(a, torch.Tensor) and a.device.type != "cpu":
            device = a.device
        self.a = torch.as_tensor(a, device=resolve_device(device))
        if self.a.ndim != 2 or self.a.shape[0] != self.a.shape[1]:
            raise ValueError(f"expected a square matrix, got shape {tuple(self.a.shape)}")
        self.n = int(self.a.shape[0])

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        return self.a @ x


class BSROperator(LinearOperator):
    """Block-sparse-row operator: nonzeros packed into dense (bm x bk)
    tiles, padded per row block (ELL-like).

    * ``blocks``      (R, bm, S, bk) tiles in the ``rmsk`` layout: row block
      r's tiles form one contiguous (bm, S*bk) slab, the layout kernel K1
      streams;
    * ``col_blocks``  (R, S) int32 column-block index of each tile; padding
      tiles point at block 0 and hold zeros.

    On the card ``matvec`` is kernel K1 (``csrc/bsr_spmv.cu``), which reads
    the unpadded ``x`` with a bound check and writes only the first ``n``
    rows; on the CPU it is the plain version.
    """

    def __init__(self, blocks, col_blocks, n: int):
        self.blocks = blocks
        self.col_blocks = col_blocks
        self.n = int(n)
        if blocks.ndim != 4 or col_blocks.shape != (blocks.shape[0], blocks.shape[2]):
            raise ValueError(
                f"blocks {tuple(blocks.shape)} / col_blocks {tuple(col_blocks.shape)} are not an "
                "(R, bm, S, bk) / (R, S) pair"
            )
        if self.n > self.n_padded:
            raise ValueError(f"n={self.n} exceeds the {self.n_padded} padded rows")

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def n_padded(self):
        return self.blocks.shape[0] * self.blocks.shape[1]

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, *, bm: int = 128, bk: int = 128, dtype=torch.float32, device=None):
        """Pack COO triplets (duplicates summed) into the padded ``rmsk``
        layout with one vectorized numpy pass, then move the tiles to
        ``device`` (default: the card)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        np_dtype = to_numpy_dtype(dtype)
        if np.iscomplexobj(vals) and not np.issubdtype(np_dtype, np.complexfloating):
            raise TypeError(
                f"complex values with real block dtype {np_dtype} would silently drop the "
                "imaginary parts; pass a complex dtype"
            )
        device = resolve_device(device)
        blocks, col_blocks = _pack_rmsk(rows, cols, vals, int(n), bm, bk, np_dtype)
        return cls(torch.from_numpy(blocks).to(device), torch.from_numpy(col_blocks).to(device), int(n))

    def matvec(self, x):
        return spmv.bsr_matvec(self.blocks, self.col_blocks, x, n_out=self.n)


class DIAOperator(LinearOperator):
    """Diagonal (DIA, banded) operator: one length-n row per nonzero
    diagonal, ``y[i] = sum_d data[d, i] * x[i + offsets[d]]`` with
    ``data[d, i] = A[i, i + offsets[d]]`` (port of
    ``lanczos_tpu.ops.operators.DIAOperator``).

    The matvec is plain PyTorch, as the JAX package's is XLA (no Pallas
    kernel sits behind it): one zero-padded ``x`` and one shifted slice per
    diagonal, summed in the order of ``offsets``.  Entries of a stored
    diagonal that run off the matrix are zeroed once here, where the JAX
    package masks them in every matvec (operators.py:590-595); the products
    are the same.  ``matvec`` also takes a (b, n) block of rows, so the
    block engines apply the operator in one call.
    """

    def __init__(self, offsets, data, n: int):
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        if data.ndim != 2 or data.shape != (len(self.offsets), self.n):
            raise ValueError(f"data of shape {tuple(data.shape)} is not ({len(self.offsets)}, {self.n})")
        data = data.clone()
        for j, d in enumerate(self.offsets):
            if d > 0:
                data[j, self.n - d :] = 0
            elif d < 0:
                data[j, : -d] = 0
        self.data = data

    @classmethod
    def from_diagonals(cls, offsets, diagonals, n: int, *, dtype=None, device=None):
        """``diagonals[d]`` is the length-n array with ``A[i, i + offsets[d]]``
        at position i (entries running off the matrix are ignored); the rows
        go to ``device`` (default: the card)."""
        data = np.stack([np.asarray(diag) for diag in diagonals])
        if dtype is not None:
            data = data.astype(to_numpy_dtype(dtype))
        return cls(offsets, torch.from_numpy(data).to(resolve_device(device)), n)

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, *, dtype=None, device=None):
        """COO triplets (duplicates summed) to one row per distinct
        ``cols - rows`` offset, in ascending offset order."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        offs = np.unique(cols - rows)
        data = np.zeros((offs.shape[0], int(n)), dtype=vals.dtype if dtype is None else to_numpy_dtype(dtype))
        for j, d in enumerate(offs):
            m = (cols - rows) == d
            np.add.at(data[j], rows[m], vals[m])
        return cls(offs.tolist(), torch.from_numpy(data).to(resolve_device(device)), n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def matvec(self, x):
        n = self.n
        lo = max([0] + [-d for d in self.offsets])
        hi = max([0] + [d for d in self.offsets])
        xp = F.pad(x, (lo, hi)) if (lo or hi) else x
        y = torch.zeros_like(x)
        for j, d in enumerate(self.offsets):
            y = y + self.data[j].to(x.dtype) * xp[..., lo + d : lo + d + n]
        return y

    def matvec_rows(self, x):
        return self.matvec(x)


class ShiftSquaredOperator(LinearOperator):
    """``(A - sigma I)^2``: the polynomial transform for interior targets
    (port of ``lanczos_tpu.ops.operators.ShiftSquaredOperator``).  The
    eigenvalues of A nearest ``sigma`` map to the bottom edge of the squared
    spectrum, where the filtered solve applies.  Two base matvecs per
    application and no linear solve, so ``sigma`` on an eigenvalue is the
    best-conditioned case (it maps to exactly 0)."""

    def __init__(self, base, sigma: float = 0.0):
        self.base = base
        self.sigma = float(sigma)

    @property
    def n(self):
        return self.base.n

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def matvec(self, x):
        w = self.base.matvec(x) - self.sigma * x
        return self.base.matvec(w) - self.sigma * w


def _pack_rmsk(rows, cols, vals, n: int, bm: int, bk: int, dtype):
    """COO -> (blocks (R, bm, S, bk), col_blocks (R, S) int32).

    Tiles of a row block are ordered by ascending column block, as the JAX
    package packs them.  Duplicates are summed in ``dtype`` (``np.add.at``).
    """
    # n_pad must be divisible by both tile dims.
    q = int(np.lcm(bm, bk))
    n_pad = -(-n // q) * q
    n_row_blocks = n_pad // bm
    n_col_blocks = n_pad // bk

    ids = (rows // bm) * n_col_blocks + cols // bk
    block_ids, inv = np.unique(ids, return_inverse=True)
    rb = block_ids // n_col_blocks
    counts = np.bincount(rb, minlength=n_row_blocks)
    s_max = max(int(counts.max(initial=0)), 1)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(block_ids.shape[0]) - first[rb]  # position within its row block

    col_blocks = np.zeros((n_row_blocks, s_max), dtype=np.int32)
    col_blocks[rb, slot] = block_ids % n_col_blocks
    blocks = np.zeros((n_row_blocks, bm, s_max, bk), dtype=dtype)
    flat = ((rb[inv] * bm + rows % bm) * s_max + slot[inv]) * bk + cols % bk
    np.add.at(blocks.reshape(-1), flat, vals.astype(dtype, copy=False))
    return blocks, col_blocks


def as_operator(op, n=None, dtype=None, device=None):
    """Coerce an array / callable / operator into a :class:`LinearOperator`;
    an operator keeps its own device, anything else goes to ``device``
    (default: the card)."""
    if isinstance(op, LinearOperator):
        return op
    if callable(op):
        if n is None or dtype is None:
            raise ValueError("FunctionOperator needs explicit n and dtype")
        return FunctionOperator(op, int(n), dtype, device)
    return DenseOperator(op, device=device)
