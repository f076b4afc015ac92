"""Linear-operator layer (port of ``lanczos_tpu.ops.operators``, main-path
subset): the reference's pluggable ``mv_mul`` closure
(lambda_lanczos.hpp:120-126) as a small protocol — ``n``, ``dtype``,
``device`` and ``matvec(x) -> A @ x`` on tensors of that device.

Operators hold their tensors; the device is theirs, set by the
``device=`` argument of each constructor.  There is no global default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import to_numpy_dtype, to_torch_dtype
from . import spmv

__all__ = [
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "BSROperator",
    "as_operator",
]


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


class FunctionOperator(LinearOperator):
    """Matrix-free operator from a callable ``fn(x) -> A @ x`` on tensors
    (the raw ``std::function`` matvec, sample3_dynamic.cpp:17-22)."""

    def __init__(self, fn, n: int, dtype, device=None):
        self.fn = fn
        self.n = int(n)
        self._dtype = to_torch_dtype(dtype)
        self._device = torch.device(device if device is not None else "cpu")

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
    ``a`` is anything ``torch.as_tensor`` takes."""

    def __init__(self, a, device=None):
        self.a = torch.as_tensor(a, device=device)
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
        ``device``."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        np_dtype = to_numpy_dtype(dtype)
        if np.iscomplexobj(vals) and not np.issubdtype(np_dtype, np.complexfloating):
            raise TypeError(
                f"complex values with real block dtype {np_dtype} would silently drop the "
                "imaginary parts; pass a complex dtype"
            )
        blocks, col_blocks = _pack_rmsk(rows, cols, vals, int(n), bm, bk, np_dtype)
        return cls(torch.from_numpy(blocks).to(device), torch.from_numpy(col_blocks).to(device), int(n))

    def matvec(self, x):
        return spmv.bsr_matvec(self.blocks, self.col_blocks, x, n_out=self.n)


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
    """Coerce an array / callable / operator into a :class:`LinearOperator`."""
    if isinstance(op, LinearOperator):
        return op
    if callable(op):
        if n is None or dtype is None:
            raise ValueError("FunctionOperator needs explicit n and dtype")
        return FunctionOperator(op, int(n), dtype, device)
    return DenseOperator(op, device=device)
