"""Linear-operator layer (port of ``lanczos_tpu.ops.operators``): the
reference's pluggable ``mv_mul`` closure (lambda_lanczos.hpp:120-126) as a
small protocol — ``n``, ``dtype``, ``device`` and ``matvec(x) -> A @ x`` on
tensors of that device, plus ``matvec_rows`` for a (b, n) block of row
vectors (the block engines).  :class:`ShiftInvertOperator` applies
``(A - sigma I)^{-1}`` by an inner MINRES solve (shift-invert ``eigsh``).
Complex Hermitian operators are native (complex64/complex128 entries);
``ops.hermitian_split`` keeps the JAX package's real 2n embedding as an
API and converts it to one of them.

The precise paths (``precise_vectors``, ``filtered_lanczos(precise=True)``,
the precise exponentiator) take ``matvec_f64(x)``: A x computed in float64
(complex128) from the operator's own entries, for a float64 (complex128)
``x``.  It is the port's counterpart of the JAX package's double-float
``matvec_df``: a float32 entry is exact in float64, so the float64 product
of the stored entries is what the word-pair arithmetic approximates to
2^-45.  ``matvec_df(x_hi, x_lo)`` stays as a thin adapter over it (join the
pair, multiply in float64, split the result), and :func:`float64_view`
wraps an operator as one whose ``dtype`` is float64 and whose ``matvec``
is ``matvec_f64``, which is how the engines run over a float64 basis.
:class:`DenseDFOperator` keeps a float64 matrix behind float32 storage.

Operators hold their tensors; the device is theirs.  A constructor that
takes host data (numpy arrays, CPU tensors, callables) puts the operator on
the CUDA card unless its ``device=`` argument says otherwise, and raises
when there is no card: pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import df64
from ..core.types import pack_dtype, to_numpy_dtype, to_torch_dtype
from . import spmv

__all__ = [
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "COOOperator",
    "CSROperator",
    "BSROperator",
    "DIAOperator",
    "SumOperator",
    "ScaledOperator",
    "ShiftSquaredOperator",
    "ShiftInvertOperator",
    "DenseDFOperator",
    "Float64View",
    "float64_view",
    "as_operator",
    "resolve_device",
]


def wide_dtype(dtype) -> torch.dtype:
    """float64, or complex128 for a complex ``dtype``: the precise paths'
    dtype for an operator of storage ``dtype``."""
    return torch.complex128 if to_torch_dtype(dtype).is_complex else torch.float64


def _sum_dtype(dtype):
    """The dtype row sums of stored entries accumulate in: float32 for
    bfloat16 tiles, else their own (None: ``sum``'s default)."""
    return torch.float32 if dtype == torch.bfloat16 else None


def _widened(t, x):
    """``t`` in the promotion of its own wide dtype and ``x``'s."""
    return t.to(torch.promote_types(wide_dtype(t.dtype), x.dtype))


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

    def abs_row_sums(self):
        """``sum_j |a_ij|`` of every row this process holds, the
        Gershgorin sums (``utils.estimate.gershgorin_bound``); None when
        the entries are not stored."""
        return None

    def matvec_rows(self, x):
        """``A`` applied to every row of a (b, n) block: one matvec per row
        (the JAX package's ``vmap(op.matvec)``); operators with a batched
        product override it."""
        return torch.stack([self.matvec(row) for row in x])

    def matvec_f64(self, x):
        """A x in float64 (complex128) for a float64 (complex128) ``x``,
        from the operator's own entries.  This default serves operators
        whose dtype is already float64 or complex128 and raises for any
        other, as the JAX package's default ``matvec_df`` does."""
        if self.dtype in (torch.float64, torch.complex128):
            return self.matvec(x)
        raise NotImplementedError(
            f"{type(self).__name__} of dtype {self.dtype} has no float64 matvec; the precise paths need "
            "one (Dense/COO/CSR/BSR/DIA/Sum/Scaled/ShiftSquared and the filter provide it), or implement "
            "matvec_f64 on your operator"
        )

    def matvec_rows_f64(self, x):
        """:meth:`matvec_f64` of every row of a (b, n) block."""
        return torch.stack([self.matvec_f64(row) for row in x])

    def matvec_df(self, x_hi, x_lo):
        """The JAX package's double-float matvec on word pairs, as an
        adapter: ``(y_hi, y_lo)`` with ``y_hi`` the rounding of the float64
        product of ``x_hi + x_lo`` to ``x_hi``'s dtype and ``y_lo`` the
        remainder."""
        return df64.split(self.matvec_f64(df64.join(x_hi, x_lo)), x_hi.dtype)


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

    def abs_row_sums(self):
        return self.a.abs().sum(dim=1)

    def matvec(self, x):
        return self.a @ x

    def matvec_f64(self, x):
        return _widened(self.a, x) @ x


class DenseDFOperator(LinearOperator):
    """Dense operator whose entries are float64 behind float32 storage
    (port of the JAX package's word-pair ``DenseDFOperator``).

    A :class:`DenseOperator` in float32 rounds the entries, and the precise
    engines then solve the rounded matrix: eigenvalues floor at the ~1e-8
    entry rounding (the reference's random-rotation zoo generators,
    lambda_lanczos_test.cpp:538-713).  This operator keeps the float64
    matrix: ``dtype`` is float32 and :meth:`matvec` is the JAX package's
    float32 product ``hi @ x + lo @ x`` (``hi`` the float32 rounding of the
    entries, ``lo`` the float32 remainder), while :meth:`matvec_f64` uses
    the full float64 entries.  Build it with :meth:`from_f64`.
    """

    def __init__(self, a64, device=None):
        if device is None and isinstance(a64, torch.Tensor) and a64.device.type != "cpu":
            device = a64.device
        self.a64 = torch.as_tensor(a64, dtype=torch.float64).to(resolve_device(device))
        if self.a64.ndim != 2 or self.a64.shape[0] != self.a64.shape[1]:
            raise ValueError(f"expected a square matrix, got shape {tuple(self.a64.shape)}")
        self.a_hi, self.a_lo = df64.split(self.a64, torch.float32)
        self.n = int(self.a64.shape[0])

    @classmethod
    def from_f64(cls, a64, *, device=None):
        """From a float64 matrix (anything ``torch.as_tensor`` takes), on
        ``device`` (default: the card)."""
        return cls(np.asarray(a64, np.float64) if not isinstance(a64, torch.Tensor) else a64, device=device)

    @property
    def dtype(self):
        return torch.float32

    @property
    def device(self):
        return self.a64.device

    def matvec(self, x):
        return self.a_hi @ x + self.a_lo @ x

    def matvec_f64(self, x):
        return self.a64.to(x.dtype) @ x


def _segment_sum(prod, offsets):
    """Row sums of ``prod`` (products in row order, row r's at
    ``offsets[r]:offsets[r+1]``) by ``torch.segment_reduce``: no atomics, so
    the sum order is fixed and a matvec repeats bit for bit (sequential per
    row on the CPU, one fixed reduction per row on CUDA; the two devices
    may round differently).  Complex products are summed as their real and
    imaginary parts."""
    if prod.is_complex():
        y = torch.segment_reduce(torch.view_as_real(prod), "sum", offsets=offsets, axis=0, unsafe=True)
        return torch.view_as_complex(y.contiguous())
    return torch.segment_reduce(prod, "sum", offsets=offsets, axis=0, unsafe=True)


class COOOperator(LinearOperator):
    """COO sparse operator: ``y[r] = sum of vals[j] * x[cols[j]]`` over the
    entries j with ``rows[j] = r`` (the JAX package's segment-sum matvec;
    the tuple-list sample, sample2_sparse.cpp:43-47).  Duplicates add up.

    Plain PyTorch on both devices, as the JAX package's is XLA gather and
    scatter (no Pallas kernel).  The entries are put in row order once (a
    stable sort), so each matvec is a gather, a product and a row sum by
    ``torch.segment_reduce``, with no atomic scatter-add: the sum order is
    fixed and the result repeats bit for bit on the card.  Convert to
    :class:`BSROperator` for kernel K1.
    """

    def __init__(self, rows, cols, vals, n: int):
        self.rows, self.cols, self.vals = rows, cols, vals
        self.n = int(n)
        if not (rows.shape == cols.shape == vals.shape and rows.ndim == 1):
            raise ValueError(f"rows/cols/vals of shapes {tuple(rows.shape)}/{tuple(cols.shape)}/"
                             f"{tuple(vals.shape)} are not three (nnz,) arrays")
        order = torch.sort(rows, stable=True).indices
        self._cols_sorted = cols[order]
        self._vals_sorted = vals[order]
        counts = torch.bincount(rows, minlength=self.n)
        if counts.numel() > self.n:
            raise ValueError(f"a row index is not below n={self.n}")
        self._offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])

    @classmethod
    def from_arrays(cls, rows, cols, vals, n: int, *, device=None):
        """From host arrays (or tensors): indices as int64, the values as
        they are, on ``device`` (default: the card)."""
        device = resolve_device(device)
        as_index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(device)  # noqa: E731
        return cls(as_index(rows), as_index(cols), torch.as_tensor(np.asarray(vals)).to(device), int(n))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def abs_row_sums(self):
        # In the values' dtype, as the JAX package's segment sum, in the
        # operator's own row order (fixed).
        return _segment_sum(self._vals_sorted.abs(), self._offsets)

    def matvec(self, x):
        return _segment_sum(self._vals_sorted * x[self._cols_sorted], self._offsets)

    def matvec_f64(self, x):
        """The gather, the products and the row sums in float64 (the JAX
        package's f64 segmented reduction for COO and CSR), in the fixed
        order of :meth:`matvec`."""
        return _segment_sum(_widened(self._vals_sorted, x) * x[self._cols_sorted], self._offsets)

    def to_dense(self):
        a = torch.zeros((self.n, self.n), dtype=self.dtype, device=self.device)
        return a.index_put_((self.rows, self.cols), self.vals, accumulate=True)


class CSROperator(LinearOperator):
    """CSR sparse operator (``indptr``, ``indices``, ``data``: scipy's
    layout).  The row of every nonzero, ``row_of_nnz``, is derived once
    here, as in the JAX package (for :meth:`to_bsr` and the Gershgorin
    bound); the matvec is a gather, a product and the row sums of
    ``indptr``'s segments by ``torch.segment_reduce``, plain PyTorch on
    both devices with a fixed sum order (no atomics; repeats bit for bit).
    :meth:`to_bsr` packs the operator for kernel K1.
    """

    def __init__(self, indptr, indices, data, n: int, row_of_nnz=None):
        self.indptr, self.indices, self.data = indptr, indices, data
        self.n = int(n)
        if indptr.shape != (self.n + 1,) or indices.shape != data.shape or indices.ndim != 1:
            raise ValueError(f"indptr {tuple(indptr.shape)} / indices {tuple(indices.shape)} / data "
                             f"{tuple(data.shape)} are not a CSR layout of {self.n} rows")
        if row_of_nnz is None:
            row_of_nnz = torch.repeat_interleave(torch.arange(self.n, device=indptr.device), torch.diff(indptr))
        self.row_of_nnz = row_of_nnz

    @classmethod
    def from_arrays(cls, indptr, indices, data, n: int, *, device=None):
        """From host arrays (or tensors): ``indptr`` and ``indices`` as
        int64, the values as they are, on ``device`` (default: the card)."""
        device = resolve_device(device)
        as_index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(device)  # noqa: E731
        return cls(as_index(indptr), as_index(indices), torch.as_tensor(np.asarray(data)).to(device), int(n))

    @classmethod
    def from_scipy(cls, mat, *, dtype=None, device=None):
        """From any scipy.sparse matrix (converted to CSR), its values in
        ``dtype`` (default: the matrix's), on ``device`` (default: the
        card)."""
        csr = mat.tocsr()
        data = csr.data if dtype is None else csr.data.astype(to_numpy_dtype(dtype))
        return cls.from_arrays(csr.indptr, csr.indices, data, int(csr.shape[0]), device=device)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def abs_row_sums(self):
        return _segment_sum(self.data.abs(), self.indptr)

    def matvec(self, x):
        return _segment_sum(self.data * x[self.indices], self.indptr)

    def matvec_f64(self, x):
        """The gather, the products and the row sums in float64, in the
        fixed order of :meth:`matvec`."""
        return _segment_sum(_widened(self.data, x) * x[self.indices], self.indptr)

    def to_bsr(self, **kwargs):
        """The same matrix as a :class:`BSROperator` (kernel K1 on the
        card); ``kwargs`` go to :meth:`BSROperator.from_coo` (``bm``,
        ``bk``, ``dtype``: default this operator's; ``device``: default
        this operator's)."""
        kwargs.setdefault("dtype", self.dtype)
        kwargs.setdefault("device", self.device)
        return BSROperator.from_coo(
            self.row_of_nnz.cpu().numpy(), self.indices.cpu().numpy(), self.data.cpu().numpy(), self.n, **kwargs,
        )


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
    rows; on the CPU it is the plain version.  ``matvec_f64`` of float32
    tiles is kernel K1x on the card (the tiles streamed once as stored,
    each value converted exactly, float64 accumulation) and the plain
    version accumulating in float64 on the CPU.

    bfloat16 tiles (``dtype=torch.bfloat16``, the JAX package's half tile
    stream) are storage only: engines over them take ``dtype=torch.float32``
    (or float64) for their vectors, and ``matvec`` is K1's bfloat16 instance
    against a float32 ``x``, ``matvec_f64`` K1x's against a float64 one.
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

    layout = "rmsk"  # the only tile layout of this operator (the sharded one holds rsmk)

    @property
    def bm(self):
        return self.blocks.shape[1]

    @property
    def bk(self):
        return self.blocks.shape[3]

    @property
    def s_max(self):
        """Stored tiles per row block (padding included)."""
        return self.blocks.shape[2]

    @property
    def n_padded(self):
        return self.blocks.shape[0] * self.bm

    @property
    def nnz_dense(self):
        """Stored (padded) values: what the kernel streams."""
        return self.blocks.numel()

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, *, bm: int = 128, bk: int = 128, dtype=torch.float32, device=None):
        """Pack COO triplets (duplicates summed) into the padded ``rmsk``
        layout with one vectorized numpy pass, then move the tiles to
        ``device`` (default: the card).  bfloat16 tiles are packed in
        float32 (duplicates summed there, as the JAX package's packer sums
        them) and rounded once to nearest even."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        np_dtype = pack_dtype(dtype)
        if np.iscomplexobj(vals) and not np.issubdtype(np_dtype, np.complexfloating):
            raise TypeError(
                f"complex values with real block dtype {dtype} would silently drop the "
                "imaginary parts; pass a complex dtype"
            )
        device = resolve_device(device)
        blocks, col_blocks = _pack_bsr(rows, cols, vals, int(n), bm, bk, np_dtype)
        blocks = torch.from_numpy(blocks).to(to_torch_dtype(dtype))  # a copy only for bfloat16
        return cls(blocks.to(device), torch.from_numpy(col_blocks).to(device), int(n))

    def abs_row_sums(self):
        # The rmsk tiles (R, bm, S, bk) over (S, bk); padding tiles are zero.
        # bfloat16 tiles are summed in float32.
        return self.blocks.abs().sum(dim=(2, 3), dtype=_sum_dtype(self.dtype)).reshape(-1)[: self.n]

    def matvec(self, x):
        return spmv.bsr_matvec(self.blocks, self.col_blocks, x, n_out=self.n)

    matvec_f64 = matvec  # a float64 x takes K1x (float32 or bfloat16 tiles) or K1 (float64 tiles)


def dia_abs_row_sums(data, dtype):
    """|row sums| of DIA ``data`` (one row per stored diagonal, entries off
    the matrix zero), accumulated in float64.  A bound must never
    underestimate: float32 data keeps the JAX package's few-ulp inflation
    of the float64 sum."""
    total = torch.zeros(data.shape[1], dtype=torch.float64, device=data.device)
    for row in data:
        total = total + row.abs().to(torch.float64)
    return total * (1.0 + 8.0 * float(torch.finfo(torch.float64).eps)) if dtype == torch.float32 else total


class DIAOperator(LinearOperator):
    """Diagonal (DIA, banded) operator: one length-n row per nonzero
    diagonal, ``y[i] = sum_d data[d, i] * x[i + offsets[d]]`` with
    ``data[d, i] = A[i, i + offsets[d]]`` (port of
    ``lanczos_tpu.ops.operators.DIAOperator``).

    The matvec is plain PyTorch, as the JAX package's is XLA (no Pallas
    kernel sits behind it): one shifted slice of ``x`` per diagonal, added
    into the rows it reaches in the order of ``offsets``.  Entries of a
    stored diagonal that run off the matrix are zeroed once here, where the
    JAX package masks them in every matvec (operators.py:590-595); the
    products are the same.  ``matvec`` also takes a (b, n) block of rows, so the
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

    @property
    def ndiag(self):
        return len(self.offsets)

    def to_dense(self):
        """The (n, n) matrix on the operator's device."""
        a = torch.zeros((self.n, self.n), dtype=self.dtype, device=self.device)
        for j, d in enumerate(self.offsets):
            i = torch.arange(max(0, -d), self.n - max(0, d), device=self.device)
            a[i, i + d] = self.data[j, i]
        return a

    def abs_row_sums(self):
        return dia_abs_row_sums(self.data, self.dtype)

    def _data_in(self, dtype):
        """``data`` in ``dtype``, converted once for each dtype that a
        matvec's ``x`` brings (float64 and complex vectors over float32
        storage)."""
        if dtype == self.data.dtype:
            return self.data
        cast = self.__dict__.setdefault("_cast", {})
        if dtype not in cast:
            cast[dtype] = self.data.to(dtype)
        return cast[dtype]

    def matvec(self, x):
        n = self.n
        data = self._data_in(x.dtype)
        y = torch.zeros_like(x)
        for j, d in enumerate(self.offsets):
            lo, hi = max(0, -d), n - max(0, d)  # the rows whose x[i + d] lies in the matrix
            if hi > lo:
                y[..., lo:hi] += data[j, lo:hi] * x[..., lo + d : hi + d]
        return y

    def matvec_rows(self, x):
        return self.matvec(x)

    # A float64 x gives the same shifted products in float64, each stored
    # value converted exactly (the JAX package's per-diagonal two_prod with
    # a compensated sum), for a vector or a (b, n) block.
    matvec_f64 = matvec_rows_f64 = matvec


class SumOperator(LinearOperator):
    """A + B + ... as an operator (e.g. H = H_hop + H_interaction); the
    terms may be of different formats (DIA + COO, dense + function, ...)
    and lie on one device.  Its dtype is the promotion of the terms'
    dtypes, as ``np.result_type`` gives it in the JAX package."""

    def __init__(self, terms):
        self.terms = tuple(terms)
        if not self.terms:
            raise ValueError("SumOperator needs at least one term")

    @property
    def n(self):
        return self.terms[0].n

    @property
    def dtype(self):
        dt = self.terms[0].dtype
        for t in self.terms[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return dt

    @property
    def device(self):
        return self.terms[0].device

    def matvec(self, x):
        y = self.terms[0].matvec(x)
        for t in self.terms[1:]:
            y = y + t.matvec(x)
        return y

    def matvec_f64(self, x):
        y = self.terms[0].matvec_f64(x)
        for t in self.terms[1:]:
            y = y + t.matvec_f64(x)
        return y


class ScaledOperator(LinearOperator):
    """``scale * A + shift * I`` as an operator (spectral shift and scale):
    ``scale`` multiplies in the base product's dtype and ``shift`` in
    ``x``'s, as the JAX package casts them."""

    def __init__(self, base, scale: float = 1.0, shift: float = 0.0):
        self.base = base
        self.scale = scale
        self.shift = shift

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
        y = self.base.matvec(x)
        if self.scale != 1.0:
            y = y * self.scale
        if self.shift != 0.0:
            y = y + x * self.shift
        return y

    def matvec_f64(self, x):
        """``scale`` and ``shift`` enter as the float64 values given (the
        JAX package splits them on the host for the same reason)."""
        y = self.base.matvec_f64(x)
        if self.scale != 1.0:
            y = y * self.scale
        if self.shift != 0.0:
            y = y + x * self.shift
        return y


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
    def group(self):
        """A row-partitioned base's process group (None otherwise): the
        engines reduce over it, as for the base itself."""
        return getattr(self.base, "group", None)

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def matvec(self, x):
        w = self.base.matvec(x) - self.sigma * x
        return self.base.matvec(w) - self.sigma * w

    def matvec_f64(self, x):
        w = self.base.matvec_f64(x) - self.sigma * x
        return self.base.matvec_f64(w) - self.sigma * w


class ShiftInvertOperator(LinearOperator):
    """``(A - sigma I)^{-1}`` applied matrix-free by an inner MINRES solve
    (port of ``lanczos_tpu.ops.operators.ShiftInvertOperator``).

    The shift-invert transform behind ``eigsh(sigma=...)``: its eigenvalues
    are ``1 / (lambda_i - sigma)``, so the eigenvalues of A nearest
    ``sigma`` become the extremal, well-separated ones.  No factorization:
    each matvec is one :func:`~lanczos_tpu_torch.solvers.minres.minres`
    solve (indefinite-safe) to ``inner_tol`` within ``inner_maxiter``
    iterations.  The outer solve's accuracy floor is the inner residual:
    keep ``inner_tol`` ~100x below the outer ``eps``.  A real or complex
    Hermitian ``op``.
    """

    def __init__(self, op, sigma, inner_tol: float = 1e-8, inner_maxiter: int = 500):
        self.op = op
        self.sigma = float(sigma)
        self.inner_tol = float(inner_tol)
        self.inner_maxiter = int(inner_maxiter)

    @property
    def n(self):
        return self.op.n

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, x):
        from ..solvers.minres import minres  # late import: the solvers import this module

        y, _relres, _iters = minres(self.op, x, shift=self.sigma, tol=self.inner_tol, maxiter=self.inner_maxiter)
        return y


class Float64View(LinearOperator):
    """``base`` seen as a float64 (complex128) operator: ``matvec`` is
    ``base.matvec_f64``.  The precise engines run the ordinary engines over
    this view and a float64 basis; ``group`` is passed on, so a
    row-partitioned base keeps its collectives.  Build it with
    :func:`float64_view`."""

    def __init__(self, base):
        self.base = base

    @property
    def n(self):
        return self.base.n

    @property
    def dtype(self):
        return wide_dtype(self.base.dtype)

    @property
    def device(self):
        return self.base.device

    @property
    def group(self):
        return getattr(self.base, "group", None)

    def matvec(self, x):
        return self.base.matvec_f64(x)

    def matvec_rows(self, x):
        return self.base.matvec_rows_f64(x)


def float64_view(op) -> LinearOperator:
    """``op`` as a :class:`Float64View` (``op`` itself when its dtype is
    already float64 or complex128)."""
    if op.dtype in (torch.float64, torch.complex128):
        return op
    return Float64View(op)


def _pack_bsr(rows, cols, vals, n: int, bm: int, bk: int, dtype, layout: str = "rmsk", *, n_cols=None, s=None):
    """COO -> (blocks, col_blocks (R, S) int32), blocks (R, bm, S, bk) for
    the ``rmsk`` layout and (R, S, bm, bk) for the canonical ``rsmk``.

    Tiles of a row block are ordered by ascending column block, as the JAX
    package packs them.  Duplicates are summed in ``dtype`` (``np.add.at``).
    ``n`` rows and ``n_cols`` columns (default n) are each padded to whole
    tiles; a slab of a wider operator's rows passes its rows from 0 and the
    operator's ``n_cols``.  ``s`` is the tiles a row block holds (default:
    the most any of these row blocks needs).
    """
    # n_pad must be divisible by both tile dims.
    q = int(np.lcm(bm, bk))
    n_row_blocks = -(-n // q) * q // bm
    n_col_blocks = -(-(n if n_cols is None else n_cols) // q) * q // bk

    ids = (rows // bm) * n_col_blocks + cols // bk
    block_ids, inv = np.unique(ids, return_inverse=True)
    rb = block_ids // n_col_blocks
    counts = np.bincount(rb, minlength=n_row_blocks)
    s_max = max(int(counts.max(initial=0)), 1)
    if s is not None:
        if s < s_max:
            raise ValueError(f"a row block needs {s_max} tiles, more than s={s}")
        s_max = int(s)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(block_ids.shape[0]) - first[rb]  # position within its row block

    col_blocks = np.zeros((n_row_blocks, s_max), dtype=np.int32)
    col_blocks[rb, slot] = block_ids % n_col_blocks
    if layout == "rmsk":
        blocks = np.zeros((n_row_blocks, bm, s_max, bk), dtype=dtype)
        flat = ((rb[inv] * bm + rows % bm) * s_max + slot[inv]) * bk + cols % bk
    elif layout == "rsmk":
        blocks = np.zeros((n_row_blocks, s_max, bm, bk), dtype=dtype)
        flat = ((rb[inv] * s_max + slot[inv]) * bm + rows % bm) * bk + cols % bk
    else:
        raise ValueError(f"layout must be 'rmsk' or 'rsmk', got {layout!r}")
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
