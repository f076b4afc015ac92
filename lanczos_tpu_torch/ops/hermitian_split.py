"""Complex Hermitian operators given as their real and imaginary parts (port
of ``lanczos_tpu.ops.hermitian_split``).

The JAX package solves ``H = Hr + i Hi`` through the real symmetric 2n
embedding ``[[Hr, -Hi], [Hi, Hr]]`` because TPU runtimes have no complex
dtype, and folds the doubled pairs back on the host.  The H100 has native
complex64 and complex128, so here the embedding is kept only as an API:
:class:`HermitianSplitOperator` keeps its constructor, its ``n`` of 2n and
its ``matvec`` over the embedding (an engine handed it as a real operator
computes what the JAX package computes), and adds
:meth:`~HermitianSplitOperator.complex_operator`, one native complex
operator equal to ``Hr + i Hi``.  :func:`solve_hermitian` and the
``Exponentiator`` solve that operator directly: the Lanczos engines with a
complex basis (kernels K1 and K3 in their complex instances on the card),
no doubled pairs and no folding.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import BSROperator, DenseDFOperator, DenseOperator, LinearOperator, float64_view

__all__ = ["HermitianSplitOperator", "ComposedHermitianOperator", "solve_hermitian"]


def _complex_dtype(dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class HermitianSplitOperator(LinearOperator):
    """The real embedding of a complex Hermitian operator.

    ``op_r`` applies the (symmetric) real part, ``op_i`` the (antisymmetric)
    imaginary part, or None for a real symmetric operator; ``n`` is
    ``2 * op_r.n`` and :meth:`matvec` applies the embedding to ``[vr; vi]``,
    as in the JAX package.  :meth:`complex_operator` is the native complex
    operator the port's solvers use.
    """

    def __init__(self, op_r, op_i=None):
        self.op_r = op_r
        self.op_i = op_i
        self._complex = None

    @property
    def n(self):
        return 2 * self.op_r.n

    @property
    def dtype(self):
        return self.op_r.dtype

    @property
    def device(self):
        return self.op_r.device

    def _embed(self, x, fn):
        half = self.op_r.n
        vr, vi = x[:half], x[half:]
        yr = fn(self.op_r, vr)
        yi = fn(self.op_r, vi)
        if self.op_i is not None:
            yr = yr - fn(self.op_i, vi)
            yi = yi + fn(self.op_i, vr)
        return torch.cat([yr, yi])

    def matvec(self, x):
        return self._embed(x, lambda op, v: op.matvec(v))

    def matvec_f64(self, x):
        """The embedding over the parts' float64 products (the JAX
        package's composed ``matvec_df``)."""
        return self._embed(x, lambda op, v: op.matvec_f64(v))

    def to_complex(self, vec):
        """An embedded vector [vr; vi] as the unit complex vector vr + i vi
        (host numpy)."""
        half = self.op_r.n
        v = vec.cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
        c = v[:half] + 1j * v[half:]
        nrm = np.linalg.norm(c)
        return c / nrm if nrm > 0 else c

    def complex_operator(self) -> LinearOperator:
        """``Hr + i Hi`` as one native complex operator on the parts' device
        (made once): a complex :class:`DenseOperator` for dense parts
        (complex128 from :class:`DenseDFOperator` parts, whose entries are
        float64), complex BSR tiles for BSR parts of one pattern, else a
        :class:`ComposedHermitianOperator` of the parts' own products."""
        if self._complex is None:
            self._complex = _complex_of(self.op_r, self.op_i)
        return self._complex


def _dense_entries(op):
    if isinstance(op, DenseDFOperator):
        return op.a64
    if isinstance(op, DenseOperator):
        return op.a
    return None


def _complex_of(op_r, op_i) -> LinearOperator:
    ar = _dense_entries(op_r)
    ai = None if op_i is None else _dense_entries(op_i)
    if ar is not None and (op_i is None or ai is not None):
        rdt = torch.promote_types(ar.dtype, ai.dtype) if ai is not None else ar.dtype
        ar = ar.to(rdt)
        ai = torch.zeros_like(ar) if ai is None else ai.to(rdt)
        return DenseOperator(torch.complex(ar, ai), device=ar.device)
    if isinstance(op_r, BSROperator) and (op_i is None or (
            isinstance(op_i, BSROperator) and op_i.blocks.shape == op_r.blocks.shape
            and op_i.dtype == op_r.dtype and bool(torch.equal(op_i.col_blocks, op_r.col_blocks)))):
        bi = torch.zeros_like(op_r.blocks) if op_i is None else op_i.blocks
        return BSROperator(torch.complex(op_r.blocks, bi), op_r.col_blocks, op_r.n)
    return ComposedHermitianOperator(op_r, op_i)


class ComposedHermitianOperator(LinearOperator):
    """``Hr + i Hi`` on complex vectors from the real parts' own products:
    ``(Hr zr - Hi zi) + i (Hr zi + Hi zr)``, four real matvecs (the parts
    may be any real operators, e.g. BSR parts of different patterns or
    matrix-free ones)."""

    def __init__(self, op_r, op_i=None):
        self.op_r = op_r
        self.op_i = op_i

    @property
    def n(self):
        return self.op_r.n

    @property
    def dtype(self):
        return _complex_dtype(self.op_r.dtype)

    @property
    def device(self):
        return self.op_r.device

    def _apply(self, z, fn):
        zr = z.real.contiguous()
        zi = z.imag.contiguous()
        yr = fn(self.op_r, zr)
        yi = fn(self.op_r, zi)
        if self.op_i is not None:
            yr = yr - fn(self.op_i, zi)
            yi = yi + fn(self.op_i, zr)
        return torch.complex(yr, yi)

    def matvec(self, z):
        return self._apply(z, lambda op, v: op.matvec(v))

    def matvec_f64(self, z):
        return self._apply(z, lambda op, v: op.matvec_f64(v))


def solve_hermitian(op_r, op_i, num_eigs: int = 1, find_maximum: bool = False, *, method: str = "lanczos",
                    precise: bool = False, configure=None, **filtered_kwargs):
    """Extremal eigenpairs of the complex Hermitian ``Hr + i Hi``, solved
    natively on :meth:`HermitianSplitOperator.complex_operator`.

    Returns ``(eigenvalues (k,), eigenvectors complex (k, n))`` as host
    numpy arrays, the JAX function's result, with no doubled pairs to fold.
    ``configure(engine)`` may set any ``LambdaLanczos`` knob before the
    run.  ``method='filtered'`` runs
    :func:`~lanczos_tpu_torch.solvers.filtered.filtered_lanczos` on the
    complex operator (``filtered_kwargs`` pass through).  ``precise=True``
    solves in complex128 over ``float64_view`` of the operator (for
    complex64 BSR parts: kernel K1x's complex instance on the card); the
    ``precise_vectors`` engines take real dtypes only, as in the JAX
    package, so the complex solve reaches the same grade through its
    complex128 basis.
    """
    from ..api import LambdaLanczos  # late import: api imports the operators

    if method not in ("lanczos", "filtered"):
        raise ValueError(f"method must be 'lanczos' or 'filtered', got {method!r}")
    op = HermitianSplitOperator(op_r, op_i).complex_operator()
    if method == "filtered":
        from ..solvers.filtered import filtered_lanczos

        vals, vecs, _info = filtered_lanczos(op, num_eigs, find_maximum, precise=precise, configure=configure,
                                             **filtered_kwargs)
    else:
        if precise:
            op = float64_view(op)
        eng = LambdaLanczos(op, find_maximum=find_maximum, num_eigs=num_eigs)
        if configure is not None:
            configure(eng)
        vals, vecs = eng.run()
    vecs = vecs.cpu().numpy() if isinstance(vecs, torch.Tensor) else np.asarray(vecs)
    return np.asarray(vals, np.float64), vecs

