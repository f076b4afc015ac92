"""Vector-kernel layer (port of ``lanczos_tpu.core.linalg``, main-path
subset; the reference's BLAS-1 layer, util/linear_algebra.hpp).

Reorthogonalization is classical Gram-Schmidt everywhere: each pass
measures every coefficient against the incoming vector.  That is what the
Pallas CGS kernel computes (pallas_cgs.py:32-38) and what the JAX package's
CPU path computes (linalg.py:192-194); the JAX accelerator path's chunked
block-MGS is not ported.

The double-float reductions of the JAX package exist because the TPU has no
float64.  The port takes the float64 dot product of the vectors cast to
float64 instead (:func:`inner_prod_f64`, and :func:`block_inner_f64` for the
coefficient blocks of the block engines): for float32 data every product is
exact there.

Row-partitioned vectors: every reduction over n takes ``group``, the
``torch.distributed`` process group of a sharded operator (its ``group``
attribute; ``None`` for an operator on one device).  With a group the
vectors are this rank's slabs, and each partial sum is all-reduced over the
group before it is used, so every rank holds the same, bit-identical
scalars and coefficients and takes the same branches.  The engines pass
``getattr(op, "group", None)`` at each call site.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import cgs as _cgs
from .types import typed_conj

__all__ = [
    "reduce_sum",
    "inner_prod",
    "inner_prod_f64",
    "norm",
    "m_norm",
    "normalize",
    "orthogonalize_rows",
    "orthogonalize_cgs2",
    "orthogonalize_bcgs_dyn",
    "orthogonalize_bcgs_dyn_coeffs",
    "block_inner_f64",
]


def reduce_sum(t, group=None):
    """``t`` summed over the ranks of ``group``, in place (an all-reduce);
    with no group, ``t`` as it is."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def inner_prod(v, w, group=None):
    """Mathematical inner product <v, w> = sum_i conj(v_i) w_i
    (linear_algebra.hpp:29-51); a 0-d tensor on the vectors' device."""
    return reduce_sum(torch.vdot(v, w), group)


def inner_prod_f64(v, w, group=None):
    """<v, w> accumulated in float64 (complex128 for complex inputs)."""
    wide = torch.complex128 if v.is_complex() else torch.float64
    return reduce_sum(torch.vdot(v.to(wide), w.to(wide)), group)


def norm(v, group=None):
    """Euclidean norm; always real (linear_algebra.hpp:56-60)."""
    return torch.sqrt(inner_prod(v, v, group).real)


def m_norm(v, group=None):
    """Manhattan-like norm: sum |re| + |im| for complex, the BLAS ASUM
    semantics the reference uses (linear_algebra.hpp:82-125)."""
    if v.is_complex():
        return reduce_sum(torch.sum(v.real.abs() + v.imag.abs()), group)
    return reduce_sum(torch.sum(v.abs()), group)


def normalize(v, group=None):
    """v / ||v|| (linear_algebra.hpp:77-80)."""
    return v / norm(v, group)


def orthogonalize_rows(v, basis, row_mask=None, group=None):
    """One classical Gram-Schmidt pass of ``v`` against the rows of
    ``basis`` (orthonormal rows, the contract of ``schmidt_orth``,
    linear_algebra.hpp:128-131).  ``row_mask`` (m,) zeroes unused rows."""
    if basis.shape[0] == 0:
        return v
    c = reduce_sum(typed_conj(basis) @ v, group)
    if row_mask is not None:
        c = c * row_mask.to(c.dtype)
    return v - c @ basis


def orthogonalize_cgs2(v, basis, row_mask=None, passes: int = 2, group=None):
    """Classical Gram-Schmidt with ``passes`` passes (default CGS2)."""
    for _ in range(passes):
        v = orthogonalize_rows(v, basis, row_mask, group)
    return v


def orthogonalize_bcgs_dyn(v, basis, k: int, passes: int = 2, group=None):
    """``passes`` classical GS passes of ``v`` against rows [0, k) of a
    fixed-capacity ``basis``, reading only the live rows.

    Each pass is one call of kernel K3 (:func:`lanczos_tpu_torch.ops.cgs.cgs_pass`)
    on CUDA tensors, which overwrites ``v``; on CPU tensors it is the plain
    pass.  ``k`` is a Python int.

    Over a group of more than one rank the coefficients are partial sums, so
    a pass is the projection product, the all-reduce, then the update, in
    plain PyTorch: the JAX package turns its Pallas pass off on more than one
    device for the same reason (lanczos_tpu/ops/pallas_cgs.py:64-70).  A
    group of one rank runs K3 as above.
    """
    if group is not None and dist.get_world_size(group) > 1:
        if k == 0:
            return v
        rows = basis[:k]
        for _ in range(passes):
            v = v - reduce_sum(typed_conj(rows) @ v, group) @ rows
        return v
    for _ in range(passes):
        v = _cgs.cgs_pass(v, basis, k)
    return v


def orthogonalize_bcgs_dyn_coeffs(v, basis, k: int, passes: int = 2, group=None):
    """Like :func:`orthogonalize_bcgs_dyn` but also returns the projection
    coefficients summed over the passes, ``c`` of shape ``(k,)`` (port of
    ``lanczos_tpu.core.linalg.orthogonalize_bcgs_dyn_coeffs``).

    For an orthonormal live basis ``c[i]`` equals the first-pass
    coefficient ``<u_i, v>`` up to O(eps |c|): the new column of the
    projected matrix of the thick-restart engine.  Plain PyTorch matrix
    products over the live rows, as the JAX package leaves this pass to XLA.
    """
    rows = basis[:k]
    c_tot = torch.zeros(k, dtype=v.dtype, device=v.device)
    for _ in range(passes):
        c = reduce_sum(typed_conj(rows) @ v, group)
        v = v - c @ rows
        c_tot = c_tot + c
    return v, c_tot


def block_inner_f64(u, w, group=None):
    """All pairwise ``<u_i, w_j>`` of two row blocks, accumulated in float64
    (complex128 for complex inputs): the ``(rows(u), rows(w))`` coefficient
    matrix.  Replaces the JAX package's double-float pair dots
    (``block_thick._pair_dots_df``), which exist because the TPU has no
    float64."""
    wide = torch.complex128 if u.is_complex() else torch.float64
    return reduce_sum(typed_conj(u.to(wide)) @ w.to(wide).T, group)
