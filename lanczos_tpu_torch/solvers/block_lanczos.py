"""Block Lanczos with warm restarts (port of
``lanczos_tpu.solvers.block_lanczos``).

A width-b block captures an eigenvalue of multiplicity <= b in one Krylov
build, where the reference resolves it by repeated deflated restarts
(lambda_lanczos.hpp:330-366).  Standard block Lanczos with full
reorthogonalization:

  W     = A U_k                      (block matvec)
  A_k   = U_k^H W                    (b x b, Hermitian)
  W     = W - U_k A_k - U_{k-1} B_{k-1}^H
  W     = reorth(W, deflated eigenvectors, every previous basis row)
  U_{k+1}, B_k = QR(W)               (tall-skinny QR, b x b upper-tri B)

Convergence runs on the host in float64 over the (k b x k b) band matrix
with the reference's relative-change test (lambda_lanczos.hpp:267-309); a
rank collapse (diag(R) ~ 0) is the block form of the beta breakdown
(:279-283).  Blocks are (b, n) rows and the basis a flat (cap*b, n) row
buffer, so each row's reorthogonalization is kernel K3 on a CUDA device
(``linalg.orthogonalize_bcgs_dyn``), as the JAX package runs its scalar
pass per row.

Over a row-partitioned operator the rows are this rank's slabs: the
reductions go through ``op.group``, the tall-skinny QR is a TSQR (each
rank's local QR, then one QR of the gathered b x b factors), and the
repair draws are the one-process draws' slabs (``linalg.slab``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import linalg
from ..core.types import machine_eps, real_dtype
from ..parallel.sharded import draw_group
from ..utils.random import _fresh_rng
from .lanczos import LanczosConfig, LanczosResult, _host_dtype, _rotate, _unit_rows, deflation_driver

__all__ = ["block_lanczos_iteration", "block_lanczos_run"]


def _host(t, dtype):
    return np.asarray(t.cpu().numpy(), dtype)


def _orthonormalize_block(rows, defl, defl_mask, basis, live_rows: int, group=None):
    """Orthonormalize the b rows against the deflated eigenvectors, the
    first ``live_rows`` basis rows and each other; a row with no surviving
    component becomes zero (never arbitrary).  Returns the (b, n) block and
    the (b,) norms, zero for dead rows.

    Plain QR fills a rank-deficient block's null directions with arbitrary
    orthonormal columns that may overlap the deflation space or the basis;
    zero rows are inert downstream (zero matvec, zero couplings, dropped by
    the generalized Rayleigh-Ritz)."""
    b = rows.shape[0]
    rdtype = real_dtype(rows.dtype)
    tol = machine_eps(rdtype) * 100.0
    tiny = torch.finfo(rdtype).tiny
    out = []
    norms = []
    for j in range(b):
        # A copy: on a CUDA device the K3 pass below overwrites its input.
        v = rows[j].clone()
        v = linalg.orthogonalize_cgs2(v, defl, defl_mask, group=group)
        v = linalg.orthogonalize_bcgs_dyn(v, basis, live_rows, group=group)
        for u in out:
            v = v - linalg.inner_prod(u, v, group) * u
        nrm = linalg.norm(v, group).to(rdtype)
        live = nrm > tol
        out.append(torch.where(live, v / nrm.clamp_min(tiny), torch.zeros_like(v)))
        norms.append(torch.where(live, nrm, torch.zeros_like(nrm)))
    return torch.stack(out), torch.stack(norms)


def _block_step(op, basis, defl, defl_mask, u_k, u_km1, b_km1, k: int, offset: float, passes: int = 2):
    """One block iteration; writes ``u_k`` into the basis (in place) and
    returns ``(u_next, a_k, r_k, live_norms)``.

    basis: (cap*b, n) flat row buffer; rows [0, k*b) are valid.
    u_k/u_km1: (b, n) current/previous blocks; b_km1: (b, b) previous R.
    """
    b = u_k.shape[0]
    group = getattr(op, "group", None)
    w = op.matvec_rows(u_k) + offset * u_k
    # Block overlap A_k[i, j] = <u_i, w_j> (Hermitian up to rounding).
    a_k = linalg.reduce_sum(linalg.typed_conj(u_k) @ w.T, group)
    w = w - a_k.T @ u_k
    w = w - b_km1.conj() @ u_km1  # B_{k-1}^H as rows

    # Full reorthogonalization: deflated eigenvectors, then the live basis rows.
    w = torch.stack([
        linalg.orthogonalize_bcgs_dyn(linalg.orthogonalize_cgs2(w[j], defl, defl_mask, passes=passes, group=group),
                                      basis, k * b, passes=passes, group=group)
        for j in range(b)
    ])

    # Tall-skinny QR: W^T = Q R with Q (n, b) orthonormal columns.
    q, r = _tsqr(w.T, group)
    basis[k * b : (k + 1) * b] = u_k

    # Safety orthonormalization: QR's arbitrary null-space columns become
    # zero rows; the live-row norms are the rank signal.
    u_next, live_norms = _orthonormalize_block(q.T.contiguous(), defl, defl_mask, basis, (k + 1) * b, group)
    return u_next, a_k, r, live_norms


def _tsqr(x, group=None):
    """The reduced QR of the (rows, b) matrix ``x``; over a group of more
    than one rank ``x`` is this rank's slab of rows and the QR a TSQR: the
    local QR, an all-gather of the (b, b) factors, one QR of their stack
    (the same on every rank) and the local Q times this rank's block of
    it."""
    q, r = torch.linalg.qr(x, mode="reduced")
    if not linalg.splits(group):
        return q, r
    b = r.shape[0]
    stacked = r.new_empty((dist.get_world_size(group) * b, b))
    dist.all_gather_into_tensor(stacked, r.contiguous(), group=group)
    q2, r2 = torch.linalg.qr(stacked, mode="reduced")
    rank = dist.get_rank(group)
    return q @ q2[rank * b : (rank + 1) * b], r2


def _band_matrix(a_blocks, b_blocks, dtype=np.complex128):
    """The (m b x m b) Hermitian band matrix on the host."""
    m = len(a_blocks)
    b = a_blocks[0].shape[0]
    t = np.zeros((m * b, m * b), dtype=dtype)
    for k, a in enumerate(a_blocks):
        blk = np.asarray(a, dtype=dtype)
        t[k * b : (k + 1) * b, k * b : (k + 1) * b] = (blk + blk.conj().T) / 2
    for k, r in enumerate(b_blocks):  # couples block k and k+1
        rb = np.asarray(r, dtype=dtype)
        t[(k + 1) * b : (k + 2) * b, k * b : (k + 1) * b] = rb
        t[k * b : (k + 1) * b, (k + 1) * b : (k + 2) * b] = rb.conj().T
    return t


def _fresh_rows(rng, b: int, n: int, like, group=None):
    """A (b, n) uniform [-1, 1] block from the host ``rng`` (real and
    imaginary parts for complex types), on ``like``'s device; over a group,
    this rank's slab of it (``like``'s width)."""
    fresh = rng.uniform(-1, 1, (b, n))
    if like.is_complex():
        fresh = fresh + 1j * rng.uniform(-1, 1, (b, n))
    return linalg.slab(torch.as_tensor(fresh, device=like.device).to(like.dtype), like.shape[-1], group)


def _repair_block(u_next, defl, defl_mask, basis, live_rows: int, fresh, deficient, group=None):
    """Replace the dead rows (host bool mask ``deficient``) of a block with
    fresh random directions and orthonormalize again.  The replacements carry
    zero band coupling — a restart inside the block, the block form of the
    reference's deflated random restarts (lambda_lanczos.hpp:231-234)."""
    mask = torch.as_tensor(deficient, device=u_next.device)[:, None]
    mixed = torch.where(mask, fresh.to(u_next.dtype), u_next)
    return _orthonormalize_block(mixed, defl, defl_mask, basis, live_rows, group)


def block_lanczos_iteration(op, v0_block, nroot: int, defl, defl_mask, cfg: LanczosConfig, block_size: int, rng=None):
    """One deflated block restart; the return contract of
    :func:`lanczos_tpu_torch.solvers.lanczos.lanczos_iteration`."""
    dtype = v0_block.dtype
    n = cfg.matrix_size
    b = int(block_size)
    max_blocks = max(min(cfg.max_iteration, -(-n // b)), 1)
    host_dtype = _host_dtype(dtype)
    group = getattr(op, "group", None)
    # Fresh entropy by default (the same on every rank of the draw group): a fixed seed would
    # replay the same repair directions every deflated restart.
    rng = rng if rng is not None else _fresh_rng(draw_group(op))

    basis = torch.zeros((max_blocks * b, v0_block.shape[1]), dtype=dtype, device=v0_block.device)

    # Orthonormalize the start block against the accepted pairs; repair a
    # rank deficiency (a fixed-seed initializer gives identical rows) with
    # independent random directions.
    u_k, live = _orthonormalize_block(v0_block, defl, defl_mask, basis, 0, group)
    dead = live.cpu().numpy() < 0.5
    if np.any(dead):
        u_k, live = _repair_block(u_k, defl, defl_mask, basis, 0, _fresh_rows(rng, b, n, u_k, group), dead, group)

    u_km1 = torch.zeros_like(u_k)
    b_km1 = torch.zeros((b, b), dtype=dtype, device=u_k.device)

    a_blocks: list[np.ndarray] = []
    b_blocks: list[np.ndarray] = []
    pevs = None
    itern = max_blocks
    offset = float(cfg.eigenvalue_offset)
    for k in range(max_blocks):
        u_next, a_k, r_k, rdiag = _block_step(
            op, basis, defl, defl_mask, u_k, u_km1, b_km1, k, offset, passes=int(cfg.reorth_passes)
        )
        a_blocks.append(_host(a_k, host_dtype))
        rd = rdiag.cpu().numpy()

        t = _band_matrix(a_blocks, b_blocks, host_dtype)
        evs_all = np.linalg.eigvalsh(t)
        m_want = min(nroot, t.shape[0])
        evs = evs_all[::-1][:m_want] if cfg.find_maximum else evs_all[:m_want]

        deficient = rd < 0.5  # live-norm signal from the safety pass
        if np.any(deficient):
            if (k + 1) * b >= n:  # the basis spans the whole space: exact exit
                itern = k + 1
                break
            # Krylov direction exhausted but space remains: repair the block
            # with fresh random directions (zero B coupling).
            u_next, live2 = _repair_block(
                u_next, defl, defl_mask, basis, (k + 1) * b, _fresh_rows(rng, b, n, u_next, group), deficient, group
            )
            r_k = torch.where(torch.as_tensor(deficient, device=r_k.device)[:, None], torch.zeros_like(r_k), r_k)
            if np.all(live2.cpu().numpy() < 0.5):
                itern = k + 1  # nothing left to explore
                break
        if pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            if np.all(np.abs(evs - pevs) < np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps):
                itern = k + 1
                break
        pevs = evs

        b_blocks.append(_host(r_k, host_dtype))
        u_km1, u_k, b_km1 = u_k, u_next, r_k

    # Ritz extraction: generalized Rayleigh-Ritz over the stored rows.  The
    # band matrix drives the convergence test; the extraction recomputes
    # T = V A V^H and S = V V^H, because after a rank repair orthogonality of
    # the basis is not guaranteed, and canonical orthogonalization (drop
    # S-eigenvalues ~ 0) is exact for any spanning set.
    m_rows = len(a_blocks) * b
    v_rows = basis[:m_rows]
    w_rows = op.matvec_rows(v_rows)
    if cfg.eigenvalue_offset:
        w_rows = w_rows + offset * v_rows
    vc = linalg.typed_conj(v_rows)
    t_small = _host(linalg.reduce_sum(vc @ w_rows.T, group), host_dtype)
    s_small = _host(linalg.reduce_sum(vc @ v_rows.T, group), host_dtype)
    t_small = (t_small + t_small.conj().T) / 2
    s_small = (s_small + s_small.conj().T) / 2

    s_w, s_v = np.linalg.eigh(s_small)
    keep = s_w > 1e-10
    x = s_v[:, keep] / np.sqrt(s_w[keep])
    t_proj = x.conj().T @ t_small @ x
    t_proj = (t_proj + t_proj.conj().T) / 2
    w_all, y = np.linalg.eigh(t_proj)
    coeff = x @ y  # (m_rows, n_kept) basis-row coefficients per Ritz pair

    n_kept = coeff.shape[1]
    num_out = min(nroot, n_kept)
    sel = [n_kept - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    eigvecs = _unit_rows(_rotate(coeff[:, sel].T, v_rows), group)

    eigenvalues = [float(w_all[s]) - cfg.eigenvalue_offset for s in sel]
    converged = itern < max_blocks or max_blocks * b >= n
    return eigenvalues, eigvecs, itern, converged


def block_lanczos_run(op, cfg: LanczosConfig, init_vector, dtype, block_size: int) -> LanczosResult:
    """Block engine under the shared deflation driver (the start is a block
    of ``block_size`` rows; warm restarts reuse the top-b Ritz vectors)."""
    cfg = cfg.resolved(dtype)
    b = max(int(block_size), 1)
    return deflation_driver(
        lambda v0, nroot, defl, mask: block_lanczos_iteration(op, v0, nroot, defl, mask, cfg, b),
        cfg, init_vector, dtype, device=op.device, v0_rows=b,
    )
