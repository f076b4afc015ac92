"""Fused block thick-restart Lanczos: degenerate clusters in one build
(port of ``lanczos_tpu.solvers.block_thick`` without its precise-vector
engine).

It combines the block engine (block_lanczos.py: a width-b block captures
multiplicity <= b in one build, and every reorthogonalization pass reads the
basis once for all b vectors) with thick restart (thick_restart.py: keep the
l best Ritz vectors with exact couplings when the buffer fills).

Each block step is queued on the operator's device without waiting; the host
waits once per segment boundary, reading every new (b, b) coefficient block
in one transfer, and runs the float64 convergence test on the arrowhead band
matrix

    T = [[diag(theta_kept),  S,     0 ],
         [S^H,               A_0,  R_0^H, ...],
         [0,                 R_0,  A_1,  ...]]

where S = Y^H (A + offset) U_0 couples the kept Ritz vectors to the first
new block only.

Per-step numerics:
  W   = (A + offset) U_k                       (one block matvec)
  A_k = U_k^H W                                (float64 dots when precise)
  W  -= A_k^T U_k + B_{k-1}^H U_{k-1}          (three-term block recurrence)
  W   = cgs(W, deflation + kept Ritz)          (block CGS, matrix products)
  W   = bcgs(W, live basis rows)               (kernel K4 on a CUDA device)
  U_{k+1}, R_k = mgs(W)                        (in-block MGS: W = R^T U,
                                                dead rows exactly zero)
A dead row (a zero diag(R) entry) ends the step sequence at the next
boundary; the host repairs the dead rows with fresh random directions and
resumes, or, when nothing is revivable, treats the build as space-exhausted
(the block form of the beta breakdown, lambda_lanczos.hpp:279-283).
Convergence combines the reference's relative-drift test with the free band
residual bound ``||R_last q_lastblock|| <= sqrt(eps) * scale``.

For float32 storage the JAX engine carries the coefficient blocks as df64
word pairs; the port takes float64 dot products of the float32 vectors
(:func:`lanczos_tpu_torch.core.linalg.block_inner_f64`) and keeps the
float64 values for the host's T.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import linalg
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from ..ops import cgs
from .block_lanczos import _orthonormalize_block, _repair_block
from .lanczos import LanczosConfig, _host_dtype, _rotate, deflation_driver
from .lanczos_fused import _PV_ITEM, _add_reorth
from .thick_restart import thick_lanczos_iteration_fused

__all__ = ["block_thick_iteration_fused", "lanczos_run_block_thick"]


def _block_matvec(op, u_rows, offset: float):
    """(A + offset) applied to every row of a (b, n) block."""
    return op.matvec_rows(u_rows) + offset * u_rows


def _fresh_block(rng, b: int, n: int, dtype, device):
    """A (b, n) uniform [-1, 1] block drawn on the device from a generator
    seeded by the host ``rng`` (no host-sized upload per repair)."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**31 - 1)))
    rdtype = real_dtype(dtype)

    def draw():
        return torch.rand((b, n), generator=gen, dtype=rdtype, device=device) * 2 - 1

    if is_complex_dtype(dtype):
        re = draw()
        return torch.complex(re, draw()).to(dtype)
    return draw().to(dtype)


def _block_cgs(w, rows, row_mask, passes: int = 1):
    """Classical GS passes of the (b, n) block ``w`` against the masked
    ``rows`` (the deflation slot): each pass reads ``rows`` once for all b
    vectors, as two matrix products."""
    if rows.shape[0] == 0:
        return w
    rc = linalg.typed_conj(rows)
    for _ in range(passes):
        c = (rc @ w.T) * row_mask.to(w.dtype)[:, None]
        w = w - c.T @ rows
    return w


def _bcgs_block(w, basis, live: int, passes: int = 1):
    """Classical GS passes of the (b, n) block ``w`` against rows
    [0, live) of ``basis``: kernel K4 on a CUDA device (in place on ``w``),
    its plain version on the CPU, which reads only the live rows where the
    JAX package's CPU path masks the whole buffer (the same result up to
    summation order)."""
    for _ in range(passes):
        w = cgs.cgs_pass_block(w, basis, live)
    return w


def _mgs_block(w, breakdown_eps: float, precise: bool = False):
    """In-block sequential MGS: returns ``(u_next, r, r64, live)`` with
    ``w = r^T u_next`` (r upper triangular, the B_k band coupling) and
    per-row ``live`` flags.

    A row whose residual norm falls below ``breakdown_eps`` becomes exactly
    zero with a zero R diagonal, so a per-row rank collapse is visible to the
    host.  ``precise`` (real float32): the coefficients and norms come from
    float64 dots, ``r`` holds them rounded to float32 and ``r64`` (else None)
    the float64 values for the host's T."""
    b = w.shape[0]
    dtype = w.dtype
    rdtype = real_dtype(dtype)
    tiny = torch.finfo(rdtype).tiny
    zero = torch.zeros((), dtype=dtype, device=w.device)
    zero64 = torch.zeros((), dtype=torch.float64, device=w.device)

    outs = []
    live = []
    r_cols = []
    r64_cols = []
    for j in range(b):
        wj = w[j]
        col = []
        col64 = []
        for i in range(j):
            if precise:
                c64 = linalg.inner_prod_f64(outs[i], wj)
                c = c64.to(dtype)
                col64.append(c64)
            else:
                c = linalg.inner_prod(outs[i], wj).to(dtype)
            wj = wj - c * outs[i]
            col.append(c)
        if precise:
            nrm64 = torch.sqrt(linalg.inner_prod_f64(wj, wj).real)
            nrm = nrm64.to(rdtype)
        else:
            nrm = linalg.norm(wj).to(rdtype)
        live_j = nrm > breakdown_eps
        outs.append(torch.where(live_j, wj / nrm.clamp_min(tiny), torch.zeros_like(wj)))
        col.append(torch.where(live_j, nrm.to(dtype), zero))
        col.extend([zero] * (b - 1 - j))
        r_cols.append(torch.stack(col))
        if precise:
            col64.append(torch.where(live_j, nrm64, zero64))
            col64.extend([zero64] * (b - 1 - j))
            r64_cols.append(torch.stack(col64))
        live.append(live_j)
    r = torch.stack(r_cols, dim=1)  # r[i, j] = col_j[i]: upper triangular
    r64 = torch.stack(r64_cols, dim=1) if precise else None
    return torch.stack(outs), r, r64, torch.stack(live)


class _BlockState:
    """One block build: the (cap_b + 1) b-row basis buffer, the coefficient
    blocks on the device, and their float64 copies on the host.

    A new cycle rewrites rows of the same buffer in place (:meth:`reset`),
    so a solve never holds two ((cap_b + 1) b, n) buffers — the JAX engine
    donates its state for the same reason (lanczos_tpu/solvers/block_thick.py:284-298).
    """

    def __init__(self, u0, cap_b: int, precise: bool, host_c):
        b, n = u0.shape
        dev, dtype = u0.device, u0.dtype
        self.b = b
        self.cap_b = cap_b
        self.u_buf = torch.zeros(((cap_b + 1) * b, n), dtype=dtype, device=dev)
        # A_k for the host only (float64 under precise reductions); R_k in
        # the storage dtype for the recurrence, plus its float64 values for
        # the host under precise reductions.
        self.a_buf = torch.zeros((cap_b, b, b), dtype=torch.float64 if precise else dtype, device=dev)
        self.r_buf = torch.zeros((cap_b, b, b), dtype=dtype, device=dev)
        self.r64 = torch.zeros((cap_b, b, b), dtype=torch.float64, device=dev) if precise else None
        self.a_host = np.zeros((cap_b, b, b), dtype=host_c)
        self.r_host = np.zeros((cap_b, b, b), dtype=host_c)
        self.reset(u0)

    def reset(self, u0) -> None:
        """Start a new cycle from the (b, n) block ``u0``: stale rows and
        blocks past the new live counts are never read."""
        self.u_buf[: self.b] = u0
        self.k = 0  # completed block steps
        self.stop = False  # rank collapse (block breakdown)
        self.itern = 0  # block count at the collapse


def _fused_block_stage(op, st: _BlockState, defl, defl_mask, offset: float, k_limit: int, passes: int, precise: bool):
    """Advance the block build to ``k_limit`` completed steps, or to the
    first step that leaves a dead row (the JAX engine's while-loop stop).

    The steps are queued without waiting; then ONE transfer brings the new
    coefficient blocks to the host.  A dead row at step j ends the build at
    ``j + 1`` steps: the steps queued after it are discarded, their rows and
    blocks lie past the live counts and are never read.
    """
    b = st.b
    rdtype = real_dtype(st.u_buf.dtype)
    breakdown_eps = machine_eps(rdtype) * 10.0
    k0 = st.k
    k_lim = min(int(k_limit), st.cap_b)
    for k in range(k0, k_lim):
        u_k = st.u_buf[k * b : (k + 1) * b]
        w = _block_matvec(op, u_k, offset)
        if precise:
            a64 = linalg.block_inner_f64(u_k, w)
            a_k = a64.to(w.dtype)
            st.a_buf[k] = a64
        else:
            a_k = linalg.typed_conj(u_k) @ w.T
            st.a_buf[k] = a_k
        w = w - a_k.T @ u_k
        if k >= 1:
            w = w - st.r_buf[k - 1].conj() @ st.u_buf[(k - 1) * b : k * b]
        # Deflation slot (accepted pairs + kept Ritz vectors), then the live
        # basis rows: the reference's order (lambda_lanczos.hpp:259-260).
        w = _block_cgs(w, defl, defl_mask, passes=passes)
        w = _bcgs_block(w.contiguous(), st.u_buf, (k + 1) * b, passes=passes)
        u_next, r_k, r64_k, _live = _mgs_block(w, breakdown_eps, precise)
        st.u_buf[(k + 1) * b : (k + 2) * b] = u_next
        st.r_buf[k] = r_k
        if precise:
            st.r64[k] = r64_k
    if k_lim <= k0:
        return
    r_src = st.r64 if precise else st.r_buf
    host = torch.stack([st.a_buf[k0:k_lim], r_src[k0:k_lim].to(st.a_buf.dtype)]).cpu().numpy()
    st.a_host[k0:k_lim] = host[0]
    st.r_host[k0:k_lim] = host[1]
    dead = np.abs(np.diagonal(host[1], axis1=1, axis2=2)) == 0.0
    bad = np.nonzero(dead.any(axis=1))[0]
    if bad.size:
        st.stop = True
        st.itern = k0 + int(bad[0]) + 1
        st.k = st.itern
    else:
        st.k = k_lim


def _repair_candidates(u_buf, defl, defl_mask, fresh, dead, live_rows_incl: int):
    """Replace the dead rows (host bool mask ``dead``) of the candidate
    block, the last b of the first ``live_rows_incl`` rows of ``u_buf``, by
    fresh directions orthonormal to the deflation slot, every basis row up
    to ``live_rows_incl`` and each other; its live rows stay as they are.
    Returns the repaired (b, n) block and the host per-row revived flags.
    The replacements carry zero band coupling (their true residual was ~0)."""
    b = fresh.shape[0]
    rdtype = real_dtype(u_buf.dtype)
    tol = machine_eps(rdtype) * 100.0
    tiny = torch.finfo(rdtype).tiny
    cand = u_buf[live_rows_incl - b : live_rows_incl]
    outs = []
    revived = []
    for j in range(b):
        v = linalg.orthogonalize_cgs2(fresh[j].clone(), defl, defl_mask)
        v = linalg.orthogonalize_bcgs_dyn(v, u_buf, live_rows_incl)
        for u in outs:
            v = v - linalg.inner_prod(u, v) * u
        nrm = linalg.norm(v).to(rdtype)
        ok = (nrm > tol) & bool(dead[j])
        outs.append(torch.where(ok, v / nrm.clamp_min(tiny), torch.zeros_like(v)))
        revived.append(ok)
    mask = torch.as_tensor(dead, device=u_buf.device)[:, None]
    block = torch.where(mask, torch.stack(outs), cand)
    return block, torch.stack(revived).cpu().numpy()


def _rotate_two(q_y, y_rows, q_u, u_buf):
    """Ritz recombination over [Y; U] as two products over the live rows
    (a concatenated basis would hold a second (cap, n) buffer); ``q_y`` and
    ``q_u`` are host coefficient matrices with one column per row used."""
    ritz = _rotate(q_u, u_buf)
    if q_y.shape[1]:
        ritz = ritz + _rotate(q_y, y_rows)
    return ritz


def _coupling_block(op, y_rows, u0, offset: float, precise: bool):
    """S = Y^H (A + offset) U_0, the (l, b) arrowhead couplings, on the host
    (one block matvec per restart; float64 dots when ``precise``)."""
    au = _block_matvec(op, u0, offset)
    s = linalg.block_inner_f64(y_rows, au) if precise else linalg.typed_conj(y_rows) @ au.T
    return s.cpu().numpy()


def block_thick_iteration_fused(op, v0_block, nroot: int, defl, defl_mask, cfg: LanczosConfig, block_size: int, rng=None):
    """One deflated solve of the fused block thick-restart engine; returns
    ``(eigenvalues, eigenvectors, total_block_steps, converged)``."""
    if cfg.precise_vectors:
        raise NotImplementedError(f"precise_vectors is not ported; see {_PV_ITEM}")

    dtype = v0_block.dtype
    dev = v0_block.device
    n = cfg.matrix_size
    b = int(block_size)

    # When the space left after deflation is only a few blocks wide, rank
    # collapse is structural and dead rows would enter the band matrix as
    # spurious zero eigenvalues: such tails go to the scalar thick engine.
    nd_live = int(round(float(defl_mask.sum()))) if defl_mask.numel() else 0
    if n - nd_live < 4 * b:
        return thick_lanczos_iteration_fused(op, v0_block[0], nroot, defl, defl_mask, cfg)
    host_c = _host_dtype(dtype)
    # Fresh entropy by default: a fixed seed would replay the same repair
    # directions every deflation round.
    rng = rng if rng is not None else np.random.default_rng()
    precise = bool(cfg.precise_reductions) and real_dtype(dtype) == torch.float32 and not is_complex_dtype(dtype)
    passes = max(int(cfg.reorth_passes), 1)
    offset = float(cfg.eigenvalue_offset)

    m_max_rows = max(min(cfg.max_iteration, n), 3 * b)
    # Kept-subspace width: a cluster converges collectively, so the kept set
    # covers the wanted roots plus a buffer of the block's order.
    l_keep = cfg.resolve_thick_keep(nroot + max(2, b), m_max_rows - 2 * b)
    cap_b = max(m_max_rows // b, 2)
    nd = defl.shape[0]

    # Deflation slot = accepted pairs + kept Ritz vectors (cycles >= 1); the
    # engine passes the live rows [0, nd + l_cur) of one buffer.
    defl_big = torch.zeros((nd + l_keep, n), dtype=dtype, device=dev)
    defl_big[:nd] = defl
    mask_big = torch.ones(nd + l_keep, dtype=defl_mask.dtype, device=dev)
    mask_big[:nd] = defl_mask

    # Start block: orthonormal against the accepted pairs; identical rows
    # (fixed-seed initializers) are repaired with fresh random directions.
    zero_basis = torch.zeros((b, n), dtype=dtype, device=dev)
    u0, live = _orthonormalize_block(v0_block, defl, defl_mask, zero_basis, 0)
    dead0 = live.cpu().numpy() < 0.5
    if np.any(dead0):
        u0, _ = _repair_block(u0, defl, defl_mask, zero_basis, 0, _fresh_block(rng, b, n, dtype, dev), dead0)

    theta_kept = np.zeros(0, dtype=np.float64)
    y_rows = defl_big[nd:]
    s_host = np.zeros((0, b), dtype=host_c)

    total_steps = 0
    pevs = None
    converged = False

    def resid_ok(theta_all, q_all, r_last, l_cur, kb):
        """Free a posteriori residual bound from the band matrix: the
        residual of a Ritz pair is ||R_last @ q[last-block rows]||; gated at
        sqrt(eps) * scale so the drift test cannot fire on a plateau."""
        m_tot = l_cur + kb * b
        n_want = min(int(nroot), m_tot)
        sel = list(range(m_tot - 1, m_tot - 1 - n_want, -1)) if cfg.find_maximum else list(range(n_want))
        res = np.linalg.norm(r_last @ q_all[m_tot - b :, sel], axis=0)
        scale = max(np.max(np.abs(theta_all)), np.finfo(np.float64).tiny)
        return bool(np.all(res <= np.sqrt(cfg.eps) * scale))

    def assemble_t(l_cur, a_blocks, r_blocks, kb):
        """Arrowhead band matrix over [Y (l_cur); U_0 .. U_{kb-1}]."""
        m_tot = l_cur + kb * b
        t = np.zeros((m_tot, m_tot), dtype=host_c)
        if l_cur:
            t[np.arange(l_cur), np.arange(l_cur)] = theta_kept[:l_cur]
            t[:l_cur, l_cur : l_cur + b] = s_host[:l_cur]
            t[l_cur : l_cur + b, :l_cur] = s_host[:l_cur].conj().T
        for j in range(kb):
            blk = a_blocks[j]
            o = l_cur + j * b
            t[o : o + b, o : o + b] = (blk + blk.conj().T) / 2
        for j in range(kb - 1):  # R_j couples block j and j+1
            o = l_cur + j * b
            t[o + b : o + 2 * b, o : o + b] = r_blocks[j]
            t[o : o + b, o + b : o + 2 * b] = r_blocks[j].conj().T
        return (t + t.conj().T) / 2

    st = None
    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_kept.shape[0]
        kb_max = max((m_max_rows - l_cur) // b, 1)
        defl_v, mask_v = defl_big[: nd + l_cur], mask_big[: nd + l_cur]

        if st is None:
            st = _BlockState(u0, cap_b, precise, host_c)
        else:
            st.reset(u0)
        seg = min(kb_max, max(-(-2 * (l_cur + int(nroot)) // b), -(-kb_max // 8), 2))
        pseg = None
        seg_conv = False
        invariant = False
        boundary = None
        while True:
            _fused_block_stage(op, st, defl_v, mask_v, offset, seg, passes, precise)
            if st.stop:
                # Rank collapse at step kb_done - 1: the candidate block has
                # dead rows (diag(R) == 0 marks them).
                kb_done = st.itern
                dead = np.abs(np.diag(st.r_host[kb_done - 1])) == 0.0
                if dead.all():
                    invariant = True  # full breakdown: the Krylov space closed
                    break
                # Partial collapse: repair the dead rows with fresh random
                # directions (zero band coupling) and resume the same build.
                block, revived = _repair_candidates(
                    st.u_buf, defl_v, mask_v, _fresh_block(rng, b, n, dtype, dev), dead, (kb_done + 1) * b
                )
                if not bool(np.all(revived[dead])):
                    # Not everything revivable: the explored space is
                    # essentially exhausted; accept the current values.
                    invariant = True
                    break
                st.u_buf[kb_done * b : (kb_done + 1) * b] = block
                st.stop = False
                st.itern = 0
                continue
            kb_done = st.k
            if seg >= kb_max:
                boundary = None
                break
            a_blocks, r_blocks = st.a_host[:kb_done], st.r_host[:kb_done]
            th, q_seg = np.linalg.eigh(assemble_t(l_cur, a_blocks, r_blocks, kb_done))
            boundary = (th, q_seg)  # reused at the cycle's end
            want = min(int(nroot), th.shape[0])
            evs_seg = th[::-1][:want] if cfg.find_maximum else th[:want]
            if (
                pseg is not None
                and pseg.shape[0] == evs_seg.shape[0]
                and evs_seg.shape[0] == nroot
                and np.all(np.abs(evs_seg - pseg) < np.minimum(np.abs(evs_seg), np.abs(pseg)) * cfg.eps)
                and resid_ok(th, q_seg, r_blocks[kb_done - 1], l_cur, kb_done)
            ):
                seg_conv = True  # converged mid-cycle: skip the rest of the budget
                break
            pseg = evs_seg
            seg = min(2 * seg, kb_max)

        total_steps += kb_done
        _add_reorth(kb_done)
        a_blocks, r_blocks = st.a_host[:kb_done], st.r_host[:kb_done]
        theta_pre = q_pre = None
        if seg_conv and boundary is not None:
            # The converged boundary already diagonalized exactly this T.
            theta_pre, q_pre = boundary
        t_mat = assemble_t(l_cur, a_blocks, r_blocks, kb_done)
        cand_live = np.zeros(0, np.intp)
        if invariant:
            # Space-exhausted exit: the candidate block's live rows span the
            # last unexplored directions and join the final Rayleigh-Ritz
            # (one extra block matvec for the candidate diagonal block).
            r_last = r_blocks[kb_done - 1]
            cand_live = np.nonzero(np.abs(np.diag(r_last)) > 0)[0]
            if cand_live.size:
                cand = st.u_buf[kb_done * b : (kb_done + 1) * b]
                a_cand = np.asarray(_coupling_block(op, cand, cand, offset, precise), host_c)
                m_arrow = t_mat.shape[0]
                ncl = int(cand_live.size)
                t_ext = np.zeros((m_arrow + ncl, m_arrow + ncl), host_c)
                t_ext[:m_arrow, :m_arrow] = t_mat
                cpl = r_last[cand_live, :]  # candidate-live rows x last block
                t_ext[m_arrow:, m_arrow - b : m_arrow] = cpl
                t_ext[m_arrow - b : m_arrow, m_arrow:] = cpl.conj().T
                blk = a_cand[np.ix_(cand_live, cand_live)]
                t_ext[m_arrow:, m_arrow:] = (blk + blk.conj().T) / 2
                t_mat = (t_ext + t_ext.conj().T) / 2
        m_tot = t_mat.shape[0]
        if theta_pre is not None and theta_pre.shape[0] == m_tot:
            theta_all, q_all = theta_pre, q_pre
        else:
            theta_all, q_all = np.linalg.eigh(t_mat)

        m_want = min(nroot, m_tot)
        evs = theta_all[::-1][:m_want] if cfg.find_maximum else theta_all[:m_want]

        if invariant or seg_conv:  # rank breakdown (invariant subspace) or drift
            converged = True
        elif pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            diffs = np.abs(evs - pevs)
            tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
            if np.all(diffs < tol) and resid_ok(theta_all, q_all, r_blocks[kb_done - 1], l_cur, kb_done):
                converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1
        n_sel = min(nroot, m_tot) if last_cycle else min(l_keep, m_tot)
        sel = [m_tot - 1 - i for i in range(n_sel)] if cfg.find_maximum else list(range(n_sel))

        q_y = q_all[:l_cur, sel].T
        rows_used = kb_done * b + (b if cand_live.size else 0)
        q_u = np.zeros((n_sel, rows_used), dtype=host_c)
        q_u[:, : kb_done * b] = q_all[l_cur : l_cur + kb_done * b, sel].T
        for a_i, li in enumerate(cand_live):  # extension rows -> live candidate rows
            q_u[:, kb_done * b + int(li)] = q_all[l_cur + kb_done * b + a_i, sel]
        ritz = _rotate_two(q_y, y_rows, q_u, st.u_buf)

        if last_cycle:
            norms = torch.sqrt(torch.sum(ritz.abs() ** 2, dim=1, keepdim=True))
            eigvecs = ritz / norms.clamp_min(torch.finfo(real_dtype(dtype)).tiny)
            eigenvalues = [float(theta_all[s]) - cfg.eigenvalue_offset for s in sel]
            return eigenvalues, eigvecs, total_steps, converged or m_tot >= n

        # Thick restart: Y' = the selected Ritz vectors (rows of the
        # deflation slot); the next start block is the candidate block,
        # already orthonormal against everything.
        theta_kept = theta_all[sel]
        y_rows[:n_sel] = ritz
        u0 = st.u_buf[kb_done * b : (kb_done + 1) * b].clone()
        s_host = np.asarray(_coupling_block(op, y_rows[:n_sel], u0, offset, precise), host_c)


def lanczos_run_block_thick(op, cfg: LanczosConfig, init_vector, dtype, block_size: int):
    """Block thick-restart engine under the shared deflation driver (the
    start is a block of ``block_size`` rows; the engine restarts
    internally)."""
    cfg = cfg.resolved(dtype)
    b = max(int(block_size), 1)
    return deflation_driver(
        lambda v0, nroot, defl, mask: block_thick_iteration_fused(op, v0, nroot, defl, mask, cfg, b),
        cfg, init_vector, dtype, device=op.device, v0_rows=b, use_warm_restarts=False,
    )
