"""Thick-restart Lanczos (TRLan), bounded memory with subspace reuse (port
of ``lanczos_tpu.solvers.thick_restart``).

Warm restarts (``run_restarted``) keep one Ritz vector and lose the rest of
the subspace.  Thick restart keeps the best ``l`` Ritz vectors with their
exact couplings and continues the build, so a capped basis converges almost
as if unrestarted (Wu & Simon, SIAM J. Matrix Anal. 2000).  Two engines:

* :func:`thick_lanczos_iteration` (hybrid) keeps the projected matrix
  ``T = V^H (A + offset) V`` on the host: each iteration's CGS coefficients
  are the new column of T, pulled to the host with beta in one transfer.
* :func:`thick_lanczos_iteration_fused` runs each cycle on the fused
  engine's build (``lanczos_fused._Build`` / ``_run_stage``, kernel K3 for
  the basis pass) with the kept Ritz vectors riding in the deflation slot;
  the host assembles the TRLan arrowhead
  ``[[diag(theta), s], [s^H, tridiag(alpha, beta)]]`` in float64 at segment
  boundaries.

``precise_vectors`` (the JAX package's ``thick_lanczos_iteration_fused_pv``)
runs the fused engine over a float64 basis and the operator's
``matvec_f64`` (``lanczos_fused.precise_iteration``): the kept Ritz rows
are float64 rows of the deflation slot, where the JAX engine carries them
as word pairs with their low words (``defl_lo``).  Its df machinery is not
carried over: the recaptured couplings ``coup``/``coup_d``, the
nonsymmetric relation matrix M with its invariant-subspace selection
(``_select_invariant_pv``, ``_pv_converged``) and the word-pair rotation
(``_df_rotate``) exist because a float32 basis is orthonormal only to
2^-24; a float64 basis under two classical passes is orthonormal to
float64's rounding, so the symmetric arrowhead is exact to that level.

Over a row-partitioned operator (``op.group``) the basis rows are this
rank's slabs, every reduction (the CGS coefficients, the norms, the
couplings) is all-reduced over the group, and the projected matrices on
the host are the same on every rank; the capacities come from the global
n (``cfg.matrix_size``), the buffer widths from the start vector's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import linalg
from ..core.types import machine_eps, real_dtype
from .lanczos import LanczosConfig, _host_dtype, _prepare_init_vector, _rotate, _unit_rows, deflation_driver
from .lanczos_fused import _add_reorth, _Build, _run_stage, precise_iteration

__all__ = ["thick_lanczos_iteration", "thick_lanczos_iteration_fused", "lanczos_run_thick"]


def _project_step(op, basis, defl, defl_mask, nb: int, offset: float):
    """w = (A + offset) v_{nb-1}, projected against the deflation rows and
    the basis rows [0, nb); writes the normalized residual into row ``nb``
    (in place) and returns ``(c (nb,), beta)``.  ``c`` sums both passes'
    CGS coefficients: the new column of the projected matrix T."""
    rdtype = real_dtype(basis.dtype)
    group = getattr(op, "group", None)
    v = basis[nb - 1]
    w = op.matvec(v) + offset * v
    w = linalg.orthogonalize_cgs2(w, defl, defl_mask, group=group)
    w, c = linalg.orthogonalize_bcgs_dyn_coeffs(w, basis, nb, group=group)
    beta = linalg.norm(w, group).to(rdtype)
    basis[nb] = w / beta.clamp_min(torch.finfo(rdtype).tiny)
    return c, beta


def thick_lanczos_iteration(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """One deflated solve with internal thick restarts; returns
    ``(eigenvalues, eigenvectors, total_iterations, converged)``.
    ``precise_vectors`` is a fused-engine feature, as in the JAX package:
    it runs :func:`thick_lanczos_iteration_fused` over a float64 basis."""
    if cfg.precise_vectors:
        return precise_iteration(thick_lanczos_iteration_fused, op, v0, nroot, defl, defl_mask, cfg)
    dtype = v0.dtype
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    m_max = max(min(cfg.max_iteration, n), 2)
    l_keep = cfg.resolve_thick_keep(nroot + 2, m_max - 2)
    host_c = _host_dtype(dtype)
    group = getattr(op, "group", None)

    v0 = _prepare_init_vector(v0, defl, defl_mask, group)
    basis = torch.zeros((m_max + 1, v0.shape[0]), dtype=dtype, device=v0.device)
    basis[0] = v0
    t_host = np.zeros((m_max + 1, m_max + 1), dtype=host_c)

    # Invariant: rows [0, m_val] of ``basis`` are orthonormal; rows
    # [0, m_val) span the Rayleigh-Ritz space with completed projected matrix
    # t_host[:m_val, :m_val]; row m_val is the next candidate.
    m_val = 0
    total_iters = 0
    pevs = None
    converged = False
    breakdown_eps = machine_eps(rdtype) * 10.0  # beta is a storage-dtype norm
    offset = float(cfg.eigenvalue_offset)

    for _restart in range(max(cfg.max_restarts, 1)):
        while m_val < m_max:
            nb = m_val + 1  # process candidate row m_val, write the residual at row nb
            c, beta = _project_step(op, basis, defl, defl_mask, nb, offset)
            # One transfer per iteration: the new column and beta.
            host = torch.cat([c.to(torch.complex128 if c.is_complex() else torch.float64),
                              beta.reshape(1).to(torch.float64)]).cpu().numpy()
            c_host = np.asarray(host[:nb], host_c)
            beta_f = float(host[nb].real)
            total_iters += 1
            m_val = nb

            t_host[:m_val, m_val - 1] = c_host[:m_val]
            t_host[m_val - 1, :m_val] = np.conj(c_host[:m_val])

            tk = t_host[:m_val, :m_val]
            tk = (tk + tk.conj().T) / 2
            evs_all = np.linalg.eigvalsh(tk)
            m_want = min(nroot, m_val)
            evs = evs_all[::-1][:m_want] if cfg.find_maximum else evs_all[:m_want]

            if beta_f < breakdown_eps:
                converged = True
                break
            if pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
                if np.all(np.abs(evs - pevs) < np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps):
                    converged = True
                    break
            pevs = evs

        if converged or m_val >= n:
            converged = converged or m_val >= n
            break

        # Thick restart: keep the l best Ritz vectors and the residual row.
        tk = t_host[:m_val, :m_val]
        tk = (tk + tk.conj().T) / 2
        theta, q = np.linalg.eigh(tk)
        sel = list(range(m_val - 1, m_val - 1 - l_keep, -1)) if cfg.find_maximum else list(range(l_keep))
        q_keep = np.zeros((l_keep + 1, m_val + 1), dtype=host_c)
        q_keep[:l_keep, :m_val] = q[:, sel].T
        q_keep[l_keep, m_val] = 1.0  # the candidate residual row, already orthonormal
        # Overwrite the leading rows in place: the rows past l_keep are
        # stale and never read (every consumer reads rows < nb).
        basis[: l_keep + 1] = _rotate(q_keep, basis)

        t_host = np.zeros((m_max + 1, m_max + 1), dtype=host_c)
        t_host[np.arange(l_keep), np.arange(l_keep)] = theta[sel]
        m_val = l_keep
        # The kept Ritz values are identical across the restart by
        # construction: only in-cycle drift counts.
        pevs = None

    # Final Rayleigh-Ritz extraction from the current projected matrix.
    m_val = max(m_val, 1)
    tk = t_host[:m_val, :m_val]
    tk = (tk + tk.conj().T) / 2
    theta, q = np.linalg.eigh(tk)
    num_out = min(nroot, m_val)
    sel = [m_val - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    eigvecs = _unit_rows(_rotate(q[:, sel].T, basis), group)
    eigenvalues = [float(theta[s]) - cfg.eigenvalue_offset for s in sel]
    return eigenvalues, eigvecs, total_iters, converged


def lanczos_run_thick(op, cfg: LanczosConfig, init_vector, dtype):
    """Thick-restart engine under the shared deflation driver (the engine
    restarts internally, so no warm-restart wrapper)."""
    cfg = cfg.resolved(dtype)
    return deflation_driver(
        lambda v0, nroot, defl, mask: thick_lanczos_iteration(op, v0, nroot, defl, mask, cfg),
        cfg, init_vector, dtype, device=op.device, use_warm_restarts=False,
    )


def _coupling_row(op, y_rows, r, offset: float):
    """s_i = <Y_i, (A + offset) r>: the arrowhead couplings, one matvec."""
    ar = op.matvec(r) + offset * r
    return linalg.reduce_sum(linalg.typed_conj(y_rows) @ ar, getattr(op, "group", None))


def _read_build(st: _Build, precise: bool):
    """One transfer of what a segment boundary needs: the build's alpha and
    beta as host float64 (beta from the float64 ||w||^2 under precise
    reductions)."""
    m = st.done
    if precise:
        wide = st.wide[:, :m].cpu().numpy()
        return wide[0], np.sqrt(np.maximum(wide[1], 0.0))
    ab = torch.stack([st.alpha[:m], st.beta[:m]]).cpu().numpy().astype(np.float64)
    return ab[0], ab[1]


def thick_lanczos_iteration_fused(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """Thick restart with fused Krylov cycles; the return contract of
    :func:`thick_lanczos_iteration`.

    Each cycle builds ``m_max - l`` Lanczos vectors on the device with the
    kept Ritz vectors in the deflation slot.  The host waits for the device
    at the build's convergence checks (cycle 0), at segment boundaries
    (later cycles, whose arrowhead the in-build check cannot see), once for
    the couplings ``s_i = <Y_i, A r>`` and once for the restart rotation.
    ``cfg.precise_vectors`` runs it over a float64 basis
    (``lanczos_fused.precise_iteration``).
    """
    if cfg.precise_vectors:
        return precise_iteration(thick_lanczos_iteration_fused, op, v0, nroot, defl, defl_mask, cfg)
    dtype = v0.dtype
    n = cfg.matrix_size
    m_max = max(min(cfg.max_iteration, n), 4)
    l_keep = cfg.resolve_thick_keep(nroot + 2, m_max - 2)
    host_c = _host_dtype(dtype)
    nd = defl.shape[0]
    precise = bool(cfg.precise_reductions)
    passes = int(cfg.reorth_passes)
    selective = cfg.reorth_policy == "selective"
    offset = float(cfg.eigenvalue_offset)
    group = getattr(op, "group", None)

    # Deflation slot = accepted pairs + kept Ritz vectors (cycles >= 1); the
    # engine passes the live rows [0, nd + l_cur) of one buffer.
    defl_big = torch.zeros((nd + l_keep, v0.shape[0]), dtype=dtype, device=v0.device)
    defl_big[:nd] = defl
    mask_big = torch.ones(nd + l_keep, dtype=defl_mask.dtype, device=v0.device)
    mask_big[:nd] = defl_mask

    v0 = _prepare_init_vector(v0, defl, defl_mask, group)
    theta_kept = np.zeros(0, dtype=np.float64)
    y_rows = None  # the kept Ritz vectors, rows of defl_big from cycle 1 on
    s_host = np.zeros(0, dtype=host_c)

    total_iters = 0
    pevs = None
    converged = False
    st = None

    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_kept.shape[0]
        m_new = m_max - l_cur
        defl_v, mask_v = defl_big[: nd + l_cur], mask_big[: nd + l_cur]

        def resid_ok(theta_all, q_all, beta_last, m_done):
            """A posteriori bound |beta_last * q[last row]| of each wanted
            Ritz pair, gated at sqrt(eps) * scale so the drift test cannot
            fire on a plateau."""
            m_tot = l_cur + m_done
            n_want = min(int(nroot), m_tot)
            sel = list(range(m_tot - 1, m_tot - 1 - n_want, -1)) if cfg.find_maximum else list(range(n_want))
            res = np.abs(beta_last * q_all[m_tot - 1, sel])
            scale = max(np.max(np.abs(theta_all)), np.finfo(np.float64).tiny)
            return bool(np.all(res <= np.sqrt(cfg.eps) * scale))

        def assemble_t(alphas, betas, m_done):
            """Arrowhead projected matrix over [Y (l_cur), U (m_done)]."""
            m_tot = l_cur + m_done
            t = np.zeros((m_tot, m_tot), dtype=host_c)
            if l_cur:
                t[np.arange(l_cur), np.arange(l_cur)] = theta_kept
                t[:l_cur, l_cur] = s_host[:l_cur]
                t[l_cur, :l_cur] = np.conj(s_host[:l_cur])
            t[np.arange(l_cur, m_tot), np.arange(l_cur, m_tot)] = alphas
            j = np.arange(m_done - 1)
            t[l_cur + j, l_cur + j + 1] = betas[: m_done - 1]
            t[l_cur + j + 1, l_cur + j] = betas[: m_done - 1]
            return (t + t.conj().T) / 2

        if st is None:
            st = _Build(v0, m_max, int(nroot), precise)
        else:
            st.reset(v0)
        if cycle == 0:
            # No arrowhead yet: the build's own convergence check is exact.
            _run_stage(
                op, st, defl_v, mask_v, eps=float(cfg.eps), offset=offset, nroot=int(nroot),
                find_maximum=bool(cfg.find_maximum), check_every=max(int(cfg.convergence_check_interval), 1),
                passes=passes, selective=selective, k_lim=m_new,
            )
            a_full, b_full = _read_build(st, precise)
        else:
            # The build's check cannot see the arrowhead: run the cycle in
            # growing segments (eps = 0: only a breakdown stops the build) and
            # test the bordered matrix on the host at each boundary.
            seg = min(m_new, max(2 * (l_cur + int(nroot)), (m_new + 7) // 8, 2))
            pseg = None
            while True:
                _run_stage(
                    op, st, defl_v, mask_v, eps=0.0, offset=offset, nroot=int(nroot),
                    find_maximum=bool(cfg.find_maximum), check_every=1 << 30, passes=passes,
                    selective=selective, k_lim=seg,
                )
                a_full, b_full = _read_build(st, precise)
                m_done = st.done
                if st.stop or seg >= m_new:
                    break
                th_seg, q_seg = np.linalg.eigh(assemble_t(a_full, b_full, m_done))
                want = min(int(nroot), th_seg.shape[0])
                evs_seg = th_seg[::-1][:want] if cfg.find_maximum else th_seg[:want]
                if (
                    pseg is not None
                    and pseg.shape[0] == evs_seg.shape[0]
                    and evs_seg.shape[0] == nroot
                    and np.all(np.abs(evs_seg - pseg) < np.minimum(np.abs(evs_seg), np.abs(pseg)) * cfg.eps)
                    and resid_ok(th_seg, q_seg, b_full[m_done - 1], m_done)
                ):
                    break  # converged mid-cycle: skip the rest of the budget
                pseg = evs_seg
                seg = min(2 * seg, m_new)

        stopped = st.stop
        m_done = st.done
        _add_reorth(sum(st.triggers[:m_done]))
        total_iters += m_done
        alphas, betas = a_full, b_full
        m_tot = l_cur + m_done
        theta_all, q_all = np.linalg.eigh(assemble_t(alphas, betas, m_done))

        m_want = min(nroot, m_tot)
        evs = theta_all[::-1][:m_want] if cfg.find_maximum else theta_all[:m_want]

        # cycle 0 stops on convergence or breakdown; later cycles only on a
        # breakdown (eps = 0).
        if stopped:
            converged = True
        elif pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            diffs = np.abs(evs - pevs)
            tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
            if np.all(diffs < tol) and resid_ok(theta_all, q_all, betas[m_done - 1], m_done):
                converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1
        n_sel = min(nroot, m_tot) if last_cycle else l_keep
        sel = [m_tot - 1 - i for i in range(n_sel)] if cfg.find_maximum else list(range(n_sel))

        # Rotate [Y; U[:m_done]] into the selected Ritz vectors as two
        # products over the live rows (a concatenated basis would hold a
        # second (m_max, n) buffer).
        ritz = _rotate(q_all[l_cur:, sel].T, st.u)
        if l_cur:
            ritz = ritz + _rotate(q_all[:l_cur, sel].T, y_rows)

        if last_cycle:
            eigvecs = _unit_rows(ritz, group)
            eigenvalues = [float(theta_all[s]) - cfg.eigenvalue_offset for s in sel]
            return eigenvalues, eigvecs, total_iters, converged or m_tot >= n

        # Thick restart: Y' = the selected Ritz vectors, r' = the last residual row.
        theta_kept = theta_all[sel]
        y_rows = defl_big[nd : nd + l_keep]
        y_rows.copy_(ritz)
        r_new = st.u[m_done].clone()
        s_host = np.asarray(_coupling_row(op, y_rows, r_new, offset).cpu().numpy(), host_c)
        v0 = r_new
