"""Matrix-free MINRES, the inner solver behind shift-invert ``eigsh`` (port
of ``lanczos_tpu.solvers.minres``).

Solves ``(A - shift I) x = b`` for a symmetric or Hermitian ``A``; the
system may be indefinite (interior shifts), where CG would break (Paige and
Saunders 1975).  Each iteration is one matvec and a handful of AXPYs on two
Lanczos vectors and two direction vectors, with the Givens-rotation scalars
as 0-d tensors on the operator's device: O(n) memory whatever the count.

The JAX loop is one ``lax.while_loop`` with no host read.  An eager loop
that read its stop flag every iteration would wait for the device once per
iteration of every inner solve, and shift-invert runs one inner solve per
outer matvec.  Here the flag ``done`` stays on the device and the host
reads it every ``check_every`` iterations; once it is set, every
iteration keeps the old state (``torch.where(done, old, new)``), so the
returned ``x``, ``relres`` and ``iters`` are those of the iteration the
JAX loop stops at, not of a later one.  The inner products are
``torch.vdot`` on the CUDA cores (the JAX package's elementwise
``_dot_exact`` works around the TPU's bf16 dot passes; no TF32 path is
taken here).
"""

from __future__ import annotations

import torch

from ..core import linalg
from ..core.types import machine_eps, real_dtype

__all__ = ["minres", "CHECK_EVERY"]

CHECK_EVERY = 16  # iterations between host reads of the stop flag


def minres(op, b, *, shift=0.0, tol=1e-8, maxiter: int = 200, x0=None, check_every: int = CHECK_EVERY):
    """Solve ``(A - shift I) x = b`` for symmetric/Hermitian ``A`` (MINRES).

    Returns ``(x, relres, iters)``: the solution, the final relative
    residual estimate ``||r|| / ||b||`` (a 0-d real tensor on the device)
    and the iteration count (an int), those of the JAX loop: it stops at
    the first iteration whose estimate is at most ``tol`` or whose new
    beta breaks down, or after ``maxiter``.  ``shift`` enters rounded to
    the real dtype of ``b``, as in the JAX package.
    """
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    dev = b.device
    maxiter = int(maxiter)
    check_every = max(int(check_every), 1)
    finfo = torch.finfo(rdtype)
    tiny = torch.tensor(finfo.tiny, dtype=rdtype, device=dev)
    eps_m = machine_eps(rdtype)
    shift_t = torch.tensor(float(shift), dtype=rdtype, device=dev)
    tol_t = torch.tensor(float(tol), dtype=rdtype, device=dev)

    def amv(v):
        return op.matvec(v) - shift_t * v

    def real_dot(v, w):
        return linalg.inner_prod(v, w).real.to(rdtype)

    def norm(v):
        return torch.sqrt(real_dot(v, v))

    x = torch.zeros_like(b) if x0 is None else x0.to(dtype).clone()
    r0 = b - amv(x)
    beta1 = norm(r0)
    bnorm = torch.maximum(norm(b), tiny)
    zero = torch.zeros((), dtype=rdtype, device=dev)
    # The state of the JAX loop's _MinresState, in its order.
    st = {
        "x": x, "v_cur": r0 / torch.maximum(beta1, tiny), "v_prev": torch.zeros_like(b),
        "d_prev": torch.zeros_like(b), "d_prev2": torch.zeros_like(b), "beta": beta1, "dbar": zero,
        "epsln": zero, "phibar": beta1, "cs": -torch.ones((), dtype=rdtype, device=dev), "sn": zero,
        "k": torch.zeros((), dtype=torch.int64, device=dev),
    }
    done = beta1 <= tol_t * bnorm

    def body(st):
        # Lanczos step: beta_{k+1} v_{k+1} = A v_k - alpha v_k - beta_k v_{k-1}
        w = amv(st["v_cur"])
        alpha = real_dot(st["v_cur"], w)
        w = w - alpha * st["v_cur"] - st["beta"] * st["v_prev"]
        beta_next = norm(w)
        v_next = w / torch.maximum(beta_next, tiny)
        # the previous rotation on the new tridiagonal column
        oldeps = st["epsln"]
        delta = st["cs"] * st["dbar"] + st["sn"] * alpha
        gbar = st["sn"] * st["dbar"] - st["cs"] * alpha
        epsln = st["sn"] * beta_next
        dbar = -st["cs"] * beta_next
        # the current rotation, annihilating beta_{k+1}
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_next * beta_next), min=eps_m)
        cs = gbar / gamma
        sn = beta_next / gamma
        phi = cs * st["phibar"]
        phibar = sn * st["phibar"]
        # direction and solution
        d = (st["v_cur"] - oldeps * st["d_prev2"] - delta * st["d_prev"]) / gamma
        new = {
            "x": st["x"] + phi * d, "v_cur": v_next, "v_prev": st["v_cur"], "d_prev": d, "d_prev2": st["d_prev"],
            "beta": beta_next, "dbar": dbar, "epsln": epsln, "phibar": phibar, "cs": cs, "sn": sn,
            "k": st["k"] + 1,
        }
        # A beta breakdown: b (or the residual) lay in an invariant
        # subspace, and the solve is exact within it.
        stop = (torch.abs(phibar) <= tol_t * bnorm) | (beta_next < eps_m * 10.0)
        return new, stop

    for it in range(maxiter):
        if it % check_every == 0 and bool(done):  # the one host read per check_every iterations
            break
        new, stop = body(st)
        st = {key: torch.where(done, st[key], val) for key, val in new.items()}
        done = done | stop
    return st["x"], torch.abs(st["phibar"]) / bnorm, int(st["k"])
