"""The row-partitioned engines' set: every engine over row slabs at the
main path's width, one function for any world size.

:func:`engine_set` runs inside a process group, on every rank, over the
main path's operator (``multichip.main_path_coo``) and the n = 2**20 DIA
chain, each case held to the bars of the one-card phases:

* ``f32``: thick, block thick (b = 3) and a ``CheckpointedRun`` stopped
  after its first round and resumed (its saved and resumed counts and
  values equal to the uninterrupted run's bit for bit);
* ``pv``: precise thick (``precise_vectors``, K1x-rsmk float32 x float64);
* ``footprint``: the main path's operator under ``comm='footprint'`` (hops
  +-1), and a scattered pattern (the main path's chain plus couplings at
  n/2 and n/4, which the ring refuses) under gather, footprint and auto,
  with each comm's words, matvec and exchange times (on one rank every
  comm is the gather);
* ``bf16``: bfloat16 tiles, fused over float32 slabs (K2 bfloat16) and
  precise (K1x-rsmk bfloat16 x float64);
* ``dia``: over DIA slabs of the chain, ``filtered_lanczos`` at degree
  400, ``evolve``, ``run_chebyshev`` and the fused ``run`` against the
  hybrid;
* ``complex``: the main path's chain with a gauge phase on every hop in
  complex64 (K2 and K3 complex64) under gather and, above one rank, auto
  (the ring), a precise ``evolve`` (K1x-rsmk complex64 x complex128), a
  complex128 ``run`` (K2 complex128) and a complex128 run over DIA slabs
  (complex halos).

Every case is timed, its kernel launches are counted on every rank (a
kernel the case must launch at zero on any rank raises on the card), and
its results are compared as 64-bit words across the ranks (a rank with
other bits raises).  ``chip_smoke.py`` runs it on one NCCL rank (phases
``sharded_engines`` and ``bf16_sharded``), ``python3 -m
lanczos_tpu_torch.parallel.multichip --ranks 4 --engines`` on four, one a
card; :data:`SMALL` cuts it to a few hundred rows for the CPU tests' gloo
worlds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import resource
import time

import numpy as np

from .multichip import SEED, _cuda_ms, _gathered, _host_us, _profile, _same_bits, main_path_coo

__all__ = ["Sizes", "FULL", "SMALL", "GROUPS", "engine_set", "collectives", "references", "gauge_chain", "bf16_entries",
           "scattered_coo", "chain_states", "angle", "zero_launch_counts", "launch_counts"]

# The one-card phases' bars (chip_smoke.py): values against scipy eigsh
# (relative) and residuals; precise values (absolute); state angles.
MAIN_BAR, RES_BAR = 1e-5, 1e-3
HERM_PRECISE_BAR = 1e-12  # the precise complex evolve against its one-card state
C128_BAR = 1e-12  # a complex128 run against its one-card state
PV_MAIN_BAR = 1e-11
PV_THICK_BAR = 1e-10
BF16_MAIN_BAR = 1e-5
EVOLVE_ANGLE_BAR = 1e-5  # state angle after 100 float32 steps
CHEBY_ANGLE_BAR = 1e-6
EXPM_MODE_TOL = 1e-6  # fused against hybrid run, float32, relative 2-norm
FILTER_BAR = 2e-6  # the filtered values against -2 cos(k pi / (n + 1))
GROUPS = ("f32", "pv", "footprint", "bf16", "dia", "complex")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The set's sizes: the main path's n and tiles, the DIA chain's n, the
    filter's degree and band, and the evolution's steps."""

    n: int = 2**20
    bm: int = 128
    bk: int = 128
    dia_n: int = 2**20
    degree: int = 400
    mu: float = 1e-5
    steps: int = 100


FULL = Sizes()  # the one-card phases' widths
SMALL = Sizes(n=1024, bm=8, bk=8, dia_n=256, degree=64, mu=1e-2, steps=4)  # the CPU tests' worlds


def gauge_chain(n: int):
    """The main path's chain with a gauge phase on every hop: H' = U H U^H,
    U = diag(exp(i phi)), hop (j, j+1) times exp(i theta_j), theta_j uniform
    [0, 2 pi) from default_rng(1).  Returns the COO triplets (complex128)
    and phi of the STORED complex64 entries (their phases), with the
    float64 magnitudes of the stored hops (1 to ~1e-8): the stored operator
    is exactly U' R U'^H for the real chain R with those hops."""
    rows, cols, vals = main_path_coo(n)
    theta = np.random.default_rng(1).uniform(0.0, 2.0 * np.pi, n - 1)
    vals = vals.astype(np.complex128)
    vals[: n - 1] *= np.exp(1j * theta)  # (j, j+1)
    vals[n - 1 : 2 * (n - 1)] *= np.exp(-1j * theta)  # (j+1, j)
    stored = vals[: n - 1].astype(np.complex64).astype(np.complex128)
    theta_s = np.angle(-stored)
    phi = np.concatenate([[0.0], -np.cumsum(theta_s)])
    return rows, cols, vals, phi, np.abs(stored)


def bf16_entries(vals):
    """COO values as bfloat16 tiles hold them (packed in float32, rounded to
    nearest even), in float64: scipy's reference matrix of the bfloat16
    solves."""
    import torch

    return torch.from_numpy(np.asarray(vals, np.float32)).to(torch.bfloat16).double().numpy()


def scattered_coo(n: int, seed: int = SEED + 40):
    """The footprint's pattern at the main path's width: the main path's
    chain and potential plus seeded symmetric couplings at distances n/2
    (12 of them) and n/4 (8), weights 0.5 N(0, 1) (the shape of the CPU
    tests' ``long`` pattern and ``experiments/footprint_ab.py``).  Over four
    slabs the couplings are owner hops of +-1 and +-2, so the ring refuses
    it and ``comm='auto'`` takes the footprint."""
    rows, cols, vals = main_path_coo(n)
    rng = np.random.default_rng(seed)
    r, c, v = [rows], [cols], [vals]
    for d, cnt in ((n // 2, 12), (n // 4, 8)):
        pos = rng.choice(n - d, cnt, replace=False)
        w = 0.5 * rng.standard_normal(cnt)
        r += [pos, pos + d]
        c += [pos + d, pos]
        v += [w, w]
    return np.concatenate(r), np.concatenate(c), np.concatenate(v)


def angle(truth, out) -> float:
    """The state angle between two complex vectors (each normalized, the
    global phase taken out)."""
    t = truth / np.linalg.norm(truth)
    o = out / np.linalg.norm(out)
    ip = np.vdot(t, o)
    return float(np.linalg.norm(o - (ip / abs(ip)) * t))


def _to_np(*parts):
    """Real and imaginary tensors (or arrays) as one complex128 array."""
    host = [p.detach().cpu().double().numpy() if hasattr(p, "detach") else np.asarray(p, np.float64) for p in parts]
    return host[0] + 1j * host[1] if len(host) == 2 else host[0]


def chain_v0(n: int):
    """The chain's k = 3 analytic eigenvector in float32, the start state of
    the DIA chain's evolutions (``experiments/tpu_cheby_expm.py``)."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return (np.sqrt(2.0 / (n + 1)) * np.sin(3 * np.pi * j / (n + 1))).astype(np.float32)


def chain_states(ex, v_re, v_im, steps: int) -> dict:
    """The states the DIA cases are held to, from the one-device
    Exponentiator ``ex`` of the float32 chain: ``steps`` steps of exp(0.05i
    H) (``evolve``, its seconds ``evolve_s``) and the Chebyshev chain for
    exp(5i H)."""
    t0 = time.perf_counter()
    evolve = _to_np(*ex.evolve(0.05j, v_re, v_im, steps))  # the host copy waits for the device
    evolve_s = time.perf_counter() - t0
    return {"evolve": evolve, "evolve_s": evolve_s,
            "chebyshev_5i": _to_np(*ex.run_chebyshev(5j, v_re, v_im, lo=-2.0, hi=2.0)[0])}


# ------------------------------------------------------------ launch counts


def zero_launch_counts() -> None:
    """Zero the launch counts of K1 and K2 (by dtype), K1x (every form and
    tile dtype), K3 and K4 (by dtype) and K6."""
    from ..ops import cgs, spmv, sturm_check

    for fn in (spmv.bsr_matvec, spmv.bsr_matvec_f32x64, spmv.bsr_matvec_c64x128, spmv.bsr_matvec_bf16x64,
               spmv.bsr_matvec_rsmk, spmv.bsr_matvec_rsmk_f32x64, spmv.bsr_matvec_rsmk_c64x128,
               spmv.bsr_matvec_rsmk_bf16x64, cgs.cgs_pass, cgs.cgs_pass_block, sturm_check.sturm_check):
        fn.launches = 0
    for by_dtype in (spmv.bsr_matvec.launches_by_dtype, spmv.bsr_matvec_rsmk.launches_by_dtype,
                     cgs.cgs_pass.launches_by_dtype, cgs.cgs_pass_block.launches_by_dtype):
        by_dtype.clear()


def launch_counts() -> dict:
    """The counts :func:`zero_launch_counts` zeroes, by kernel (and dtype)."""
    from ..ops import cgs, spmv, sturm_check

    def named(counter):
        return {str(k).replace("torch.", ""): v for k, v in counter.items()}

    return {"k1_by_dtype": named(spmv.bsr_matvec.launches_by_dtype),
            "k1x_f32x64": spmv.bsr_matvec_f32x64.launches, "k1x_c64x128": spmv.bsr_matvec_c64x128.launches,
            "k1x_bf16x64": spmv.bsr_matvec_bf16x64.launches,
            "k2_by_dtype": named(spmv.bsr_matvec_rsmk.launches_by_dtype),
            "k1x_rsmk_f32x64": spmv.bsr_matvec_rsmk_f32x64.launches,
            "k1x_rsmk_c64x128": spmv.bsr_matvec_rsmk_c64x128.launches,
            "k1x_rsmk_bf16x64": spmv.bsr_matvec_rsmk_bf16x64.launches,
            "k3_by_dtype": named(cgs.cgs_pass.launches_by_dtype),
            "k4_by_dtype": named(cgs.cgs_pass_block.launches_by_dtype),
            "k6": sturm_check.sturm_check.launches}


def _count(counts, key: str) -> int:
    """``counts[key]``, or ``counts[a][b]`` for a key ``'a.b'`` (0 when
    absent)."""
    head, _, dtype = key.partition(".")
    value = counts.get(head, 0)
    return int(value.get(dtype, 0)) if dtype else int(value)


def _digest(*parts) -> list:
    """Two 48-bit words (exact in float64) of a hash of ``parts`` (tensors,
    arrays, numbers) as their bytes: a rank whose results differ anywhere
    in a bit shows other words."""
    h = hashlib.blake2b(digest_size=12)
    for p in parts:
        if hasattr(p, "detach"):
            p = p.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(p)).tobytes())
    d = h.digest()
    return [float(int.from_bytes(d[:6], "little")), float(int.from_bytes(d[6:], "little"))]


def _samples(state, k: int = 8) -> list:
    """``k`` entries of a state at evenly spaced rows, as (re, im) pairs:
    what the CPU tests compare with the one-process run."""
    s = _to_np(state) if not np.iscomplexobj(state) else np.asarray(state)
    idx = np.linspace(0, s.shape[-1] - 1, k).astype(np.int64)
    pick = s[..., idx].ravel()
    return [float(x) for x in np.column_stack([pick.real, np.imag(pick)]).ravel()]


def _peak_rss_gb() -> float:
    """This process's peak resident host memory so far (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# ------------------------------------------------------------ collectives


def collectives(mesh, m: int = 1000) -> dict:
    """Every collective kind the engines run over ``mesh``, in every
    vector dtype, against its values computed here: the all-gather
    (``mesh.all_gather``: the gather comm, ``gather_vector``), the row
    all-gather of ``linalg.gather_rows`` (results, the TSQR), the
    all-reduce (``linalg.reduce_sum``), the batched point-to-point
    exchange with both neighbours (``sharded._exchange``: the ring, the
    footprint, DIA halos) and the broadcast (the seed and the references).
    Returns ``{kind: {dtype: 'ok' or the error}}``; a wrong value is an
    error."""
    import types

    import torch
    import torch.distributed as dist

    from ..core.linalg import gather_rows, reduce_sum
    from .mesh import all_gather
    from .sharded import _exchange, _wait

    rank, size, dev = mesh.rank, mesh.size, mesh.device
    base = torch.arange(1, m + 1, dtype=torch.float64)

    def x_of(r, dtype):
        x = (r + 1) * base
        if dtype.is_complex:
            x = x - 1j * (r + 2) * base
        return x.to(dev, dtype)

    def all_gather_check(dtype):
        return torch.equal(all_gather(x_of(rank, dtype), mesh), torch.cat([x_of(r, dtype) for r in range(size)]))

    def gather_rows_check(dtype):
        rows = torch.stack([x_of(rank, dtype), 2 * x_of(rank, dtype)])
        got = gather_rows(rows, types.SimpleNamespace(group=mesh.group, n=size * m - 1))
        want = torch.stack([torch.cat([k * x_of(r, dtype) for r in range(size)]) for k in (1, 2)])[:, : size * m - 1]
        return torch.equal(got, want)

    def all_reduce_check(dtype):
        return torch.equal(reduce_sum(x_of(rank, dtype), mesh.group) if size > 1 else x_of(rank, dtype),
                           sum(x_of(r, dtype) for r in range(size)))

    def p2p_check(dtype):
        x = x_of(rank, dtype)
        left, right = torch.zeros_like(x), torch.zeros_like(x)
        _wait(_exchange(mesh, [(x, rank + 1, 0), (x, rank - 1, 1)], [(left, rank - 1, 0), (right, rank + 1, 1)]))
        zero = torch.zeros_like(x)
        return (torch.equal(left, x_of(rank - 1, dtype) if rank > 0 else zero)
                and torch.equal(right, x_of(rank + 1, dtype) if rank < size - 1 else zero))

    def broadcast_check(dtype):
        x = x_of(rank, dtype)
        dist.broadcast(x, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
        return torch.equal(x, x_of(0, dtype))

    kinds = {"all_gather": all_gather_check, "gather_rows": gather_rows_check, "all_reduce": all_reduce_check,
             "p2p_exchange": p2p_check, "broadcast": broadcast_check}
    out = {}
    for kind, check in kinds.items():
        out[kind] = {}
        for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
            name = str(dtype).replace("torch.", "")
            try:
                ok = check(dtype)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out[kind][name] = "ok" if ok else "wrong values"
            except Exception as e:  # recorded: the caller raises once every kind is known
                out[kind][name] = f"{type(e).__name__}: {e}"[:300]
    return out


# ------------------------------------------------------------ references


def references(mesh, sizes: Sizes = FULL, groups=GROUPS, given: dict | None = None) -> dict:
    """scipy eigsh's three lowest values (float64, ``tol=0``) that the
    ``groups`` are held to: the main path's matrix (``ref``: f32,
    footprint, complex), its float32 entries (``ref32``: pv), its bfloat16
    entries (``ref_bf16``) and the scattered pattern (``ref_scattered``:
    footprint); each computed by one rank (rank i takes every size-th) and
    broadcast; those in ``given`` are kept."""
    import scipy.sparse
    import scipy.sparse.linalg
    import torch
    import torch.distributed as dist

    n = sizes.n
    rows, cols, vals = main_path_coo(n)
    want = {"ref": (("f32", "footprint", "complex"), lambda: (rows, cols, vals)),
            "ref32": (("pv",), lambda: (rows, cols, vals.astype(np.float32).astype(np.float64))),
            "ref_bf16": (("bf16",), lambda: (rows, cols, bf16_entries(vals))),
            "ref_scattered": (("footprint",), lambda: scattered_coo(n))}
    out = dict(given or {})
    todo = [k for k, (users, _m) in want.items() if k not in out and set(users) & set(groups)]
    for i, key in enumerate(todo):
        buf = torch.zeros(3, dtype=torch.float64, device=mesh.device)
        if i % mesh.size == mesh.rank:
            r, c, v = want[key][1]()
            a = scipy.sparse.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
            buf[:] = torch.from_numpy(np.sort(scipy.sparse.linalg.eigsh(a, k=3, which="SA", tol=0)[0]))
        out[key] = buf
    for i, key in enumerate(todo):
        if mesh.size > 1:
            dist.broadcast(out[key], src=dist.get_global_rank(mesh.group, i % mesh.size), group=mesh.group)
        out[key] = out[key].cpu().numpy()
    return out


# --------------------------------------------------------------- the cases


class _Cases:
    """Runs, checks, records and emits the set's cases on every rank."""

    def __init__(self, mesh, emit, phase, counting):
        import torch

        self.torch, self.mesh, self.emit, self.phase = torch, mesh, emit, phase
        self.counting = counting or contextlib.nullcontext
        self.cuda = mesh.device.type == "cuda"
        self.records = {}

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.mesh.device)

    def barrier(self):
        if self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)

    def run(self, label, fn, check, *, need=(), profile=False):
        """Time ``fn()`` with the launch counts from 0, then ``check(result,
        counts)`` (raises on a missed bar; returns the record, whose
        ``values`` the CPU tests hold to the one-process run and whose
        ``bits`` are the results' words); ``need`` names the kernel
        instances that must have launched on every rank.  With ``profile``
        (on the card, above one rank) rank 0 runs ``fn`` once more under the
        profiler and the peers beside it."""
        zero_launch_counts()
        self.sync()
        self.barrier()
        with self.counting() as checks:
            t0 = time.perf_counter()
            res = fn()
            self.sync()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        if checks is not None:
            counts["checks"] = checks
        rec = {"case": label, "world": self.mesh.size, "wall_s": wall, **check(res, counts), "launches": counts}
        bits = rec.pop("bits")
        rows, same = _same_bits([*rec["values"], *bits], self.mesh)
        rec["same_bits"] = same
        if self.mesh.size > 1:
            rec["wall_s_by_rank"] = _gathered(self.torch, self.mesh, [wall])[:, 0].tolist()
        by_rank = _gathered(self.torch, self.mesh, [_count(counts, k) for k in need]) if need else np.zeros((1, 0))
        rec["need"] = {k: by_rank[:, i].astype(int).tolist() for i, k in enumerate(need)}
        if profile and self.cuda and self.mesh.size > 1:
            if self.mesh.rank == 0:
                rec["profile_rank0"] = _profile(self.torch, fn)
            else:
                fn()
                self.sync()
        self.records[label] = rec
        if self.emit is not None and self.mesh.rank == 0:
            self.emit({"phase": self.phase, **rec})
        if not same:
            raise AssertionError(f"{label}: the ranks hold other bits: {rows}")
        if self.cuda and by_rank.size and not np.all(by_rank > 0):
            raise AssertionError(f"{label}: a kernel that must launch did not on every rank: {rec['need']}")
        return res


def _eig_check(eng, evals, evecs, want, bar, n, *, res_bar=RES_BAR, relative=True):
    """Eigenvalues against ``want`` (relative or absolute), residuals, the
    vectors' shape; the record's common part."""
    got = np.sort(np.asarray(evals, np.float64))
    err = np.abs(got - want) / (np.abs(want) if relative else 1.0)
    residuals = eng.residuals(evals, evecs)
    if not (tuple(evecs.shape) == (len(want), n) and np.all(err <= bar) and max(residuals) <= res_bar
            and bool(np.all(np.isfinite(got)))):
        raise AssertionError(f"eigenvalues {got} against {want}: errors {err} (bar {bar}), residuals {residuals}, "
                             f"vectors {tuple(evecs.shape)}")
    return {"values": got.tolist(), "reference": np.asarray(want).tolist(), "max_err": float(err.max()), "bar": bar,
            "relative": relative, "residuals": residuals, "iteration_counts": eng.iteration_counts,
            "bits": _digest(np.asarray(evals), evecs, np.asarray(eng.iteration_counts))}


def engine_set(mesh, *, sizes: Sizes = FULL, groups=GROUPS, refs: dict | None = None, op=None, bf16_op=None,
               emit=print, phase: str = "multichip_engines", counting=None, workdir=None) -> dict:
    """Run the set's ``groups`` over ``mesh`` (every rank calls it) and
    return the records by case; rank 0 passes each to ``emit`` (a dict;
    None prints nothing).

    ``refs`` may hold what a caller already has: scipy's ``ref``,
    ``ref32``, ``ref_bf16`` (:func:`references` computes the rest), the
    one-card runs' ``thick``, ``herm`` and ``bf16_iteration_counts`` (then
    recorded beside the set's), and ``chain`` (``v0`` and the states of
    :func:`chain_states`; else every rank computes them on its device).
    ``op`` and ``bf16_op`` are the main path's float32 and bfloat16
    operators over ``mesh`` when the caller built them.  ``counting`` is a
    context manager factory run around every case (its value recorded as
    ``checks``).  ``workdir`` is a directory every rank sees (the
    checkpoint's file; a temporary one on one rank).  Raises
    ``AssertionError`` on a missed bar, a kernel that did not launch on some
    rank (on the card) or ranks that disagree in a bit."""
    import torch

    import lanczos_tpu_torch as tl

    from ..solvers import lanczos as tlz
    from ..utils import checkpoint
    from .multichip import main_path_engine
    from .sharded import ShardedBSROperator, ShardedDIAOperator

    unknown = set(groups) - set(GROUPS)
    if unknown:
        raise ValueError(f"unknown groups {sorted(unknown)}; the set's are {GROUPS}")
    dev, size = mesh.device, mesh.size
    cuda = dev.type == "cuda"
    if "f32" in groups and workdir is None and size > 1:
        raise ValueError("the checkpoint case needs a workdir that every rank sees")
    cases = _Cases(mesh, emit, phase, counting)
    n, bm, bk = sizes.n, sizes.bm, sizes.bk
    refs = references(mesh, sizes, groups, given=refs)
    rows, cols, vals = main_path_coo(n)
    mode = "auto" if cuda else "fused"  # auto takes the fused engine on the card

    def engine(target, dtype=None, **attrs):
        """The main path's configuration (a complex operator's start in its
        dtype) with ``attrs`` on top."""
        eng = main_path_engine(target, dtype, mode=mode)
        if target.dtype.is_complex:
            eng.init_vector = tl.fixed_seed_initializer(target.dtype, seed=SEED)
        for k, v in attrs.items():
            setattr(eng, k, v)
        return eng

    def no_k1(counts):
        return not counts["k1_by_dtype"] and not counts["k1x_f32x64"] and not counts["k1x_c64x128"]

    if op is None and ("f32" in groups or "pv" in groups):
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=torch.float32)

    # ---- f32: thick, block thick, the checkpoint
    if "f32" in groups:
        eng = engine(op, restart_policy="thick", max_iteration=128)

        def thick_check(res, counts):
            rec = _eig_check(eng, *res, refs["ref"], MAIN_BAR, n)
            if not no_k1(counts):
                raise AssertionError(f"thick: K1 launched; launches {counts}")
            one = refs.get("thick")
            if one is not None:
                rec.update(unsharded_iteration_counts=one["iteration_counts"], unsharded_wall_s=one["wall_s"],
                           max_abs_diff_unsharded=float(np.max(np.abs(np.sort(np.asarray(res[0]))
                                                                      - np.sort(one["eigenvalues"])))))
            return rec

        cases.run("thick", eng.run, thick_check, need=("k2_by_dtype.float32", "k3_by_dtype.float32"))

        eng_b = engine(op, restart_policy="thick", block_size=3, max_iteration=128, max_restarts=32)
        b_rng = np.random.default_rng(SEED)  # distinct start rows, the same on every rank
        eng_b.init_vector = lambda n_: b_rng.uniform(-1.0, 1.0, n_).astype(np.float32)
        cases.run("block_thick", eng_b.run, lambda res, counts: _eig_check(eng_b, *res, refs["ref"], MAIN_BAR, n),
                  need=("k4_by_dtype.float32", "k2_by_dtype.float32"))
        _checkpoint_case(cases, engine, op, refs["ref"], n, workdir, tlz, checkpoint)

    # ---- pv: precise thick
    if "pv" in groups:
        eng_p = engine(op, precise_vectors=True, restart_policy="thick", max_iteration=128, eps=1e-11,
                       max_restarts=64)

        def pv_check(res, counts):
            rec = _eig_check(eng_p, *res, refs["ref32"], PV_THICK_BAR, n, res_bar=np.inf, relative=False)
            if cuda and not (counts["k1x_rsmk_f32x64"] > 0 and counts["k2_by_dtype"] == {}):
                raise AssertionError(f"pv thick: K1x-rsmk float32 x float64 alone expected; launches {counts}")
            return rec

        cases.run("pv_thick", eng_p.run, pv_check, need=("k1x_rsmk_f32x64", "k3_by_dtype.float64"))

    # ---- footprint: the main path's operator and a scattered pattern
    if "footprint" in groups:
        _footprint_cases(cases, engine, mesh, sizes, refs, rows, cols, vals, no_k1)
    op = None
    if cuda:
        torch.cuda.empty_cache()

    # ---- bf16: bfloat16 tiles, fused and precise
    if "bf16" in groups:
        if bf16_op is None:
            bf16_op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=torch.bfloat16)
        ref_bf = refs["ref_bf16"]
        eng_bf = engine(bf16_op, dtype=torch.float32)

        def bf16_check(res, counts):
            rec = _eig_check(eng_bf, *res, ref_bf, BF16_MAIN_BAR, n)
            if cuda and not (set(counts["k2_by_dtype"]) == {"bfloat16"} and no_k1(counts)):
                raise AssertionError(f"bf16: K2 bfloat16 alone expected; launches {counts}")
            one = refs.get("bf16_iteration_counts")
            if one is not None and eng_bf.iteration_counts != one:
                raise AssertionError(f"bf16: iterations {eng_bf.iteration_counts} against {one} unsharded "
                                     "(K2 gives K1's bits on one rank)")
            rec["unsharded_iteration_counts"] = one
            rec["tiles"] = list(bf16_op.blocks.shape)
            return rec

        cases.run("bf16_fused", eng_bf.run, bf16_check, need=("k2_by_dtype.bfloat16", "k3_by_dtype.float32"),
                  profile=True)
        eng_bp = engine(bf16_op, dtype=torch.float32, precise_vectors=True, eps=1e-12)

        def bf16_pv_check(res, counts):
            rec = _eig_check(eng_bp, *res, ref_bf, PV_MAIN_BAR, n, res_bar=np.inf, relative=False)
            if cuda and not (counts["k1x_rsmk_bf16x64"] > 0 and counts["k2_by_dtype"] == {}
                             and counts["k1x_bf16x64"] == 0):
                raise AssertionError(f"bf16 precise: K1x-rsmk bfloat16 x float64 alone expected; launches {counts}")
            return rec

        cases.run("bf16_precise", eng_bp.run, bf16_pv_check, need=("k1x_rsmk_bf16x64", "k3_by_dtype.float64"))
        del eng_bf, eng_bp
        bf16_op = None

    # ---- dia: the filter and the Exponentiator over DIA slabs of the chain
    if "dia" in groups:
        _dia_cases(cases, mesh, sizes, refs, tl, ShardedDIAOperator)

    # ---- complex: the gauge chain in complex64 and complex128
    if "complex" in groups:
        _complex_cases(cases, engine, mesh, sizes, refs, tl, ShardedBSROperator, ShardedDIAOperator)
    return cases.records


def _checkpoint_case(cases, engine, op, ref, n, workdir, tlz, checkpoint):
    """A CheckpointedRun stopped right after its first round's save (every
    rank stops at that round) and resumed from the file, against the
    uninterrupted run of this world bit for bit."""
    import tempfile

    import torch.distributed as dist

    mesh = op.mesh

    def ck_engine():
        return engine(op, num_eigs_per_iteration=1)

    class Interrupt(Exception):
        pass

    driver = tlz.deflation_driver

    def one_round(*args, after_round, **kwargs):
        def save_then_stop(manager, counts, finished):
            after_round(manager, counts, finished)
            raise Interrupt
        return driver(*args, after_round=save_then_stop, **kwargs)

    whole = ck_engine()
    vals_whole, _ = whole.run()
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        path = os.path.join(workdir, "engine_set_checkpoint.npz")
        if mesh.rank == 0 and os.path.exists(path):
            os.unlink(path)
        if mesh.size > 1:
            dist.barrier(group=mesh.group)
        tlz.deflation_driver = one_round
        try:
            checkpoint.CheckpointedRun(ck_engine(), path).run()
            raise AssertionError("the interrupted run was not interrupted")
        except Interrupt:
            pass
        finally:
            tlz.deflation_driver = driver
        saved, saved_counts = checkpoint.load_state(path, sharded=op)
        resumed = ck_engine()

        def ck_check(res, counts):
            if not (len(saved) == 1 and saved_counts == whole.iteration_counts[:1]
                    and resumed.iteration_counts == whole.iteration_counts
                    and np.array_equal(np.asarray(res[0]), np.asarray(vals_whole))):
                raise AssertionError(f"checkpoint: saved {len(saved)} / {saved_counts}, resumed "
                                     f"{resumed.iteration_counts} {res[0]} against "
                                     f"{whole.iteration_counts} {vals_whole}")
            return {**_eig_check(resumed, *res, ref, MAIN_BAR, n), "whole_iteration_counts": whole.iteration_counts,
                    "saved_counts": saved_counts}

        cases.run("checkpoint_resumed", lambda: checkpoint.CheckpointedRun(resumed, path).run(), ck_check,
                  need=("k2_by_dtype.float32",))
        if mesh.size > 1:
            dist.barrier(group=mesh.group)
        if mesh.rank == 0:
            os.unlink(path)


def _exchange_only(op, x):
    """The halo schedule of ``op.matvec(x)`` without its local products: the
    all-gather (gather), or the ring's or the footprint's exchange with its
    wait."""
    from .mesh import all_gather
    from .sharded import _wait

    if op.comm in ("ring", "footprint"):
        return lambda: _wait(op.start_halo(x)[0])
    return lambda: all_gather(x, op.mesh)


def comm_timing(op) -> dict:
    """Words each rank receives per matvec under ``op.comm`` beside the
    gather's, and on the card the matvec's and the exchange's ms by CUDA
    events and the exchange's host µs (every rank calls it alike)."""
    import torch

    words = {"gather": op.n_padded - op.n_local, "ring": 2 * op.n_local, "footprint": op.footprint_words}[op.comm]
    out = {"comm": op.comm, "words_received_per_matvec": words, "gather_words_received": op.n_padded - op.n_local,
           "hops": [int(h) for h, _g, _s in op.footprint[1]] if op.footprint is not None else None}
    if op.device.type != "cuda":
        return out
    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn(op.n, generator=gen, dtype=op.dtype if op.dtype.is_complex else torch.float32)
    x = op.scatter(x.to(op.device))  # the vectors' dtype: complex tiles' own, float32 for float32 and bfloat16
    exchange = _exchange_only(op, x)
    out.update(matvec_ms=_cuda_ms(torch, lambda: op.matvec(x)), exchange_ms=_cuda_ms(torch, exchange, 200),
               exchange_host_us=_host_us(torch, exchange))
    return out


def _footprint_cases(cases, engine, mesh, sizes, refs, rows, cols, vals, no_k1):
    """The main path's operator under comm='footprint' (hops +-1), then the
    scattered pattern under gather, footprint and auto (auto must take the
    footprint above one rank), each solve at the main path's bars."""
    import torch

    from .sharded import ShardedBSROperator

    n, bm, bk, cuda = sizes.n, sizes.bm, sizes.bk, cases.cuda
    split = mesh.size > 1

    def solve(label, op, want, *, expect_comm, expect_hops=None, profile=False):
        eng = engine(op)

        def check(res, counts):
            if op.comm != expect_comm:
                raise AssertionError(f"{label}: comm resolved to {op.comm}, not {expect_comm}")
            timing = comm_timing(op)
            if expect_hops is not None and timing["hops"] != expect_hops:
                raise AssertionError(f"{label}: footprint hops {timing['hops']}, not {expect_hops}")
            if cuda and not no_k1(counts):
                raise AssertionError(f"{label}: K1 launched; launches {counts}")
            return {**_eig_check(eng, *res, want, MAIN_BAR, n), "tiles": list(op.blocks.shape), **timing}

        cases.run(label, eng.run, check, need=("k2_by_dtype.float32", "k3_by_dtype.float32"), profile=profile)

    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=bm, bk=bk, dtype=torch.float32, comm="footprint")
    solve("footprint_main_path", op, refs["ref"], expect_comm="footprint" if split else "gather",
          expect_hops=[-1, 1] if split else None)
    del op
    sr, sc, sv = scattered_coo(n)
    for comm in ("gather", "footprint", "auto"):
        op = ShardedBSROperator.from_coo(sr, sc, sv, n, mesh, bm=bm, bk=bk, dtype=torch.float32, comm=comm)
        solve(f"scattered_{comm}", op, refs["ref_scattered"],
              expect_comm="footprint" if split and comm != "gather" else "gather", profile=comm == "footprint")
        del op


def _dia_cases(cases, mesh, sizes, refs, tl, ShardedDIAOperator):
    """Over DIA slabs of the float32 chain: filtered_lanczos (values within
    FILTER_BAR of the analytic ones), evolve and run_chebyshev against the
    one-device states, the fused run against the hybrid."""
    import torch

    n, dev = sizes.dia_n, mesh.device
    dia = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n, mesh)
    exact = -2.0 * np.cos(np.arange(1, 4) * np.pi / (n + 1))
    f_rng = np.random.default_rng(SEED)

    def cfg(eng_f):
        eng_f.max_restarts, eng_f.max_iteration = 2, 48
        eng_f.init_vector = lambda n_: f_rng.uniform(-1.0, 1.0, n_).astype(np.float32)

    def filtered_check(res, counts):
        vals, vecs, info = res
        got = np.sort(np.asarray(vals, np.float64))
        errs = np.abs(got - exact)
        if not (tuple(vecs.shape) == (3, n) and np.all(errs <= FILTER_BAR)):
            raise AssertionError(f"filtered: {got} against {exact}: errors {errs}")
        return {"degree": info["filter_degree"], "mu": info["mu"], "values": got.tolist(), "reference": exact.tolist(),
                "max_err": float(errs.max()), "bar": FILTER_BAR, "relative": False, "residuals": info["residuals"],
                "iteration_counts": info["iteration_counts"], "matvecs": info["matvecs"],
                "bits": _digest(np.asarray(vals), vecs)}

    cases.run(f"filtered_degree{sizes.degree}",
              lambda: tl.filtered_lanczos(dia, num_eigs=3, degree=sizes.degree, mu=sizes.mu, lo=-2.0, hi=2.0,
                                          configure=cfg), filtered_check, need=("k3_by_dtype.float32",))
    chain = refs.get("chain")
    v0 = chain["v0"] if chain is not None else chain_v0(n)
    v_re = torch.from_numpy(v0).to(dev)
    v_im = torch.zeros_like(v_re)
    if chain is None:  # this rank's one-device states
        one = tl.Exponentiator(tl.DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n,
                                                             device=dev))
        states = chain_states(one, v_re, v_im, sizes.steps)
        del one
    else:
        states = chain["states"]
    ex = tl.Exponentiator(dia)

    def state_check(key, bar):
        def check(res, counts):
            out = _to_np(*(res[0] if key == "chebyshev_5i" else res))
            a = angle(states[key], out)
            if not a <= bar:
                raise AssertionError(f"{key}: angle {a} to the one-device state above {bar}")
            rec = {"angle_to_one_device": a, "bar": bar, "values": _samples(out), "bits": _digest(out)}
            if key == "evolve":
                rec["one_device_wall_s"] = states["evolve_s"]
            return rec
        return check

    cases.run(f"evolve_{sizes.steps}x0.05i", lambda: ex.evolve(0.05j, v_re, v_im, sizes.steps),
              state_check("evolve", EVOLVE_ANGLE_BAR), need=("k3_by_dtype.float32",))
    cases.run("chebyshev_5i", lambda: ex.run_chebyshev(5j, v_re, v_im, lo=-2.0, hi=2.0),
              state_check("chebyshev_5i", CHEBY_ANGLE_BAR))
    w = torch.as_tensor(np.random.default_rng(SEED + 22).standard_normal(n), dtype=torch.float32, device=dev)
    hybrid, it_h = ex.run(-0.5, w)
    ex.mode = "fused"

    def fused_check(res, counts):
        rel = float(torch.linalg.vector_norm((res[0] - hybrid).double()) / torch.linalg.vector_norm(hybrid.double()))
        if not (rel <= EXPM_MODE_TOL and res[1] == it_h):
            raise AssertionError(f"fused run: {rel} against the hybrid, iterations {res[1]} vs {it_h}")
        out = res[0].double().cpu().numpy()
        return {"iterations": res[1], "hybrid_iterations": it_h, "rel_err_to_hybrid": rel, "bar": EXPM_MODE_TOL,
                "values": _samples(out), "bits": _digest(res[0], np.asarray(res[1]))}

    cases.run("expm_fused_vs_hybrid", lambda: ex.run(-0.5, w), fused_check)  # no kernel: DIA slabs, no K3 by default


def _complex_cases(cases, engine, mesh, sizes, refs, tl, ShardedBSROperator, ShardedDIAOperator):
    """The gauge chain: the complex64 main path under gather (and auto above
    one rank: the ring), a precise evolve and a complex128 run against
    one-device runs on the same entries, and a complex128 run over DIA
    slabs (complex halos)."""
    import torch

    n, bm, bk, dev, cuda = sizes.n, sizes.bm, sizes.bk, mesh.device, cases.cuda
    rows, cols, cvals, _phi, _mags = gauge_chain(n)
    ref = refs["ref"]
    herm = refs.get("herm")
    psi = np.random.default_rng(7).standard_normal(n) + 1j * np.random.default_rng(8).standard_normal(n)
    psi /= np.linalg.norm(psi)
    comms = ("gather", "auto") if mesh.size > 1 else ("gather",)
    cop = None
    for comm in comms:
        t0 = time.perf_counter()
        cop = ShardedBSROperator.from_coo(rows, cols, cvals, n, mesh, bm=bm, bk=bk, dtype=torch.complex64, comm=comm)
        cases.sync()
        pack = {"pack_s": time.perf_counter() - t0, "peak_host_rss_gb": _peak_rss_gb()}
        eng_c = engine(cop)

        def complex_check(res, counts, eng_c=eng_c, cop=cop, pack=pack):
            rec = _eig_check(eng_c, *res, ref, MAIN_BAR, n)
            if cuda and not (set(counts["k2_by_dtype"]) == {"complex64"} and set(counts["k3_by_dtype"]) == {"complex64"}
                             and not counts["k1_by_dtype"]):
                raise AssertionError(f"complex main path: K2 and K3 complex64 alone expected; launches {counts}")
            if herm is not None:
                rec["unsharded_iteration_counts"] = herm["iteration_counts"]
            peaks = _gathered(torch, mesh, [pack["peak_host_rss_gb"]])[:, 0].tolist()
            return {**rec, "comm": cop.comm, "tiles": list(cop.blocks.shape), "pack_s": pack["pack_s"],
                    "peak_host_rss_gb_by_rank": peaks, **comm_timing(cop)}

        label = "complex_main_path" if comm == "gather" else "complex_main_path_auto"
        cases.run(label, eng_c.run, complex_check, need=("k2_by_dtype.complex64", "k3_by_dtype.complex64"),
                  profile=comm == "gather")
        if comm != comms[-1]:
            del cop, eng_c
            if cuda:
                torch.cuda.empty_cache()

    one = tl.BSROperator.from_coo(rows, cols, cvals, n, bm=bm, bk=bk, dtype=torch.complex64, device=dev)
    want_p = _to_np(*tl.Exponentiator(one).evolve(0.05j, psi.real, psi.imag, 4, krylov_dim=16, precise=True))

    def precise_check(res, counts):
        out = _to_np(*res)
        a = angle(want_p, out)
        if not a <= HERM_PRECISE_BAR:
            raise AssertionError(f"precise complex evolve: angle {a} to the one-device state")
        return {"steps": 4, "angle_to_one_device": a, "bar": HERM_PRECISE_BAR, "values": _samples(out),
                "bits": _digest(out)}

    ex_c = tl.Exponentiator(cop)
    cases.run("complex_evolve_precise", lambda: ex_c.evolve(0.05j, psi.real, psi.imag, 4, krylov_dim=16, precise=True),
              precise_check, need=("k1x_rsmk_c64x128",))
    c128 = ShardedBSROperator(cop.blocks.to(torch.complex128), cop.col_blocks, cop.n, mesh)
    del cop, ex_c
    one128 = tl.BSROperator(one.blocks.to(torch.complex128), one.col_blocks, n)  # the complex64 values, exact
    del one
    if cuda:
        torch.cuda.empty_cache()
    want_r, it_r = tl.Exponentiator(one128).run(-0.5j, psi)
    want_r = want_r.cpu().numpy()
    del one128

    def c128_check(res, counts):
        out = res[0].cpu().numpy()
        a = angle(want_r, out)
        if not (a <= C128_BAR and res[1] == it_r):
            raise AssertionError(f"complex128 run: angle {a}, iterations {res[1]} against {it_r}")
        return {"iterations": res[1], "one_device_iterations": it_r, "angle_to_one_device": a, "bar": C128_BAR,
                "values": _samples(out), "bits": _digest(out, np.asarray(res[1]))}

    cases.run("complex128_run", lambda: tl.Exponentiator(c128).run(-0.5j, psi), c128_check,
              need=("k2_by_dtype.complex128",))
    del c128
    if cuda:
        torch.cuda.empty_cache()

    # complex halos: the gauge chain's hops and potential as DIA slabs
    m = sizes.dia_n
    r, c, v, _phi, _mags = gauge_chain(m)
    upper = np.zeros(m, complex)
    lower = np.zeros(m, complex)
    upper[: m - 1] = v[: m - 1]  # A[i, i+1]
    lower[1:] = v[m - 1 : 2 * (m - 1)]  # A[i+1, i]
    diags = [lower, v[2 * (m - 1):].astype(complex), upper]
    dia = ShardedDIAOperator.from_diagonals([-1, 0, 1], diags, m, mesh, dtype=torch.complex128)
    phi_m = np.random.default_rng(9).standard_normal(m) + 1j * np.random.default_rng(10).standard_normal(m)
    phi_m /= np.linalg.norm(phi_m)
    want_d, it_d = tl.Exponentiator(tl.DIAOperator.from_diagonals([-1, 0, 1], diags, m, dtype=torch.complex128,
                                                                  device=dev)).run(-0.5j, phi_m)
    want_d = want_d.cpu().numpy()

    def dia_check(res, counts):
        out = res[0].cpu().numpy()
        a = angle(want_d, out)
        if not (a <= C128_BAR and res[1] == it_d):
            raise AssertionError(f"complex128 DIA run: angle {a}, iterations {res[1]} against {it_d}")
        return {"iterations": res[1], "one_device_iterations": it_d, "angle_to_one_device": a, "bar": C128_BAR,
                "values": _samples(out), "bits": _digest(out, np.asarray(res[1]))}

    cases.run("complex128_dia_run", lambda: tl.Exponentiator(dia).run(-0.5j, phi_m), dia_check)

