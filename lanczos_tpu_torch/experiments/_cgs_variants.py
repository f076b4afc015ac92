"""What the three CGS-pass studies (E2a-c) share: the argument checks, the
launch of ``csrc/cgs_variants.cu`` (E2b, E2c), the launch plan and launch
of ``csrc/bcgs_ring.cu`` (E2a), the studies' inputs, and their error
measure."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build

__all__ = [
    "MgsPlan",
    "mgs_plan",
    "mgs_smem_bytes",
    "mgs_launch",
    "validate",
    "grid",
    "launch",
    "make_data",
    "rel_err",
]

# E2a's launch shape (csrc/bcgs_ring.cu): 256 consumer threads and one
# producer warp per CTA, two CTAs resident per SM.
MGS_CTAS_PER_SM = 2
MGS_PIECE_BYTES = 16 * 1024  # one ring stage: 1024 16-byte vectors, four per consumer thread
MGS_MIN_STAGES, MGS_MAX_STAGES = 2, 4  # the kernel takes up to 8
MGS_ROW_GROUP = 8  # projection rows per reduction round
MGS_COEF_ROWS = 512  # coefficients staged in shared memory at a time
SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM
CTA_SMEM_RESERVED = 1024  # what the SM keeps for each resident CTA
ROUTES = ("smem", "l2")

_DTYPE_ITEM = "ROADMAP.md, 'TPU kernels to port': K3 for complex and bfloat16 bases"


class MgsPlan(NamedTuple):
    """How E2a cuts one pass: ``grid`` CTAs of ``cols`` columns each, a
    ring of ``stages`` segments of ``piece`` columns, and ``route``, where
    v's range lives ("smem": shared memory for the whole pass; "l2":
    global memory, read and written at L2)."""

    cols: int
    grid: int
    piece: int
    stages: int
    route: str


def mgs_smem_bytes(cols: int, piece: int, stages: int, itemsize: int, resident: bool) -> int:
    """Dynamic shared memory of one E2a CTA, as ``csrc/bcgs_ring.cu``
    ``smem_bytes`` lays it out: the ring, v's range when resident, two
    mbarriers per stage, the projection's reduction buffer and the staged
    coefficients."""
    return (stages * piece * itemsize + (cols * itemsize if resident else 0) + 2 * stages * 8
            + (2 * 8 * MGS_ROW_GROUP + MGS_COEF_ROWS) * itemsize)


@functools.lru_cache(maxsize=256)
def mgs_plan(n: int, itemsize: int, num_sms: int, route: str | None = None) -> MgsPlan:
    """E2a's launch plan for an (n,)-wide basis of ``itemsize``-byte values
    on a card of ``num_sms`` SMs.

    The grid is persistent, :data:`MGS_CTAS_PER_SM` CTAs per SM, each owning
    one contiguous range of ``ceil(n / slots)`` columns rounded up to 128
    bytes (``ops/cgs.py`` ``block_plan``'s granule), so the last CTA may
    hold fewer and the grid is ``ceil(n / cols)``.  A ring stage holds
    :data:`MGS_PIECE_BYTES` of one row's range, or the whole range where it
    is shorter.  v's range stays in shared memory (route "smem") where it
    fits beside a ring of :data:`MGS_MIN_STAGES` stages at two CTAs per SM;
    otherwise it goes through L2 (route "l2").  The ring then takes what is
    left of a CTA's share, 2 to 4 stages.  ``route`` forces one route
    (tests of the L2 route at small n); forcing "smem" where v does not fit
    raises."""
    if n < 1 or itemsize not in (4, 8) or num_sms < 1:
        raise ValueError(f"mgs_plan: n={n}, itemsize={itemsize}, num_sms={num_sms}")
    granule = 128 // itemsize
    slots = MGS_CTAS_PER_SM * num_sms
    cols = -(-(-(-n // slots)) // granule) * granule
    piece = min(cols, MGS_PIECE_BYTES // itemsize)
    share = SM_SMEM_BYTES // MGS_CTAS_PER_SM - CTA_SMEM_RESERVED
    stage_bytes = piece * itemsize + 2 * 8

    def stages_left(resident: bool) -> int:
        return (share - mgs_smem_bytes(cols, piece, 0, itemsize, resident)) // stage_bytes

    fits = stages_left(True) >= MGS_MIN_STAGES
    if route is None:
        route = "smem" if fits else "l2"
    elif route not in ROUTES:
        raise ValueError(f"mgs_plan: route {route!r} is not one of {ROUTES}")
    elif route == "smem" and not fits:
        raise ValueError(f"mgs_plan: v's range of {cols} values does not fit in shared memory at n={n}")
    stages = max(MGS_MIN_STAGES, min(MGS_MAX_STAGES, stages_left(route == "smem")))
    return MgsPlan(cols, -(-n // cols), piece, stages, route)


_SMS: dict = {}  # SMs by CUDA device index


def mgs_launch(what: str, v, basis, k: int, chunk: int, plan: MgsPlan | None = None):
    """One cooperative launch of ``csrc/bcgs_ring.cu`` over validated CUDA
    operands, overwriting ``v``: block MGS over rows [0, k) in chunks of
    ``chunk`` rows, cut by ``plan`` (default :func:`mgs_plan`).  The host's
    part is kept short (a single pass at small k is a few hundred µs): the
    plan is cached, the stream is the raw handle of
    ``torch._C._cuda_getCurrentRawStream``, and one allocation holds the
    partial sums and the grid barrier's counter, which the kernel's entry
    point zeroes on the stream."""
    lib = _build.library()
    n = basis.shape[1]
    idx = v.device.index
    if plan is None:
        sms = _SMS.get(idx)
        if sms is None:
            sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = mgs_plan(n, basis.element_size(), sms)
    part = torch.empty(k * plan.grid + 1, dtype=basis.dtype, device=v.device)
    fn = lib.lt_bcgs_ring_f32 if basis.dtype == torch.float32 else lib.lt_bcgs_ring_f64
    ptr = part.data_ptr()
    err = fn(basis.data_ptr(), v.data_ptr(), ptr, ptr + k * plan.grid * part.element_size(), n, k, chunk, plan.cols,
             plan.piece, plan.stages, int(plan.route == "smem"), idx, torch._C._cuda_getCurrentRawStream(idx))
    _build.check(err, what)
    return v


def validate(name: str, v, basis, k) -> int:
    """Check a pass's operands and return ``k`` as an int.  On CUDA the
    kernel takes contiguous float32 or float64 tensors of one dtype on one
    device; anything else raises."""
    k = int(k)
    cap, n = basis.shape
    if v.shape != (n,) or not 0 <= k <= cap:
        raise ValueError(f"{name}: v of shape {tuple(v.shape)} / k={k} do not fit a basis of shape {(cap, n)}")
    if v.device.type == "cpu":
        return k
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {v.device}")
    if basis.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"{name} takes float32/float64 bases on CUDA, got {basis.dtype}; see {_DTYPE_ITEM}")
    if v.dtype != basis.dtype:
        raise TypeError(f"{name}: v dtype {v.dtype} differs from the basis dtype {basis.dtype}")
    if basis.device != v.device:
        raise ValueError(f"{name}: v and basis must be on one device")
    if not (basis.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    return k


def grid(basis, shadow=None) -> int:
    """The CTAs of the persistent cooperative grid a pass over this CUDA
    basis launches: a fixed number per SM (``csrc/cgs_variants.cu``
    ``ctas_per_sm``), at most one per column tile."""
    lib = _build.library()
    if shadow is not None:
        grid_fn = lib.lt_cgsv_grid_shadow
    elif basis.dtype == torch.float32:
        grid_fn = lib.lt_cgsv_grid_f32
    else:
        grid_fn = lib.lt_cgsv_grid_f64
    ctas = ctypes.c_int(0)
    _build.check(grid_fn(basis.shape[1], basis.device.index, ctypes.byref(ctas)), "cgs_variants: cooperative grid")
    return ctas.value


def launch(what: str, v, basis, k: int, shadow=None):
    """One cooperative launch of ``csrc/cgs_variants.cu`` over validated
    CUDA operands, overwriting ``v``: one classical pass over rows [0, k),
    with the coefficients measured against the bf16 ``shadow`` when one is
    given."""
    lib = _build.library()
    n = basis.shape[1]
    dev = v.device
    ctas = grid(basis, shadow)
    part = torch.empty(k * ctas, dtype=basis.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if shadow is not None:
        err = lib.lt_cgsv_shadow_pass(shadow.data_ptr(), basis.data_ptr(), v.data_ptr(), part.data_ptr(), n, k,
                                      ctas, dev.index, stream)
    else:
        fn = lib.lt_cgsv_pass_f32 if basis.dtype == torch.float32 else lib.lt_cgsv_pass_f64
        err = fn(basis.data_ptr(), v.data_ptr(), part.data_ptr(), n, k, ctas, dev.index, stream)
    _build.check(err, what)
    return v


def make_data(cap: int, n: int, seed: int = 0, strong: bool = False):
    """The studies' float32 inputs from ``numpy.random.default_rng(seed)``:
    a (cap, n) basis of unit rows and a vector v, plus 100 times the sum of
    the first eight rows when ``strong`` (large live-row components, as
    ``pallas_bcgs_kernel2.py`` and ``pallas_bcgs_kernel3.py`` make them)."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((cap, n), dtype=np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    v = rng.standard_normal(n, dtype=np.float32)
    if strong:
        v += basis[:8].sum(axis=0) * 100.0
    return basis, v


def rel_err(got, want, scale=None) -> float:
    """max |got - want| over ``scale`` (default max |want|), in float64."""
    err = float((got.double() - want.double()).abs().max())
    return err / float(want.double().abs().max() if scale is None else scale)
