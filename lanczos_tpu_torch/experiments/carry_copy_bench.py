"""E3: the in-place row write of a Krylov buffer, and the per-iteration
cost of the buffer variants around it (port of
``experiments/carry_copy_bench.py``).

The JAX study measured what one row update of a large buffer carried
through a ``lax.while_loop`` costs.  Eager PyTorch carries nothing: a
buffer is updated in place and the loop is the host's.  The variants
keep the study's names:

  A  one (cap1, n) buffer, ``buf[k % cap1] = w`` with a host k;
  C  K chunks of cap1 / K rows, the chunk chosen on the host;
  G  one buffer, :func:`row_set` (kernel E3) with k a device word;
  G_graph  G's steps captured in a CUDA graph, one graph for each of the
     marginal method's two lengths, then replayed: the host enqueues
     one graph per run, which is what k on the device is for (the JAX
     study's counterpart is its compiled ``lax.while_loop``);
  H  one buffer, a row read only (the expression A, C and G start with,
     its result dropped: an eager read has to launch something);
  I  nothing: the loop alone.

``cgs=True`` adds the full-basis read of a reorthogonalization,
``w - (buf @ w) @ buf`` in plain ``torch.matmul`` (C concatenates its
chunks first, as the JAX study does).

Run on the card: ``python -m lanczos_tpu_torch.experiments.carry_copy_bench``.
"""

from __future__ import annotations

import json
import os

import torch

from .. import _build
from . import _timing

__all__ = ["VARIANTS", "row_set", "row_set_reference", "run_variant", "main"]

VARIANTS = ("A", "C", "G", "G_graph", "H", "I")


def row_set_reference(buf, k, w):
    """Plain PyTorch: ``buf[k] = w`` in place for the one-element index
    tensor ``k``, and nothing written when k lies outside [0, cap1); the
    host never reads k.  Returns ``buf``."""
    cap1 = buf.shape[0]
    idx = k.long().clamp(0, cap1 - 1)
    inside = (k >= 0) & (k < cap1)
    buf.index_copy_(0, idx, torch.where(inside, w, buf.index_select(0, idx)[0])[None])
    return buf


# The kernel's foreign function by dtype, filled at the first CUDA call
# (the library is built then, never at import).
_ROW_SET_FNS: dict = {}


def _row_set_fn(dtype, w_dtype):
    if dtype not in (torch.float32, torch.float64) or w_dtype != dtype:
        raise NotImplementedError(f"row_set takes float32/float64 on CUDA, got {dtype} / {w_dtype}")
    if not _ROW_SET_FNS:
        lib = _build.library()
        _ROW_SET_FNS.update({torch.float32: lib.lt_row_set_f32, torch.float64: lib.lt_row_set_f64})
    return _ROW_SET_FNS[dtype]


def row_set(buf, k, w):
    """E3: write ``w`` into row ``k`` of the (cap1, n) buffer ``buf`` in
    place and return ``buf``; ``k`` is a one-element int32 tensor on the
    buffer's device, and a k outside [0, cap1) writes nothing.

    On CUDA tensors this launches ``csrc/row_set.cu``, which reads k
    itself (float32 or float64; other dtypes raise), and counts the launch
    in ``row_set.launches``; the launch may be captured in a CUDA graph.
    On CPU tensors it runs :func:`row_set_reference`.

    The CUDA path is the host's whole cost of the kernel, so it does only
    the checks and the launch: the foreign function is resolved once, and
    the stream is the raw handle of ``torch._C._cuda_getCurrentRawStream``
    (what PyTorch's own generated code launches on), not a ``Stream``
    object.
    """
    cap1, n = buf.shape
    if w.shape != (n,) or k.shape != (1,) or k.dtype != torch.int32:
        raise ValueError(f"row_set: w {tuple(w.shape)} and k {tuple(k.shape)} {k.dtype} for a buffer of {(cap1, n)}")
    dev = buf.device
    if not (dev == w.device == k.device):
        raise ValueError("row_set: buf, w and k must be on one device")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return row_set_reference(buf, k, w)
        raise ValueError(f"row_set runs on CPU or CUDA tensors, got {dev}")
    fn = _ROW_SET_FNS.get(buf.dtype) if w.dtype == buf.dtype else None
    if fn is None:
        fn = _row_set_fn(buf.dtype, w.dtype)
    if not (buf.is_contiguous() and w.is_contiguous()):
        raise ValueError("row_set needs contiguous tensors")
    err = fn(buf.data_ptr(), k.data_ptr(), w.data_ptr(), cap1, n, dev.index,
             torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        _build.check(err, "row_set (E3)")
    row_set.launches += 1
    return buf


row_set.launches = 0


def run_variant(name: str, cap1: int, n: int, K: int = 8, cgs: bool = False, device="cuda", seed: int = 0) -> dict:
    """One variant's cost on the card: ``us`` is microseconds per
    iteration by the marginal method over 40 and 200 iterations (CUDA
    events around the enqueued loop, so host-bound loops show their host
    time), ``iterations`` the iterations run in all (G_graph: replayed),
    ``launches`` the calls of :func:`row_set` it made (G_graph: its
    warm-up and the calls its two captures recorded; replays launch the
    recorded kernels without a call).  The buffer is drawn on the device
    from ``seed``."""
    device = _timing.cuda_device(device)
    rows = cap1 // K
    if rows * K != cap1:
        raise ValueError(f"cap1={cap1} is not K={K} chunks")
    gen = torch.Generator(device=device).manual_seed(seed)
    if name in ("A", "G", "G_graph", "H", "I"):
        buf = torch.randn((cap1, n), generator=gen, device=device)
    elif name == "C":
        chunks = [torch.randn((rows, n), generator=gen, device=device) for _ in range(K)]
    else:
        raise ValueError(f"unknown variant {name!r}")

    def cgs_term(read_all, w):
        return w - (read_all @ w) @ read_all

    def step_a(k):
        w = buf[(k - 1) % cap1] * 0.999 + 1e-9
        if cgs:
            w = cgs_term(buf, w)
        buf[k % cap1] = w

    def step_c(k):
        prev = (k - 1) % cap1
        w = chunks[prev // rows][prev % rows] * 0.999 + 1e-9
        if cgs:
            w = cgs_term(torch.cat(chunks), w)
        cur = k % cap1
        chunks[cur // rows][cur % rows] = w

    def step_h(k):
        buf[(k - 1) % cap1] * 0.999 + 1e-9

    kd = torch.ones(1, dtype=torch.int32, device=device)

    def step_g(_k):
        w = buf.index_select(0, (kd - 1) % cap1)[0] * 0.999 + 1e-9
        if cgs:
            w = cgs_term(buf, w)
        row_set(buf, kd % cap1, w)
        kd.add_(1)

    step = {"A": step_a, "C": step_c, "G": step_g, "G_graph": step_g, "H": step_h, "I": lambda k: None}[name]
    count = [0]
    launches = row_set.launches

    def run_eager(r):
        kd.fill_(1)
        for k in range(1, r + 1):
            step(k)

    def run(r):
        run_eager(r)
        count[0] += r

    if name == "G_graph":
        run = _captured(run_eager, (40, 200), device, count)
    us = _timing.marginal(run, 40, 200, device=device) * 1e6
    return {"us": us, "iterations": count[0], "launches": row_set.launches - launches}


def _captured(run_eager, lengths, device, count):
    """``run(r)`` replaying a CUDA graph of ``run_eager(r)`` for each ``r``
    in ``lengths``, captured after one eager warm-up on a side stream."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run_eager(3)
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    graphs = {}
    for r in lengths:
        graphs[r] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[r]):
            run_eager(r)

    def run(r):
        graphs[r].replay()
        count[0] += r

    return run


def main(device="cuda") -> None:
    """Every variant at cap1 = 256, n in (2**18, 2**20), cgs in (0, 1):
    one line each, then one JSON object.  ``CARRY_VARIANTS`` (default
    "A,C,G,G_graph,H,I") picks the variants."""
    device = _timing.cuda_device(device)
    only = os.environ.get("CARRY_VARIANTS", ",".join(VARIANTS)).split(",")
    out = {"device": torch.cuda.get_device_name(device)}
    for n in (1 << 18, 1 << 20):
        for cgs in (False, True):
            for name in VARIANTS:
                if name in only:
                    key = f"{name}_n{n}_cgs{int(cgs)}"
                    out[key] = round(run_variant(name, 256, n, K=8, cgs=cgs, device=device)["us"], 1)
                    print(key, out[key], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
