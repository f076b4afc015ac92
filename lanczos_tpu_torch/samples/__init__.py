"""The twelve samples of the JAX package (``samples/``), ported.

Each keeps its JAX counterpart's name, sizes, seeds and printed labels, and
adds a line ``error <what>: <value>`` for every result it checks against the
truth it computes (analytic, numpy or scipy), so that a run can be held to
:data:`BARS`.  Run one as ``python -m lanczos_tpu_torch.samples.<name>``; the
device is ``LT_SAMPLE_DEVICE`` (default ``cuda``, the counterpart of the JAX
samples' ``LT_SAMPLE_PLATFORM``): ``LT_SAMPLE_DEVICE=cpu`` runs them on the
CPU, and without a card the default fails rather than fall back.
"""

from __future__ import annotations

import os
import re

__all__ = ["SAMPLES", "BARS", "sample_device", "printed_errors"]

SAMPLES = (
    "sample1_simple",
    "sample2_sparse",
    "sample3_dynamic",
    "sample4_numpy_interop",
    "sample5_multiroot",
    "sample6_sharded_spmv",
    "sample7_time_evolution",
    "sample8_advanced_engines",
    "sample9_shift_invert",
    "sample10_offset_helper",
    "sample11_filtered",
    "sample12_refined_checkpoint",
)

# The largest error each printed ``error`` line may show: the JAX sample's
# own assertion where it has one, else the bar at which the JAX package's
# tests hold that API (file:line).  f64 eps below: the default Lanczos eps,
# machine_eps * 1e3 = 2.22e-13.
BARS = {
    "sample1_simple": {  # tests/test_lanczos.py:31-32: 4 eps and 40 eps
        "eigenvalue": 8.9e-13, "eigenvector": 8.9e-12},
    "sample2_sparse": {  # 4 eps (tests/test_lanczos.py:31); residual tests/test_block_lanczos.py:40
        "eigenvalue": 8.9e-13, "residual": 1e-8},
    "sample3_dynamic": {  # tests/test_lanczos.py:340, the chain
        "eigenvalue": 1e-10},
    "sample4_numpy_interop": {  # tests/test_lanczos.py:31
        "eigenvalue (array)": 8.9e-13, "eigenvalue (matvec)": 8.9e-13},
    "sample5_multiroot": {  # tests/test_block_lanczos.py:37, :40
        "eigenvalues": 1e-9, "residual": 1e-8},
    # The JAX sample caps a gap-less n = 4096 chain at 256 warm-restarted
    # vectors and asserts nothing: its value is budget-limited (it warns
    # so), and its error follows the start vector.  The port seeds that
    # start (seed 1), so the error is the same on every run of one engine
    # (3.8e-7 with the CPU's hybrid engine).  The bar is the port's own:
    # the chain's gap from its lowest level to the next, 2 cos(pi/(n+1)) -
    # 2 cos(2 pi/(n+1)) = 1.76e-6; a value within it is nearer the lowest
    # level than the gap that the budget has to resolve.
    "sample6_sharded_spmv": {"eigenvalue": 1.76e-6},
    "sample7_time_evolution": {  # the exponentiator's eps, 2.2e-14 (tests/test_exponentiator.py:29);
        # the evolutions' angle bar 1e-10 (:317); the float32 Chebyshev chain's 5e-6 (:454)
        "step-by-step overlap vs expm": 2.220446049250313e-14, "evolve vs expm": 1e-10,
        "precise evolve vs expm": 1e-10, "chebyshev chain vs expm": 5e-6, "chebyshev trajectory vs expm": 5e-6},
    "sample8_advanced_engines": {  # tests/test_block_lanczos.py:37; tests/test_lanczos.py:475 (thick);
        # tests/test_block_thick.py:236's 1e-10 (block thick); tests/test_precise_thick.py:53
        "block Lanczos": 1e-9, "thick restart": 1e-10, "block+thick": 1e-10, "precise_vectors+thick": 1e-10},
    "sample9_shift_invert": {  # tests/test_coverage_gaps.py:447 (tight sigma), :384 (filtered sigma);
        # residuals tests/test_block_lanczos.py:40; MINRES :231's 1e-8
        "shift-invert vs dense": 1e-10, "residual": 1e-8, "minres residual": 1e-8, "filtered vs dense": 1e-10},
    "sample10_offset_helper": {  # the sample's own assertion
        "min eigenvalue": 1e-9, "no offset": 1e-9},
    "sample11_filtered": {  # the sample's own assertions
        "filtered vs analytic": 2e-4, "precise vs analytic": 1e-11},
    "sample12_refined_checkpoint": {  # the sample's own assertions
        "eigenvalue": 1e-12, "vector residual": 1e-10, "hermitian value": 1e-10, "hermitian residual": 1e-10},
}

_ERROR_LINE = re.compile(r"^error (.+): (\S+)$", re.M)


def sample_device() -> str:
    """``LT_SAMPLE_DEVICE``, default ``cuda``; raises when that asks for a
    card there is none of (a sample never falls back to the CPU)."""
    import torch

    device = os.environ.get("LT_SAMPLE_DEVICE", "cuda")
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"LT_SAMPLE_DEVICE={device} but no CUDA device: set LT_SAMPLE_DEVICE=cpu for the CPU")
    return device


def printed_errors(stdout: str) -> dict:
    """``{what: largest value}`` of a sample's ``error <what>: <value>``
    lines."""
    out = {}
    for what, value in _ERROR_LINE.findall(stdout):
        out[what] = max(out.get(what, 0.0), float(value))
    return out
