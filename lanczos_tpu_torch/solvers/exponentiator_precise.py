"""The precise evolution at the JAX module's path (port of
``lanczos_tpu.solvers.exponentiator_precise``).

The JAX module carries the state and the whole Krylov pipeline as float32
word pairs because the TPU has no float64.  The port computes in native
float64 from the operator's own entries; its two functions are
:mod:`.exponentiator`'s, exported here.
"""

from __future__ import annotations

from .exponentiator import evolve_hermitian_split_precise, evolve_split_precise

__all__ = ["evolve_split_precise", "evolve_hermitian_split_precise"]
