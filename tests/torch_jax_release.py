"""A module-scoped fixture for the port's test files that run the JAX
package as their oracle: at the end of each module it drops the JAX
executables the module compiled (``jax.clear_caches``) and collects them.

Every XLA CPU executable keeps its generated code in memory mappings, and a
pytest worker keeps every executable it compiles.  Past the kernel's
``vm.max_map_count`` (65530 on the test machines) the next compile cannot
map its code and XLA segfaults: ``tests/test_graft_entry.py::
test_dryrun_multichip_2`` crashed at 64946 mappings in one process that had
run ``test_torch_cgs.py``, ``test_lanczos.py``, ``test_operators.py``,
``test_torch_exponentiator.py``, ``test_torch_package.py`` and
``test_torch_filtered.py`` before it, the crash the xdist runs saw when the
order of files on a worker changed.  Releasing at each module's end keeps a
worker's count to what its current module needs.  Import the fixture into a
test module to use it."""

import gc
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
