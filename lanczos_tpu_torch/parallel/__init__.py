"""Row-partitioned execution over ``torch.distributed`` (port of
``lanczos_tpu.parallel``): :mod:`.mesh` (process groups and row slabs),
:mod:`.sharded` (the sharded operators) and :mod:`.mp_demo` (the
multi-process launch template, imported on its own)."""

from . import mesh, sharded
