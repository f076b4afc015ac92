"""Row-partitioned execution over ``torch.distributed`` (port of
``lanczos_tpu.parallel``): :mod:`.mesh` (process groups and row slabs),
:mod:`.sharded` (the sharded operators), :mod:`.mp_demo` (the
multi-process launch template) and :mod:`.multichip` (the multi-card
dryrun and its launcher), the last two imported on their own."""

from . import mesh, sharded
