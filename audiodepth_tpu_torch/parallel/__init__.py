"""Data parallelism over several ranks (port of `parallel/`): the data
group and its differentiable reductions (`mesh`), process-group setup and
the per-rank batch slices (`multihost`)."""

from .mesh import (DataGroup, active_group, all_reduce_grads_, broadcast_module, draw_global,
                   global_mean, global_rows, global_sum, pad_batch_to, use_group)
from .multihost import initialize_multihost, local_batch_slice, local_shard, shutdown

__all__ = ["DataGroup", "active_group", "all_reduce_grads_", "broadcast_module", "draw_global",
           "global_mean", "global_rows", "global_sum", "pad_batch_to", "use_group",
           "initialize_multihost", "local_batch_slice", "local_shard", "shutdown"]
