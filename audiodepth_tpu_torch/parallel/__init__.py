"""Parallelism over several ranks (port of `parallel/`): the data group,
the 2-D ('data', 'model') group and their differentiable reductions
(`mesh`), process-group setup and the per-rank batch slices (`multihost`),
the sequence-parallel attention's collectives (`sequence`) and the
halo-exchange sharded STFT (`sharded_stft`)."""

from .mesh import (DataGroup, MeshGroup, active_axis, active_group, all_reduce_grads_,
                   broadcast_module, collectives, data_axis, draw_global, global_mean,
                   global_rows, global_sum, make_mesh_group, model_axes_cross_processes,
                   pad_batch_to, shard_global_batch, use_group, world_of)
from .multihost import (initialize_multihost, local_batch_slice, local_shard, make_global_mesh,
                        shutdown)
from .sharded_stft import sharded_magnitude_stft

__all__ = ["DataGroup", "MeshGroup", "active_axis", "active_group", "all_reduce_grads_",
           "broadcast_module", "collectives", "data_axis", "draw_global", "global_mean",
           "global_rows", "global_sum", "make_mesh_group", "model_axes_cross_processes",
           "pad_batch_to", "shard_global_batch", "use_group", "world_of",
           "initialize_multihost", "local_batch_slice", "local_shard", "make_global_mesh",
           "shutdown", "sharded_magnitude_stft"]
