"""Scale-out of the port across processes (the counterpart of the JAX
package's `parallel/`): the launch (`distributed`), the (data, model)
mesh and the batch block of each rank (`mesh`), and the TP and FSDP
layouts (`tp`)."""

from .distributed import maybe_initialize_distributed
from .mesh import (data_coords, get_mesh, global_batch_draws, make_mesh,
                   prefetch_to_device, set_mesh, shard_batch)
from .tp import (ShardingPlan, fsdp_param_count, parallelize,
                 tp_param_count)

__all__ = [
    "maybe_initialize_distributed",
    "data_coords", "get_mesh", "global_batch_draws", "make_mesh",
    "prefetch_to_device", "set_mesh", "shard_batch",
    "ShardingPlan", "fsdp_param_count", "parallelize", "tp_param_count",
]
