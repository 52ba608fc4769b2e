from .pipeline import pp_stack, pp_stack_fn, stack_layer_params
from .sharding import (make_mesh, replicate, shard_batch, shard_hint,
                       sharded_model_fn, spmd_mesh)

__all__ = ["make_mesh", "pp_stack", "pp_stack_fn", "replicate", "shard_batch", "shard_hint",
           "sharded_model_fn", "spmd_mesh", "stack_layer_params"]
