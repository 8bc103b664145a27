from danerf_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    make_sharded_train_step,
    param_pspecs,
    process_slice,
    replicate_pool,
    shard_train_state,
)

__all__ = [
    "make_mesh",
    "param_pspecs",
    "replicate_pool",
    "shard_train_state",
    "make_sharded_train_step",
    "initialize_distributed",
    "process_slice",
]
