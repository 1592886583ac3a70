from scrabblegan.parallel.mesh import (
    make_mesh,
    replicate_sharding,
    batch_sharding,
    make_parallel_train_step,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "replicate_sharding",
    "batch_sharding",
    "make_parallel_train_step",
    "shard_batch",
]
