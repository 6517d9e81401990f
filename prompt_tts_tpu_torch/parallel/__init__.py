"""Data and tensor parallelism over processes (``parallel/mesh.py``,
``parallel/tp.py``)."""

from prompt_tts_tpu_torch.parallel.mesh import (
    barrier, data_group, data_rank, data_size, distributed, gather_objects,
    init_distributed, mean_over_ranks, model_group, model_rank, model_size,
    model_src, set_mesh, shard_batch, shard_local_batch, world_rank,
)

__all__ = ["barrier", "data_group", "data_rank", "data_size", "distributed",
           "gather_objects", "init_distributed", "mean_over_ranks",
           "model_group", "model_rank", "model_size", "model_src",
           "set_mesh", "shard_batch", "shard_local_batch", "world_rank"]
