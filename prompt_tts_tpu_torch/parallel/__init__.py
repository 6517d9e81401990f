"""Data parallelism over processes (``parallel/mesh.py``)."""

from prompt_tts_tpu_torch.parallel.mesh import (
    barrier, data_rank, data_size, distributed, gather_objects,
    init_distributed, mean_over_ranks, shard_batch, shard_local_batch,
)

__all__ = ["barrier", "data_rank", "data_size", "distributed",
           "gather_objects", "init_distributed", "mean_over_ranks",
           "shard_batch", "shard_local_batch"]
