"""Data, tensor and sequence parallelism over processes
(``parallel/mesh.py``, ``parallel/tp.py``, ``parallel/sp.py``)."""

from prompt_tts_tpu_torch.parallel.mesh import (
    barrier, block_group, block_rank, block_src, data_group, data_rank,
    data_size, distributed, gather_objects, grad_group, init_distributed,
    mean_over_ranks, model_group, model_rank, model_size, model_src,
    seq_group, seq_group_ranks, seq_rank, seq_size, set_mesh, shard_batch,
    shard_local_batch, world_rank,
)

__all__ = ["barrier", "block_group", "block_rank", "block_src",
           "data_group", "data_rank", "data_size", "distributed",
           "gather_objects", "grad_group", "init_distributed",
           "mean_over_ranks", "model_group", "model_rank", "model_size",
           "model_src", "seq_group", "seq_group_ranks", "seq_rank",
           "seq_size", "set_mesh", "shard_batch", "shard_local_batch",
           "world_rank"]
