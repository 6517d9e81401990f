"""The data axis: one process per GPU, the batch split over the processes.

Port of the data axis of ``prompt_tts_tpu/parallel/mesh.py`` and of
``init_multihost`` (``prompt_tts_tpu/cli/train.py``).  The JAX package
shards a global batch over the ``data`` axis of its mesh and lets XLA
insert the gradient all-reduce; here every process is one rank of a
``torch.distributed`` process group, holds its rows of each global batch,
and the trainer wraps its model in ``DistributedDataParallel``, whose
backward hooks all-reduce the gradients.  Rank ``r`` of ``P`` holds rows
``[r*B/P, (r+1)*B/P)`` of a global batch of ``B`` rows, as the JAX
package's ``process_shard`` does.  Without a process group every function
here answers for one process (rank 0 of 1) and no collective runs.

Tensor and sequence parallelism (the mesh's ``model`` and ``seq`` axes)
are not ported.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def distributed() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def data_rank() -> int:
    """This process's rank on the data axis (``jax.process_index``)."""
    return dist.get_rank() if distributed() else 0


def data_size() -> int:
    """The number of processes on the data axis (``jax.process_count``)."""
    return dist.get_world_size() if distributed() else 1


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group, and return this rank's device.

    The rendezvous comes from ``PTTS_COORDINATOR`` (``host:port``),
    ``PTTS_NUM_PROCESSES`` and ``PTTS_PROCESS_ID``, as the JAX package
    reads them, or else from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE``.  ``device`` "cuda" becomes
    ``cuda:LOCAL_RANK`` (without ``LOCAL_RANK``, the rank modulo the
    number of cards), made the current device; "cpu" stays the CPU.  The
    backend is NCCL on a card and gloo on the CPU, unless ``backend``
    names one: ranks that share one card pass "gloo", since NCCL needs a
    card a rank.
    """
    device = torch.device(device)
    coord = os.environ.get("PTTS_COORDINATOR")
    if coord:
        rank = int(os.environ["PTTS_PROCESS_ID"])
        kw = dict(init_method=f"tcp://{coord}", rank=rank,
                  world_size=int(os.environ["PTTS_NUM_PROCESSES"]))
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    else:
        raise RuntimeError(
            "init_distributed: set PTTS_COORDINATOR, PTTS_NUM_PROCESSES "
            "and PTTS_PROCESS_ID, or launch under torchrun")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device cuda asked for, "
                               "but no CUDA device is visible")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, **kw)
    return device


def shard_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of a global host batch (the JAX package's
    ``_to_global``: every process holds the same global batch and keeps
    its shard).  Raises when the batch does not split evenly."""
    rank, size = data_rank(), data_size()
    if size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if len(v) % size:
            raise ValueError(f"batch of {len(v)} rows not divisible by "
                             f"{size} processes")
        n = len(v) // size
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def shard_local_batch(batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """A batch of this rank's rows already (a dataset's ``process_shard``
    slice): the identity, since DDP needs no global array."""
    return batch


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a new tensor; ``x`` itself
    without a process group)."""
    if not distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)          # SUM: gloo has no AVG
    return y / data_size()


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if distributed():
        dist.barrier()


def gather_objects(obj) -> list:
    """``obj`` of every rank, in rank order, on every rank (pickled, so it
    travels on the CPU under gloo)."""
    if not distributed():
        return [obj]
    out = [None] * data_size()
    dist.all_gather_object(out, obj)
    return out
