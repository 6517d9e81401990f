"""The mesh: the ``data`` and ``model`` axes over processes, one per GPU.

Port of ``prompt_tts_tpu/parallel/mesh.py`` and of ``init_multihost``
(``prompt_tts_tpu/cli/train.py``).  The JAX package shards a global batch
over the ``data`` axis of a ``(data, model, seq)`` device mesh and lets
XLA insert the collectives; here every process is one rank of a
``torch.distributed`` process group, and the ranks are laid out
data-major as ``make_mesh`` reshapes its devices: world rank ``w`` sits
at data row ``w // n_model``, model column ``w % n_model``.  Each data row
is one model group (the ``n_model`` ranks that hold the shards of one
model, ``parallel/tp.py``), each model column one data group (the ranks
whose gradients DDP all-reduces).  Rank ``r`` of ``P`` on the data axis
holds rows ``[r*B/P, (r+1)*B/P)`` of a global batch of ``B`` rows, as the
JAX package's ``process_shard`` does; the ranks of one model group hold
the same rows.  At ``n_model`` 1 the data axis is the world and no group
is made; without a process group everything is rank 0 of 1 and no
collective runs.

The ``seq`` axis (sequence parallelism) is not ported: ``n_seq`` other
than 1 raises (``ROADMAP.md`` §1, sequence parallelism).
"""

import os
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# the mesh of this process: its model-axis size and the groups of its data
# row (model) and model column (data); None groups mean the world (data)
# and no group (model)
_MESH = {"n_model": 1, "model": None, "data": None}


def distributed() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def _n_model() -> int:
    return _MESH["n_model"] if distributed() else 1


def world_rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if distributed() else 0


def data_rank() -> int:
    """This process's rank on the data axis (``jax.process_index`` without
    tensor parallelism)."""
    return world_rank() // _n_model()


def data_size() -> int:
    """The number of ranks on the data axis (``jax.process_count`` without
    tensor parallelism)."""
    return (dist.get_world_size() if distributed() else 1) // _n_model()


def model_rank() -> int:
    """This process's rank in its model group."""
    return world_rank() % _n_model()


def model_size() -> int:
    """The number of ranks in a model group (``--tp``)."""
    return _n_model()


def model_group():
    """This rank's model group (None at ``model_size()`` 1)."""
    return _MESH["model"] if _n_model() > 1 else None


def data_group():
    """This rank's data group (None: the world, at ``model_size()`` 1)."""
    return _MESH["data"] if _n_model() > 1 else None


def model_src() -> int:
    """The world rank of this model group's rank 0."""
    return world_rank() - model_rank()


def _check_seq(n_seq: int) -> None:
    if n_seq != 1:
        raise ValueError(
            f"n_seq={n_seq}: sequence parallelism is not ported (ROADMAP.md "
            "§1, item 4: sequence parallelism and ring attention)")


def set_mesh(n_model: int = 1, n_seq: int = 1) -> None:
    """Lay the world out as ``(world / n_model, n_model)`` ranks, data-major,
    and make the groups of both axes.  Every rank must call it, with the
    same arguments (``dist.new_group`` is collective).  Raises when
    ``n_model`` does not divide the world or ``n_seq`` is not 1."""
    _check_seq(n_seq)
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if not distributed():
        if n_model != 1:
            raise ValueError(f"n_model={n_model} needs a process group of a "
                             "multiple of that many ranks (--multihost)")
        _MESH.update(n_model=1, model=None, data=None)
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_model:
        raise ValueError(f"{world} ranks not divisible by n_model={n_model}")
    model = data = None
    if n_model > 1:
        n_data = world // n_model
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                model = group
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            group = dist.new_group(ranks)
            if rank in ranks:
                data = group
    _MESH.update(n_model=n_model, model=model, data=data)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     n_model: int = 1, n_seq: int = 1,
                     timeout: Optional[timedelta] = None) -> torch.device:
    """Join the process group, lay out the mesh (:func:`set_mesh`), and
    return this rank's device.

    The rendezvous comes from ``PTTS_COORDINATOR`` (``host:port``),
    ``PTTS_NUM_PROCESSES`` and ``PTTS_PROCESS_ID``, as the JAX package
    reads them, or else from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE``.  ``device`` "cuda" becomes
    ``cuda:LOCAL_RANK`` (without ``LOCAL_RANK``, the rank modulo the
    number of cards), made the current device; "cpu" stays the CPU.  The
    backend is NCCL on a card and gloo on the CPU, unless ``backend``
    names one: ranks that share one card pass "gloo", since NCCL needs a
    card a rank.  ``timeout`` bounds every collective (torch's default
    when None): a rank that waits on another for longer raises.
    """
    _check_seq(n_seq)
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
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, **kw)
    set_mesh(n_model)
    return device


def shard_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of a global host batch, by its data rank (the JAX
    package's ``_to_global``: every process holds the same global batch
    and keeps its shard).  Raises when the batch does not split evenly."""
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
    """The mean of ``x`` over the data axis (a new tensor; ``x`` itself
    without a process group)."""
    if not distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=data_group())     # SUM: gloo has no AVG
    return y / data_size()


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if distributed():
        dist.barrier()


def gather_objects(obj) -> list:
    """``obj`` of every rank of this rank's data group, in data-rank order,
    on each of them (pickled, so it travels on the CPU under gloo)."""
    if not distributed():
        return [obj]
    out = [None] * data_size()
    dist.all_gather_object(out, obj, group=data_group())
    return out
