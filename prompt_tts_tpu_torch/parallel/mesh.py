"""The mesh: the ``data``, ``model`` and ``seq`` axes over processes, one
per GPU.

Port of ``prompt_tts_tpu/parallel/mesh.py`` and of ``init_multihost``
(``prompt_tts_tpu/cli/train.py``).  The JAX package shards a global batch
over the ``data`` axis of a ``(data, model, seq)`` device mesh and lets
XLA insert the collectives; here every process is one rank of a
``torch.distributed`` process group, and the ranks are laid out as
``make_mesh`` reshapes its devices, ``(n_data, n_model, n_seq)``: world
rank ``w`` sits at data row ``w // (n_model * n_seq)``, model column
``(w // n_seq) % n_model`` and seq position ``w % n_seq``.  The ranks that
differ only in their model column form a model group (the shards of one
model, ``parallel/tp.py``), those that differ only in their seq position
a seq group (the slices of latent time, ``parallel/sp.py``), and those
that differ only in their data row a data group.  The ranks of one model
column (data x seq) are the gradient group: DDP averages over it, and
each seq rank's gradient is ``n_seq`` times its partial sum
(``parallel/sp.py``), so the average is the data average of the whole
gradients.  Rank ``r`` of ``P`` on the data axis holds rows ``[r*B/P,
(r+1)*B/P)`` of a global batch of ``B`` rows, as the JAX package's
``process_shard`` does; the ranks of one data row (its model x seq block)
hold the same rows.  At ``n_model`` and ``n_seq`` 1 the data axis is the
world and no group is made; without a process group everything is rank
0 of 1 and no collective runs.
"""

import os
from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# the mesh of this process: the model and seq axes' sizes and the groups
# this rank belongs to; a None group is the world (data, grad, block) or
# no group at all (model, seq)
_MESH = {"n_model": 1, "n_seq": 1, "model": None, "seq": None,
         "data": None, "grad": None, "block": None, "seq_ranks": [0]}


def distributed() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def _n_model() -> int:
    return _MESH["n_model"] if distributed() else 1


def _n_seq() -> int:
    return _MESH["n_seq"] if distributed() else 1


def world_rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if distributed() else 0


def _block() -> int:
    """The ranks of one data row: model x seq."""
    return _n_model() * _n_seq()


def data_rank() -> int:
    """This process's rank on the data axis (``jax.process_index`` without
    tensor or sequence parallelism)."""
    return world_rank() // _block()


def data_size() -> int:
    """The number of ranks on the data axis (``jax.process_count`` without
    tensor or sequence parallelism)."""
    return (dist.get_world_size() if distributed() else 1) // _block()


def model_rank() -> int:
    """This process's rank in its model group."""
    return (world_rank() // _n_seq()) % _n_model()


def model_size() -> int:
    """The number of ranks in a model group (``--tp``)."""
    return _n_model()


def seq_rank() -> int:
    """This process's rank in its seq group: which slice of latent time it
    holds."""
    return world_rank() % _n_seq()


def seq_size() -> int:
    """The number of ranks in a seq group (``--sp``)."""
    return _n_seq()


def block_rank() -> int:
    """This process's rank in its data row's model x seq block."""
    return world_rank() % _block()


def model_group():
    """This rank's model group (None at ``model_size()`` 1)."""
    return _MESH["model"] if _n_model() > 1 else None


def seq_group():
    """This rank's seq group (None at ``seq_size()`` 1)."""
    return _MESH["seq"] if _n_seq() > 1 else None


def seq_group_ranks() -> List[int]:
    """The world ranks of this rank's seq group, in seq order."""
    return list(_MESH["seq_ranks"]) if _n_seq() > 1 else [world_rank()]


def data_group():
    """This rank's data group (None: the world, at ``model_size()`` and
    ``seq_size()`` 1)."""
    return _MESH["data"] if _block() > 1 else None


def grad_group():
    """The ranks DDP averages the gradients over: this rank's model column,
    data x seq (None: the world, at ``model_size()`` 1)."""
    return _MESH["grad"] if _n_model() > 1 else None


def block_group():
    """This rank's data row, model x seq: the ranks that run one synthesis
    together (None: the world, at ``data_size()`` 1)."""
    return _MESH["block"] if data_size() > 1 else None


def model_src() -> int:
    """The world rank of this model group's rank 0."""
    return world_rank() - model_rank() * _n_seq()


def block_src() -> int:
    """The world rank of this data row's block rank 0."""
    return world_rank() - block_rank()


def set_mesh(n_model: int = 1, n_seq: int = 1) -> None:
    """Lay the world out as ``(world / (n_model n_seq), n_model, n_seq)``
    ranks and make the groups of every axis.  Every rank must call it,
    with the same arguments (``dist.new_group`` is collective).  Raises
    when ``n_model * n_seq`` does not divide the world."""
    if n_model < 1 or n_seq < 1:
        raise ValueError(f"n_model and n_seq must be >= 1, got {n_model} "
                         f"and {n_seq}")
    if not distributed():
        if n_model != 1 or n_seq != 1:
            raise ValueError(f"n_model={n_model} x n_seq={n_seq} needs a "
                             "process group of a multiple of that many "
                             "ranks (--multihost)")
        _MESH.update(n_model=1, n_seq=1, model=None, seq=None, data=None,
                     grad=None, block=None, seq_ranks=[0])
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    block = n_model * n_seq
    if world % block:
        raise ValueError(f"{world} ranks are not n_data x n_model={n_model} "
                         f"x n_seq={n_seq}")
    n_data = world // block

    def at(d, m, s):
        return d * block + m * n_seq + s

    def mine(all_ranks):
        """Make a group of each list of ranks; return this rank's."""
        out = None
        for ranks in all_ranks:
            group = dist.new_group(ranks)
            if rank in ranks:
                out = (group, ranks)
        return out

    model = seq = data = grad = blk = None
    seq_ranks = [rank]
    if n_model > 1:
        model = mine([[at(d, m, s) for m in range(n_model)]
                      for d in range(n_data) for s in range(n_seq)])[0]
    if n_seq > 1:
        seq, seq_ranks = mine([[at(d, m, s) for s in range(n_seq)]
                               for d in range(n_data)
                               for m in range(n_model)])
    if block > 1:
        data = mine([[at(d, m, s) for d in range(n_data)]
                     for m in range(n_model) for s in range(n_seq)])[0]
        blk = mine([[at(d, m, s) for m in range(n_model)
                     for s in range(n_seq)] for d in range(n_data)])[0]
    if n_model > 1:
        grad = (data if n_seq == 1 else
                mine([[at(d, m, s) for d in range(n_data)
                       for s in range(n_seq)] for m in range(n_model)])[0])
    _MESH.update(n_model=n_model, n_seq=n_seq, model=model, seq=seq,
                 data=data, grad=grad, block=blk, seq_ranks=seq_ranks)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     n_model: int = 1, n_seq: int = 1,
                     timeout: Optional[timedelta] = None) -> torch.device:
    """Join the process group, lay out the mesh (:func:`set_mesh`), and
    return this rank's device.

    The rendezvous comes from ``PTTS_COORDINATOR`` (``host:port``),
    ``PTTS_NUM_PROCESSES`` and ``PTTS_PROCESS_ID``, as the JAX package
    reads them, or else from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE``.  ``device`` "cuda" becomes
    ``cuda:LOCAL_RANK`` (without ``LOCAL_RANK``, the rank), modulo the
    number of cards (ranks may share one), made the current device; "cpu"
    stays the CPU.  The
    backend is NCCL on a card and gloo on the CPU, unless ``backend``
    names one: ranks that share one card pass "gloo", since NCCL needs a
    card a rank.  ``timeout`` bounds every collective (torch's default
    when None): a rank that waits on another for longer raises.
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
        local = int(os.environ.get("LOCAL_RANK", rank)) \
            % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, **kw)
    set_mesh(n_model, n_seq)
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
