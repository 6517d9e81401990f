"""Checkpointing with restore, step-based.

Port of ``prompt_tts_tpu/train/checkpoint.py`` in the port's own format
(not orbax): ``<ckpt_dir>/step_<N>/state.pt`` holds the model, optimizer,
EMA and accumulation state (:meth:`TrainState.state_dict`), the step, and
the states of the generators that drive training, so a resumed run draws
the same noise, timesteps and dropout masks it would have drawn.  A save
writes into a temporary directory and renames it, so a checkpoint on disk
is always whole; the oldest beyond ``max_to_keep`` are deleted.
:meth:`CheckpointManager.read_model_state` is the inference read: the
model's weights (or their EMA) alone, mapped from the file on the CPU.
Under data parallelism rank 0 writes and every rank waits for it at a
barrier; every rank restores the same file, and a checkpoint written by
several ranks loads in one process.  Under tensor parallelism the ranks
of rank 0's model group send it their slices of the state (parameters,
AdamW moments, EMA, accumulated gradients), and it writes the whole
(one-rank) layout (``parallel.tp.gather_train_state``); a restore reads
the whole state and keeps this rank's slices, so a checkpoint restores
on any number of model ranks, and in one process.  Under sequence
parallelism the ranks of a seq group hold the same parameters: the seq
rank 0 of data row 0 writes (with its model group's slices), and a
checkpoint restores on any number of seq ranks.
"""

import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

import torch.distributed as dist

from prompt_tts_tpu_torch.parallel import (
    barrier, data_rank, model_group, model_rank, model_size, model_src,
    seq_rank, world_rank,
)
from prompt_tts_tpu_torch.parallel.tp import (
    gather_train_state, shard_train_state,
)
from prompt_tts_tpu_torch.train.state import TrainState

_STEP_DIR = re.compile(r"step_(\d+)")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_DIR.fullmatch, os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int,
             generators: Optional[Dict[str, torch.Tensor]] = None) -> str:
        """Write checkpoint ``step``; ``generators`` maps a name to a
        ``Generator.get_state()`` (or a stack of them).  Returns its
        directory.  Every rank calls it: rank 0 writes, and all return
        once the checkpoint is whole on disk."""
        if model_size() == 1:
            if world_rank() == 0:
                self._write(state.state_dict(), step, generators)
        elif data_rank() == 0 and seq_rank() == 0:
            # rank 0's model group: every rank's slices go to rank 0
            local = _to_cpu(state.state_dict())
            shards = [None] * model_size() if model_rank() == 0 else None
            dist.gather_object(local, shards, dst=model_src(),
                               group=model_group())
            if world_rank() == 0:
                self._write(gather_train_state(
                    shards, state.names, state.model.tp_full_shapes),
                    step, generators)
        barrier()
        return self._path(step)

    def _write(self, sd: Dict, step: int,
               generators: Optional[Dict[str, torch.Tensor]]) -> None:
        tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=self._dir)
        try:
            torch.save({"state": sd, "step": int(step),
                        "generators": generators or {}},
                       os.path.join(tmp, "state.pt"))
            final = self._path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def read_model_state(self, step: Optional[int] = None, ema: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor], int]:
        """The model's ``state_dict`` at checkpoint ``step`` (default: the
        latest) for inference, and the step: the trained parameters, or
        with ``ema`` their moving average (under the model's names, with
        the model's buffers).  The file is mapped on the CPU
        (``mmap=True``), so the optimizer's moments are never read and no
        tensor reaches a card until the caller loads it into a model.
        Raises ``LookupError`` when ``ema`` is asked of a checkpoint
        trained without one."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        sd = torch.load(os.path.join(self._path(step), "state.pt"),
                        map_location="cpu", mmap=True,
                        weights_only=True)["state"]
        model = sd["model"]
        if ema:
            avg = sd.get("ema")
            if avg is None:
                raise LookupError(f"checkpoint step {step} in {self._dir} "
                                  "has no EMA")
            model = {k: avg.get(k, v) for k, v in model.items()}
        return model, step

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Load checkpoint ``step`` (default: the latest) into ``state``;
        returns ``(step, generator states)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        sharded = model_size() > 1
        device = ("cpu" if sharded
                  else next(state.model.parameters()).device)
        ckpt = torch.load(os.path.join(self._path(step), "state.pt"),
                          map_location=device, weights_only=False)
        sd = ckpt["state"]
        if sharded:
            sd = shard_train_state(sd, state.names, model_rank(),
                                   model_size())
        state.load_state_dict(sd)
        return int(ckpt["step"]), ckpt["generators"]


def _to_cpu(obj):
    """``obj`` (nested dicts and lists of tensors) with every tensor on
    the CPU, for a pickled send."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
