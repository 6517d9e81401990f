"""Shared CLI helpers: the checkpoint restore of the inference entry points,
and the flags of the parallel ones.

Port of ``prompt_tts_tpu/cli/_common.py`` for the port's checkpoints
(``train/checkpoint.py``: ``<ckpt_dir>/step_<N>/state.pt``).  It reads the
model's weights or their EMA, and fails before any model state is loaded
when the requested item cannot exist.  ``cli.train``, ``cli.synthesize``
and ``cli.serve`` share ``--multihost``, ``--tp``, ``--sp`` and
``--backend`` (:func:`add_parallel_args`, :func:`check_parallel_flags`).
"""

import logging
import os
from typing import Dict, Tuple

import torch

log = logging.getLogger(__name__)


def restore_model_state(ckpt_dir: str, cfg, ema: bool = False
                        ) -> Tuple[Dict[str, torch.Tensor], int]:
    """The model's state dict (or with ``ema=True`` its EMA) from the latest
    checkpoint in ``ckpt_dir``, as CPU tensors, and its step.

    Raises ``SystemExit`` with a user-facing message when the directory
    holds no checkpoint, or when ``ema`` is asked of a checkpoint trained
    without ``--ema_decay``.  ``cfg`` is the config the caller builds the
    model from: one that does not fit the checkpoint fails in the caller's
    strict load, which names the keys.
    """
    from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"--ckpt_dir {ckpt_dir}: no such directory")
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"--ckpt_dir {ckpt_dir}: no checkpoint")
    try:
        state, step = mgr.read_model_state(step, ema=ema)
    except LookupError:
        raise SystemExit(
            f"--ema: checkpoint {ckpt_dir} (step {step}) has no "
            "ema_params (train with --ema_decay to produce one)") from None
    log.info("restored checkpoint at step %d%s (%s family)", step,
             " (EMA params)" if ema else "",
             "prompt" if cfg.model.prompt_conditioning else "single-speaker")
    return state, step


def add_parallel_args(p, multihost_help: str) -> None:
    """``--multihost``, ``--tp``, ``--sp`` and ``--backend`` on the parser
    ``p``."""
    p.add_argument("--multihost", action="store_true", help=multihost_help)
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel degree: the ranks of a model "
                        "group (parallel/tp.py; with --multihost, the "
                        "world size a multiple of it).")
    p.add_argument("--sp", type=int, default=1,
                   help="Sequence-parallel degree: the ranks of a seq "
                        "group, over which the UNet's latent time is "
                        "sharded (parallel/sp.py; with --multihost, the "
                        "world size a multiple of --tp x --sp).")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="With --multihost: the process group's backend "
                        "(default NCCL on a card, gloo on the CPU; gloo "
                        "lets ranks share one card).")


def check_parallel_flags(args) -> None:
    """Refuse ``--tp`` or ``--sp`` below 1, or above 1 without
    ``--multihost`` (``SystemExit``)."""
    for flag, n in (("--tp", args.tp), ("--sp", args.sp)):
        if n < 1:
            raise SystemExit(f"{flag} must be >= 1, got {n}")
        if n > 1 and not args.multihost:
            raise SystemExit(f"{flag} > 1 runs over processes: pass "
                             "--multihost (under torchrun or the PTTS_* "
                             "variables)")


def check_one_block(args) -> None:
    """Refuse a world of more than one data row (``SystemExit``): synthesis
    and serving run one model x seq group."""
    from prompt_tts_tpu_torch.parallel import data_size
    if data_size() != 1:
        raise SystemExit(f"--multihost synthesis runs one model x seq "
                         f"group: the world size must be --tp x --sp "
                         f"({args.tp} x {args.sp})")
