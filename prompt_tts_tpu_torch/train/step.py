"""The training step: DDPM noise, ε-MSE, backward, clip+AdamW.

Port of ``prompt_tts_tpu/train/step.py`` (reference train.py:86-120).  The
JAX step is one jitted program; here it runs eagerly on the model's device:
draw per-example noise, timesteps and (with classifier-free guidance
training) the condition drop from an explicit ``torch.Generator``, run the
forward process, predict ε with dropout on, take the MSE in f32, backward
(through the attention-backward kernel on the card), then
:meth:`TrainState.apply_gradients`.  Dropout draws from the device's
default generator, which the checkpoint saves beside the step's own.

Both families: a batch with a ``prompt`` key (the prompt-conditioned
family's voice-prompt latents) passes it to the model, and the condition
drop nulls the text and the prompt together.  For parity tests the noise,
timesteps and drop can be passed in instead of drawn.  ``--remat`` and the
``rbg`` dropout stream are not ported.
"""

from typing import Callable, Dict, Optional

import torch
from torch import nn

from prompt_tts_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, add_noise,
)
from prompt_tts_tpu_torch.train.state import TrainState


def _draw(codes: torch.Tensor, num_train_timesteps: int,
          generator: Optional[torch.Generator], noise, timesteps):
    B = codes.shape[0]
    if noise is None:
        noise = torch.randn(codes.shape, generator=generator,
                            device=codes.device, dtype=codes.dtype)
    if timesteps is None:
        timesteps = torch.randint(0, num_train_timesteps, (B,),
                                  generator=generator, device=codes.device)
    return noise, timesteps


def _mse(pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - noise.float()) ** 2)


def _condition(batch: Dict[str, torch.Tensor]):
    """The model's conditioning inputs of a batch: ids and mask, and the
    prompt latents when the batch has them (the prompt family)."""
    cond = (batch["text_ids"], batch["text_mask"])
    if "prompt" in batch:
        cond = cond + (batch["prompt"],)
    return cond


def make_loss_fn(model: nn.Module, schedule: DiffusionSchedule,
                 cond_dropout_prob: float = 0.0) -> Callable:
    """The DDPM ε-MSE over one batch: ``codes [B,T,C]`` in [-1, 1],
    ``text_ids [B,S]``, ``text_mask [B,S]`` and, for the prompt family,
    ``prompt [B,Tp,C]``.  ``cond_dropout_prob`` > 0 nulls the conditioning
    of each sample with that probability (classifier-free guidance
    training): zero ids, an all-zero mask and zero prompt latents, the
    null branch the sampler's guidance pairs against.

    ``loss_fn(batch, generator, noise=None, timesteps=None, drop=None)``
    draws noise, then timesteps, then the drop from ``generator``, unless
    they are given.
    """
    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = batch["codes"]
        noise, timesteps = _draw(codes, schedule.num_train_timesteps,
                                 generator, noise, timesteps)
        noisy = add_noise(schedule, codes, noise, timesteps)
        cond = _condition(batch)
        if cond_dropout_prob > 0.0:
            if drop is None:
                drop = torch.rand((codes.shape[0], 1), generator=generator,
                                  device=codes.device) < cond_dropout_prob
            # [B, 1] broadcasts over ids and mask [B, S]; the prompt
            # [B, Tp, C] takes it as [B, 1, 1]
            cond = tuple(torch.where(drop.view(-1, *[1] * (c.dim() - 1)),
                                     torch.zeros_like(c), c) for c in cond)
        pred = model(noisy, timesteps, *cond)
        return _mse(pred, noise)

    return loss_fn


def make_train_step(state: TrainState, schedule: DiffusionSchedule,
                    cond_dropout_prob: float = 0.0) -> Callable:
    """``train_step(batch, generator, **inputs) -> {"loss", "grad_norm"}``
    (device scalars: reading them is the host sync).  ``inputs`` are the
    loss function's ``noise`` / ``timesteps`` / ``drop``."""
    loss_fn = make_loss_fn(state.model, schedule, cond_dropout_prob)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   **inputs) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss = loss_fn(batch, generator, **inputs)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_eval_step(model: nn.Module, schedule: DiffusionSchedule):
    """Deterministic eval loss (dropout off): noise and timesteps from the
    caller's ``generator``, so a fixed seed gives comparable losses."""
    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        model.eval()
        codes = batch["codes"]
        noise, timesteps = _draw(codes, schedule.num_train_timesteps,
                                 generator, noise, timesteps)
        noisy = add_noise(schedule, codes, noise, timesteps)
        return _mse(model(noisy, timesteps, *_condition(batch)), noise)
    return eval_step


def make_eval_step_at(model: nn.Module, schedule: DiffusionSchedule):
    """The eval loss with every example noised to the caller's timestep
    ``t``: a grid of ``t`` shows where on the noise schedule a model is
    weak."""
    step = make_eval_step(model, schedule)

    def eval_step(batch: Dict[str, torch.Tensor], generator, t: int,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = batch["codes"]
        ts = torch.full((codes.shape[0],), int(t), dtype=torch.long,
                        device=codes.device)
        return step(batch, generator, noise=noise, timesteps=ts)
    return eval_step
