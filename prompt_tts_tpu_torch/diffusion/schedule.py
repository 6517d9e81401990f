"""Noise schedule and the forward (noising) process.

Port of ``prompt_tts_tpu/diffusion/schedule.py``: DDPM with 1000 train
steps and the diffusers linear beta schedule (1e-4 .. 0.02), as f32 tables;
the v-prediction target, the x0 prediction from eps, and the SNR.
"""

from typing import NamedTuple

import torch


class DiffusionSchedule(NamedTuple):
    """Precomputed schedule tables (f32, length ``num_train_timesteps``)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]


def linear_schedule(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02, device=None) -> DiffusionSchedule:
    """The diffusers-compatible linear beta schedule."""
    betas = torch.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=torch.float32, device=device)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas=betas, alphas=alphas,
                             alphas_cumprod=torch.cumprod(alphas, dim=0))


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor,
              noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward process ``x_t = sqrt(acp_t) x0 + sqrt(1-acp_t) eps`` with
    per-sample integer ``t`` ``[B]``."""
    acp = _at(schedule, t, x0.dim())
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def _at(schedule: DiffusionSchedule, t: torch.Tensor,
        ndim: int) -> torch.Tensor:
    """``alphas_cumprod[t]`` shaped to broadcast over a ``ndim``-dim
    tensor whose leading dim is ``t``'s."""
    acp = schedule.alphas_cumprod[t]
    return acp.reshape(acp.shape + (1,) * (ndim - acp.dim()))


def velocity_target(schedule: DiffusionSchedule, x0: torch.Tensor,
                    noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The v-prediction target ``v = sqrt(acp) eps - sqrt(1-acp) x0``
    (not the reference's objective, which predicts eps; part of the
    diffusion surface, as in the JAX package)."""
    acp = _at(schedule, t, x0.dim())
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0


def predict_x0_from_eps(schedule: DiffusionSchedule, x_t: torch.Tensor,
                        eps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The forward process inverted: ``x0 = (x_t - sqrt(1-acp) eps) /
    sqrt(acp)``."""
    acp = _at(schedule, t, x_t.dim())
    return (x_t - torch.sqrt(1.0 - acp) * eps) / torch.sqrt(acp)


def snr(schedule: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """The signal-to-noise ratio ``acp / (1 - acp)`` at timestep(s) ``t``."""
    acp = schedule.alphas_cumprod[t]
    return acp / (1.0 - acp)
