"""Noise schedule and the forward (noising) process.

Port of ``prompt_tts_tpu/diffusion/schedule.py``: DDPM with 1000 train
steps and the diffusers linear beta schedule (1e-4 .. 0.02), as f32 tables.
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
    acp = schedule.alphas_cumprod[t]
    acp = acp.reshape(acp.shape + (1,) * (x0.dim() - acp.dim()))
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise
