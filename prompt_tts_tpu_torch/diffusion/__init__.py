"""Diffusion math: the linear schedule and the DDIM, DPM-Solver++(2M) and
ancestral DDPM samplers, each sampler step a function of its own."""

from prompt_tts_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, add_noise, linear_schedule, velocity_target,
)

__all__ = ["DiffusionSchedule", "add_noise", "linear_schedule",
           "velocity_target"]
