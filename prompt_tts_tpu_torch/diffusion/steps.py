"""The samplers as a step program run over per-step tables.

A synthesis runs one step program per sampler step (``pipeline.
StepProgram``, or the same program exported by ``aot.py``); the loop here
feeds it each step's timestep and table row.  The live ``Synthesizer`` and
a loaded artifact both run :func:`run_steps`, so their arithmetic is one.
"""

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from prompt_tts_tpu_torch.diffusion.ddim import ddim_tables
from prompt_tts_tpu_torch.diffusion.dpm import dpm_step_tables

SAMPLERS = ("ddim", "dpm")


def sampler_tables(sampler: str, alphas_cumprod: np.ndarray,
                   num_inference_steps: int) -> Tuple[List[int], np.ndarray]:
    """``(ts, coef)``: the sampler's descending timesteps and each step's
    f32 table row, DDIM (``acp_t``, ``acp_prev``) or DPM-Solver++(2M)
    (``acp_t``, ``c_x``, ``c_d``, ``ext``)."""
    if sampler == "ddim":
        return ddim_tables(alphas_cumprod, num_inference_steps)
    if sampler == "dpm":
        return dpm_step_tables(alphas_cumprod, num_inference_steps)
    raise ValueError(f"unknown sampler {sampler!r}")


def initial_noise(seed: int, shape: Sequence[int]) -> torch.Tensor:
    """x_T for ``seed``, drawn on a CPU generator, so one seed gives the
    same x_T on every device."""
    return torch.randn(tuple(shape),
                       generator=torch.Generator().manual_seed(seed))


def run_steps(step: Callable, cond: tuple, x_T: torch.Tensor,
              ts: Sequence[int], coef: torch.Tensor,
              sampler: str) -> torch.Tensor:
    """The sampler from ``x_T``: ``state = step(t, coef[i], cond, state)``
    for each step i at timestep ``ts[i]`` (``t`` an int64 ``[B]``), the
    state ``(x,)`` for DDIM and ``(x, x0_prev)`` for DPM, f32, the x0
    estimate of no step before the first being zero.  Returns x."""
    x = x_T.float()
    state = (x, torch.zeros_like(x)) if sampler == "dpm" else (x,)
    for i, t in enumerate(ts):
        t_batch = torch.full((x.shape[0],), t, dtype=torch.long,
                             device=x.device)
        state = step(t_batch, coef[i], cond, state)
    return state[0]
