"""Ancestral DDPM sampler (the full-length reverse process) as a Python loop.

Port of ``prompt_tts_tpu/diffusion/ddpm.py``: the epsilon-parameterised
posterior step with the "fixed small" variance ``beta_t (1 - acp_{t-1}) /
(1 - acp_t)``, clamped at 1e-20, and no noise at t = 0 (diffusers
``DDPMScheduler`` defaults, which the reference trains against).  The
per-step coefficients are computed once on the host in f64 from the
schedule's f32 tables, rounded to f32 and uploaded in one copy; the loop
indexes them by a Python ``int``, so its T steps make no host sync.  The
state x stays f32 whatever the denoiser's dtype.
"""

from typing import Optional

import numpy as np
import torch

from prompt_tts_tpu_torch.diffusion.ddim import DenoiseFn
from prompt_tts_tpu_torch.diffusion.schedule import DiffusionSchedule


def ddpm_tables(schedule: DiffusionSchedule) -> np.ndarray:
    """``[5, T]`` f32 rows indexed by t: ``sqrt(1 - acp_t)``,
    ``sqrt(acp_t)``, the posterior mean's x0 and x_t coefficients (Ho et
    al. 2020, eq. 7) and the noise scale ``sqrt(max(var_t, 1e-20))`` (0 at
    t = 0), computed in f64."""
    acp = schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
    alphas = schedule.alphas.cpu().numpy().astype(np.float64)
    betas = schedule.betas.cpu().numpy().astype(np.float64)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    coef_x0 = np.sqrt(acp_prev) * betas / (1.0 - acp)
    coef_xt = np.sqrt(alphas) * (1.0 - acp_prev) / (1.0 - acp)
    var = betas * (1.0 - acp_prev) / (1.0 - acp)
    sigma = np.sqrt(np.maximum(var, 1e-20))
    sigma[0] = 0.0
    return np.stack([np.sqrt(1.0 - acp), np.sqrt(acp), coef_x0, coef_xt,
                     sigma]).astype(np.float32)


def ddpm_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                x_T: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                clip_sample: bool = True,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full T-step ancestral sampling from the noise ``x_T``.

    Step i runs at t = T-1-i and adds ``noise[i]`` (``noise``: ``[T,
    *x_T.shape]``, e.g. another implementation's draws) or a draw from
    ``generator`` (the device's default generator when None).
    ``clip_sample`` clamps the x0 estimate to [-1, 1].
    """
    T = schedule.num_train_timesteps
    dev = x_T.device
    if noise is not None and tuple(noise.shape) != (T, *x_T.shape):
        raise ValueError(f"ddpm_sample: noise shape {tuple(noise.shape)} "
                         f"!= {(T, *x_T.shape)}")
    tables = torch.from_numpy(ddpm_tables(schedule))
    if dev.type == "cuda":      # one upload, without a stream sync
        tables = tables.pin_memory().to(dev, non_blocking=True)
    s_eps, s_x0, c_x0, c_xt, sigma = tables.to(dev)
    x = x_T.float()
    for i in range(T):
        t = T - 1 - i
        t_batch = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
        eps = denoise_fn(x, t_batch).float()
        x0 = (x - s_eps[t] * eps) / s_x0[t]
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        x = c_x0[t] * x0 + c_xt[t] * x
        if t > 0:
            z = noise[i].to(dev) if noise is not None else torch.randn(
                x.shape, generator=generator, device=dev, dtype=x.dtype)
            x = x + sigma[t] * z
    return x
