"""DDIM sampler as a plain Python loop over the denoiser.

Port of ``prompt_tts_tpu/diffusion/ddim.py``: the DDIM update (Song et al.
2020) with diffusers "leading" timestep spacing and ``clip_sample``.  The
state x stays f32 whatever the denoiser's dtype; eps is cast to f32.
One update is :func:`ddim_step`, on the step's table entries
(:func:`ddim_tables`), which the loop here, ``Synthesizer``'s step program
and an exported step program (``aot.py``) all call.
"""

from typing import Callable, List, Optional

import numpy as np
import torch

from prompt_tts_tpu_torch.diffusion.schedule import DiffusionSchedule

# denoise_fn(x_t [B,...] f32, t [B] int64) -> eps_hat [B,...]
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_timesteps(num_train_timesteps: int,
                   num_inference_steps: int) -> List[int]:
    """Descending timestep sequence (diffusers 0.15 "leading" spacing)."""
    step_ratio = num_train_timesteps // num_inference_steps
    return [i * step_ratio for i in range(num_inference_steps)][::-1]


def ddim_tables(alphas_cumprod: np.ndarray, num_inference_steps: int):
    """``(ts, coef)``: the descending timesteps and each step's f32 table
    entries ``coef [N, 2]`` = (``acp_t``, ``acp_prev``), ``acp_prev`` 1 past
    the first train step."""
    acp = np.asarray(alphas_cumprod, dtype=np.float32)
    T = acp.shape[0]
    ts = ddim_timesteps(T, num_inference_steps)
    ratio = T // num_inference_steps
    coef = np.array([(acp[t], acp[t - ratio] if t - ratio >= 0 else 1.0)
                     for t in ts], dtype=np.float32)
    return ts, coef


def ddim_step(x: torch.Tensor, eps: torch.Tensor, acp_t: torch.Tensor,
              acp_prev: torch.Tensor, clip_sample: bool = True,
              sigma=0.0) -> torch.Tensor:
    """One DDIM update of the f32 state ``x`` from the f32 ``eps`` at
    ``acp_t`` to ``acp_prev`` (0-d tensors), without the noise term of
    ``eta > 0`` (``sigma`` its scale)."""
    x0 = (x - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    # re-derive eps from the (possibly clipped) x0, as diffusers does
    eps_dir = (x - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
    dir_xt = torch.sqrt(1.0 - acp_prev - sigma ** 2) * eps_dir
    return torch.sqrt(acp_prev) * x0 + dir_xt


def ddim_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                x_T: torch.Tensor, num_inference_steps: int = 50,
                eta: float = 0.0, clip_sample: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run DDIM from the noise ``x_T`` to a sample.

    ``clip_sample`` clamps the x0 estimate to [-1, 1], where the code
    latents live.  ``eta > 0`` draws its noise from ``generator``, which is
    then required.
    """
    if eta > 0.0 and generator is None:
        raise ValueError("eta > 0 requires a torch.Generator")
    T = schedule.num_train_timesteps
    step_ratio = T // num_inference_steps
    acp = schedule.alphas_cumprod.to(x_T.device)
    one = torch.ones((), dtype=torch.float32, device=x_T.device)
    x = x_T.float()
    for t in ddim_timesteps(T, num_inference_steps):
        t_batch = torch.full((x.shape[0],), t, dtype=torch.long,
                             device=x.device)
        eps = denoise_fn(x, t_batch).float()
        acp_t = acp[t]
        prev_t = t - step_ratio
        acp_prev = acp[prev_t] if prev_t >= 0 else one
        sigma = 0.0
        if eta > 0.0:
            var = ((1.0 - acp_prev) / (1.0 - acp_t)
                   * (1.0 - acp_t / acp_prev))
            sigma = eta * torch.sqrt(var)
        x = ddim_step(x, eps, acp_t, acp_prev, clip_sample, sigma)
        if eta > 0.0:
            x = x + sigma * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype)
    return x
