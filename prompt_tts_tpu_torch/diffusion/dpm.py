"""DPM-Solver++(2M) sampler as a fixed-shape loop over the denoiser.

Port of ``prompt_tts_tpu/diffusion/dpm.py`` (Lu et al. 2022): the
second-order multistep solver in its x0-prediction form, diffusers
``DPMSolverMultistepScheduler(algorithm_type="dpmsolver++", solver_order=2,
lower_order_final=True)`` semantics: "leading" timestep spacing, first-order
first and final steps.  The per-step coefficients are computed on the host
in f64 (lambda loses precision in f32), including the final step where
lambda = +inf, and uploaded once as f32 tensors; the loop body is tensor
math at static shapes with no host sync between steps.  The state x stays
f32 whatever the denoiser's dtype.
"""

import numpy as np
import torch

from prompt_tts_tpu_torch.diffusion.ddim import DenoiseFn
from prompt_tts_tpu_torch.diffusion.schedule import DiffusionSchedule


def dpm_tables(alphas_cumprod: np.ndarray, num_inference_steps: int):
    """``(ts, c_x, c_d, ext)``: descending int timesteps and the f64
    coefficients of step i, ``x_next = c_x x + c_d ((1 + ext) x0 - ext
    x0_prev)`` (prompt_tts_tpu/diffusion/dpm.py:53-82)."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    N = int(num_inference_steps)
    ts = (np.arange(N) * (acp.shape[0] // N))[::-1].astype(np.int64)
    alpha = np.sqrt(acp[ts])
    sigma = np.sqrt(1.0 - acp[ts])
    lam = np.log(alpha) - np.log(sigma)
    # step i moves t_i -> t_{i+1}; the last lands on the clean manifold
    # (alpha = 1, sigma = 0, lambda = +inf)
    alpha_prev = np.concatenate([alpha[1:], [1.0]])
    sigma_prev = np.concatenate([sigma[1:], [0.0]])
    lam_prev = np.concatenate([lam[1:], [np.inf]])
    h = lam_prev - lam
    c_x = np.where(sigma > 0, sigma_prev / np.maximum(sigma, 1e-30), 0.0)
    c_d = -alpha_prev * np.expm1(-h)          # expm1(-inf) = -1: finite
    c_d = np.where(np.isfinite(c_d), c_d, alpha_prev)
    h_last = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid="ignore", divide="ignore"):
        r = h_last / h
    second = np.ones(N, dtype=bool)
    second[0] = second[-1] = False            # no history; lower_order_final
    r = np.where(second, r, 1.0)
    ext = np.where(second, 1.0 / (2.0 * r), 0.0)
    return ts, c_x, c_d, ext


def dpm_solver_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                      x_T: torch.Tensor, num_inference_steps: int = 25,
                      clip_sample: bool = True) -> torch.Tensor:
    """Run DPM-Solver++(2M) from the noise ``x_T`` to a sample;
    ``clip_sample`` clamps the x0 estimate to [-1, 1], where the code
    latents live."""
    ts, c_x, c_d, ext = dpm_tables(schedule.alphas_cumprod.cpu().numpy(),
                                   num_inference_steps)
    dev = x_T.device
    coef = torch.from_numpy(np.stack([c_x, c_d, ext])).to(
        device=dev, dtype=torch.float32)            # one upload, [3, N]
    acp = schedule.alphas_cumprod.to(dev)
    x = x_T.float()
    x0_prev = torch.zeros_like(x)
    for i, t in enumerate(ts.tolist()):
        t_batch = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
        eps = denoise_fn(x, t_batch).float()
        acp_t = acp[t]
        x0 = (x - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        cx, cd, ex = coef[0, i], coef[1, i], coef[2, i]
        d = (1.0 + ex) * x0 - ex * x0_prev
        x = cx * x + cd * d
        x0_prev = x0
    return x
