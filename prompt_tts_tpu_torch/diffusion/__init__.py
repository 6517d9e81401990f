"""Diffusion math: the linear schedule and the DDIM, DPM-Solver++(2M) and
ancestral DDPM samplers, each sampler step a function of its own."""
