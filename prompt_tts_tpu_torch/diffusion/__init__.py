"""Diffusion math: the linear schedule and the DDIM sampler."""
