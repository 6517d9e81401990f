"""Embedding primitives: sinusoidal timestep features and positional tables.

Port of ``prompt_tts_tpu/models/embeddings.py`` (diffusers ``Timesteps`` /
``TimestepEmbedding`` semantics, and the reference's transposed sinusoidal
positional table), and the random-Fourier timestep features of the
UNet's optional ``time_embedding_type="fourier"``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.models.layers import Dense


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features of timesteps ``[B]`` -> ``[B, dim]`` float32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, time_embed_dim: int, device=None):
        super().__init__()
        self.linear_1 = Dense(in_dim, time_embed_dim, device=device)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim, device=device)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GaussianFourierProjection(nn.Module):
    """Random-Fourier timestep features (diffusers-0.15
    ``GaussianFourierProjection(embedding_size, set_W_to_weight=False,
    log=False, flip_sin_to_cos=...)``): ``[B] -> [B, 2 * embedding_size]``,
    ``[cos|sin]`` (or ``[sin|cos]``) of ``2 pi t w``.

    ``weight ~ N(0, scale^2)`` is frozen, as torch registers it
    (``requires_grad=False``): here a buffer, so it is outside the
    optimizer, its weight decay, the gradient clip's norm and the EMA, and
    it is saved with the model's state.  The phases reach thousands of
    radians (t <= 999, |w| ~ 1), so they are computed in f32 whatever the
    model computes in, in the JAX module's order (``t * w * 2 pi``), and
    only the cos/sin leave in the caller's dtype.
    """

    def __init__(self, embedding_size: int, scale: float = 1.0,
                 flip_sin_to_cos: bool = True, device=None):
        super().__init__()
        self.scale = scale
        self.flip_sin_to_cos = flip_sin_to_cos
        self.register_buffer("weight", torch.zeros(embedding_size,
                                                   device=device))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x_proj = t.float()[:, None] * self.weight.float()[None, :] * (
            2 * math.pi)
        if self.flip_sin_to_cos:
            return torch.cat([torch.cos(x_proj), torch.sin(x_proj)], dim=-1)
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def transposed_positional_encoding(seq_len: int, dim: int) -> np.ndarray:
    """The reference TextEncoder's positional table, ``[seq_len, dim]``.

    Copied from prompt_tts_tpu/models/embeddings.py:94-120 (the JAX module
    imports flax).  Frequencies run over the SEQUENCE axis and positions
    over the EMBEDDING axis — deliberately transposed, kept for parity:

      table[s, d] = sin(d * inv_freq[s//2])  if s even
                    cos(d * inv_freq[s//2])  if s odd
      inv_freq[k] = 1 / 10000^(2k / ceil2(seq_len))
    """
    channels = int(np.ceil(seq_len / 2) * 2)
    inv_freq = 1.0 / (
        10000.0 ** (np.arange(0, channels, 2, dtype=np.float32) / channels)
    )
    pos = np.arange(dim, dtype=np.float32)
    sin_inp = np.einsum("i,j->ij", pos, inv_freq)
    emb = np.stack([np.sin(sin_inp), np.cos(sin_inp)], axis=-1)
    emb = emb.reshape(dim, channels)
    return np.ascontiguousarray(emb[:, :seq_len].T)
