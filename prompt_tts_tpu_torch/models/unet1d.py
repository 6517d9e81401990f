"""Conditional 1-D UNet denoiser, channels-last at its public functions.

Port of ``prompt_tts_tpu/models/unet1d.py`` for the default block types.
Submodules carry the JAX param tree's names (``down_0/resnet_1/conv1/conv``,
``mid/attn_0/block_0/attn2/to_k``, ...).

Parity quirks kept from the JAX package (and its reference):
* cross-attention over padded text is UNMASKED;
* the spatial transformer applies ``proj_in`` but not ``proj_out``;
* in UNet blocks ``unet_num_heads`` is the NUMBER of heads, head_dim =
  channels / heads.

The optional variants (fourier time embedding, class embeddings,
conv-transpose upsample, avg-pool downsample) are not ported and raise.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.models.embeddings import (
    TimestepEmbedding, timestep_embedding,
)
from prompt_tts_tpu_torch.models.layers import (
    Conv1d, Dense, GroupNorm, TransformerBlock,
)

# {block: {attn: [(k, v) per transformer layer]}}, k/v [B, S, H, D]
CrossKV = Dict[str, Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]]


def _nearest_resize(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Nearest resize along T of ``[B, T, C]`` (torch ``interpolate``
    semantics, ``src = floor(i * Tin / Tout)``); 113 -> 225 is not 2x."""
    t_in = x.shape[1]
    if t_in == target_len:
        return x
    if target_len == 2 * t_in:
        return x.repeat_interleave(2, dim=1)
    idx = (torch.arange(target_len, device=x.device) * t_in) // target_len
    return x[:, idx, :]


class ResnetBlock1D(nn.Module):
    """GN -> SiLU -> conv3 -> +temb -> GN -> SiLU -> dropout -> conv3 ->
    +shortcut."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, eps: float = 1e-5, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.norm1 = GroupNorm(groups, in_channels, eps, device=device)
        self.conv1 = Conv1d(in_channels, out_channels, 3, device=device)
        self.time_emb_proj = Dense(temb_dim, out_channels, device=device)
        self.norm2 = GroupNorm(groups, out_channels, eps, device=device)
        self.conv2 = Conv1d(out_channels, out_channels, 3, device=device)
        if in_channels != out_channels:
            self.conv_shortcut = Conv1d(in_channels, out_channels, 1,
                                        padding=0, device=device)
        else:
            self.conv_shortcut = None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, :]
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample1D(nn.Module):
    """Strided conv downsample (k3, s2, pad1)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, stride=2, padding=1,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1D(nn.Module):
    """Nearest resize to the skip's length + conv k3."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, device=device)

    def forward(self, x: torch.Tensor, target_len: int) -> torch.Tensor:
        return self.conv(_nearest_resize(x, target_len))


class SpatialTransformer1D(nn.Module):
    """GroupNorm(eps 1e-6) -> proj_in -> transformer block -> +residual
    (no ``proj_out``: the reference's quirk)."""

    def __init__(self, channels: int, num_heads: int,
                 cross_attention_dim: int, groups: int = 32,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6, device=device)
        self.proj_in = Dense(channels, channels, device=device)
        self.block_0 = TransformerBlock(channels, num_heads,
                                        channels // num_heads,
                                        cross_attention_dim, dropout=dropout,
                                        device=device)

    def forward(self, x, context, cross_kv=None):
        # cross_kv: [(k, v)], one entry per transformer layer (here one)
        h = self.block_0(self.proj_in(self.norm(x)), context=context,
                         cross_kv=None if cross_kv is None else cross_kv[0])
        return h + x


class _Block(nn.Module):
    """One down or up block of the UNet: ``resnet_i`` (+ ``attn_i``) layers
    and an optional ``downsample`` / ``upsample``."""

    def __init__(self, resnet_in: List[int], out_channels: int, temb_dim: int,
                 cross: bool, cfg: ModelConfig, resample: Optional[str],
                 device=None):
        super().__init__()
        self.num_layers = len(resnet_in)
        self.cross = cross
        g = cfg.norm_num_groups
        for i, cin in enumerate(resnet_in):
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                cin, out_channels, temb_dim, g, cfg.norm_eps, cfg.dropout,
                device=device))
            if cross:
                self.add_module(f"attn_{i}", SpatialTransformer1D(
                    out_channels, cfg.unet_num_heads,
                    cfg.cross_attention_dim, g, cfg.dropout, device=device))
        if resample == "down":
            self.downsample = Downsample1D(out_channels, device=device)
        elif resample == "up":
            self.upsample = Upsample1D(out_channels, device=device)

    def _layer(self, i, x, temb, context, cross_kv):
        x = getattr(self, f"resnet_{i}")(x, temb)
        if self.cross:
            x = getattr(self, f"attn_{i}")(
                x, context,
                cross_kv=None if cross_kv is None else cross_kv[f"attn_{i}"])
        return x

    def down(self, x, temb, context, cross_kv=None):
        skips = []
        for i in range(self.num_layers):
            x = self._layer(i, x, temb, context, cross_kv)
            skips.append(x)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
            skips.append(x)
        return x, skips

    def up(self, x, skips, temb, context, target_len, cross_kv=None):
        for i in range(self.num_layers):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = self._layer(i, x, temb, context, cross_kv)
        if hasattr(self, "upsample"):
            x = self.upsample(x, target_len)
        return x


class MidBlock1DCrossAttn(nn.Module):
    """resnet -> transformer -> resnet."""

    def __init__(self, channels: int, temb_dim: int, cfg: ModelConfig,
                 device=None):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnet_0 = ResnetBlock1D(channels, channels, temb_dim, g,
                                      cfg.norm_eps, cfg.dropout, device=device)
        self.attn_0 = SpatialTransformer1D(
            channels, cfg.unet_num_heads, cfg.cross_attention_dim, g,
            cfg.dropout, device=device)
        self.resnet_1 = ResnetBlock1D(channels, channels, temb_dim, g,
                                      cfg.norm_eps, cfg.dropout, device=device)

    def forward(self, x, temb, context, cross_kv=None):
        x = self.resnet_0(x, temb)
        kv = None if cross_kv is None else cross_kv["attn_0"]
        x = self.attn_0(x, context, cross_kv=kv)
        return self.resnet_1(x, temb)


def _check_supported(cfg: ModelConfig) -> None:
    unported = {
        "time_embedding_type='fourier'": (cfg.time_embedding_type
                                          != "positional"),
        "class embeddings": (cfg.class_embed_type is not None
                             or bool(cfg.num_class_embeds)),
        "upsample_conv_transpose": cfg.upsample_conv_transpose,
        "downsample_avg_pool": cfg.downsample_avg_pool,
    }
    for name, used in unported.items():
        if used:
            raise NotImplementedError(f"UNet option {name} is not ported")
    for bt in cfg.down_block_types:
        if bt not in ("CrossAttnDownBlock1D", "DownBlock1D"):
            raise ValueError(f"unknown down block {bt}")
    for bt in cfg.up_block_types:
        if bt not in ("CrossAttnUpBlock1D", "UpBlock1D"):
            raise ValueError(f"unknown up block {bt}")
    if cfg.mid_block_type not in (None, "UNetMidBlock1DCrossAttn"):
        raise ValueError(f"unknown mid block {cfg.mid_block_type}")


class UNet1DCondition(nn.Module):
    """The conditional denoiser eps_hat(x_t, t, text_context).

    ``sample`` ``[B, T, in_channels]`` -> ``[B, T, out_channels]``;
    ``context`` is the text encoder output ``[B, S, cross_attention_dim]``.
    """

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        chans = cfg.block_out_channels
        n = len(chans)
        temb_dim = chans[0] * 4
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim,
                                                device=device)
        self.conv_in = Conv1d(cfg.in_channels, chans[0], 3, device=device)

        skip_ch = [chans[0]]
        c = chans[0]
        for i, bt in enumerate(cfg.down_block_types):
            final = i == n - 1
            resnet_in = [c] + [chans[i]] * (cfg.layers_per_block - 1)
            self.add_module(f"down_{i}", _Block(
                resnet_in, chans[i], temb_dim, bt == "CrossAttnDownBlock1D",
                cfg, None if final else "down", device=device))
            skip_ch += [chans[i]] * (cfg.layers_per_block + (not final))
            c = chans[i]
        self.mid = None
        if cfg.mid_block_type == "UNetMidBlock1DCrossAttn":
            self.mid = MidBlock1DCrossAttn(c, temb_dim, cfg, device=device)

        rev = list(reversed(chans))
        for i, bt in enumerate(cfg.up_block_types):
            final = i == n - 1
            resnet_in = []
            for _ in range(cfg.layers_per_block + 1):
                resnet_in.append(c + skip_ch.pop())
                c = rev[i]
            self.add_module(f"up_{i}", _Block(
                resnet_in, rev[i], temb_dim, bt == "CrossAttnUpBlock1D",
                cfg, None if final else "up", device=device))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[0],
                                       cfg.norm_eps, device=device)
        self.conv_out = Conv1d(chans[0], cfg.out_channels, 3, device=device)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor],
                cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
        cfg = self.config
        ckv = cross_kv if cross_kv is not None else {}
        n = len(cfg.block_out_channels)
        t_feat = timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift)
        temb = self.time_embedding(t_feat)

        x = self.conv_in(sample)
        skips = [x]
        for i in range(n):
            x, new = getattr(self, f"down_{i}").down(
                x, temb, context, ckv.get(f"down_{i}"))
            skips.extend(new)
        if self.mid is not None:
            x = self.mid(x, temb, context, ckv.get("mid"))

        # each up block consumes layers_per_block+1 skips and upsamples to
        # the length of the next skip to be consumed
        up_layers = cfg.layers_per_block + 1
        for i in range(n):
            rest = len(skips) - up_layers
            target = skips[rest - 1].shape[1] if rest > 0 else x.shape[1]
            x = getattr(self, f"up_{i}").up(x, skips, temb, context, target,
                                            ckv.get(f"up_{i}"))
        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)


def cross_attn_sites(cfg: ModelConfig):
    """Yield ``(block_name, attn_name, n_transformer_layers)`` for every
    cross-attention transformer in the UNet, in forward order."""
    for i, bt in enumerate(cfg.down_block_types):
        if bt == "CrossAttnDownBlock1D":
            for l in range(cfg.layers_per_block):
                yield f"down_{i}", f"attn_{l}", 1
    if cfg.mid_block_type == "UNetMidBlock1DCrossAttn":
        yield "mid", "attn_0", 1
    for i, bt in enumerate(cfg.up_block_types):
        if bt == "CrossAttnUpBlock1D":
            for l in range(cfg.layers_per_block + 1):
                yield f"up_{i}", f"attn_{l}", 1


def cross_attention_kv(unet: UNet1DCondition,
                       context: torch.Tensor) -> CrossKV:
    """Precompute every cross-attention (k, v) for a fixed ``context``.

    The sampler's context is loop-invariant, so the ``to_k``/``to_v``
    projections run once per utterance instead of once per step.  Same
    math as the in-call path: the same weights, in the compute dtype.
    """
    B, S, _ = context.shape
    H = unet.config.unet_num_heads
    out: CrossKV = {}
    for block, attn, n_layers in cross_attn_sites(unet.config):
        st = getattr(getattr(unet, block), attn)
        layers = []
        for l in range(n_layers):
            a = getattr(st, f"block_{l}").attn2
            layers.append(tuple(
                lin(context).reshape(B, S, H, -1) for lin in (a.to_k, a.to_v)))
        out.setdefault(block, {})[attn] = layers
    return out
