"""Conditional 1-D UNet denoiser, channels-last at its public functions.

Port of ``prompt_tts_tpu/models/unet1d.py`` for the default block types.
Submodules carry the JAX param tree's names (``down_0/resnet_1/conv1/conv``,
``mid/attn_0/block_0/attn2/to_k``, ...).

Parity quirks kept from the JAX package (and its reference):
* cross-attention over padded text is UNMASKED;
* the spatial transformer applies ``proj_in`` but not ``proj_out``;
* in UNet blocks ``unet_num_heads`` is the NUMBER of heads, head_dim =
  channels / heads.

``class_emb`` (an already-embedded ``[B, time_embed_dim]`` vector, the
prompt family's speaker embedding) is added to the time embedding.

The reference UNet's optional variants are ported too:
* ``time_embedding_type="fourier"``: frozen random-Fourier features
  (``time_proj``, a buffer) and a ``2 * chans[0]`` time embedding, where the
  default "positional" path has sinusoidal features and ``4 * chans[0]``;
* class embeddings of ``class_labels``, added to the time embedding: the
  ``num_class_embeds`` table, ``"timestep"`` (the labels through the same
  ``time_proj`` first), ``"identity"`` and ``"projection"``.  Flax creates
  ``class_embedding`` only when it is called with labels; the port builds it
  at init whenever the config asks for one;
* ``downsample_avg_pool``: ``AvgPool1d(2, 2)`` in place of the strided conv;
* ``upsample_conv_transpose``: ``ConvTranspose1d(C, C, 4, 2, 1)`` in place of
  nearest resize + conv, exactly 2x (its params ``upsample/{weight,bias}``).

Sequence parallelism (``parallel/sp.py``): with ``seq`` set (by
``parallel.sp.shard_seq_``) the UNet takes the whole sample, keeps this
rank's slice of time, and returns the whole output.  At each call it arms
every level from the whole lengths of that call (:meth:`UNet1DCondition.
arm_seq`): a level whose length divides the group runs sharded (its
layers' ``seq`` set), any other whole on every rank; the down- and
upsamplers gather their input where a sharded level ends and slice their
output where one begins.  A stride-2 downsample of an even slice needs
its left neighbour's last frame only; an odd slice is gathered first, and
a whole level is downsampled whole before the slice.  The target lengths
of the upsamplers are the whole ones.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.models.embeddings import (
    GaussianFourierProjection, TimestepEmbedding, timestep_embedding,
)
from prompt_tts_tpu_torch.models.layers import (
    Conv1d, Dense, Embedding, GroupNorm, TransformerBlock,
)
from prompt_tts_tpu_torch.ops.resnet import resnet_block
from prompt_tts_tpu_torch.parallel import sp

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
    +shortcut, through ``ops/resnet.py:resnet_block`` (the fused kernel on
    the card when no gradient is needed, the module arithmetic otherwise)."""

    # set: the block runs on this rank's slice of time (the module
    # arithmetic, not the kernel; ops/resnet.py)
    seq = None

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
        self.kernel_weights = None     # ops/resnet.py:pack_kernel_weights_

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return resnet_block(self, x, temb)


class _Resample(nn.Module):
    """A down- or upsampler between two levels.  Under sequence parallelism
    ``UNet1DCondition.arm_seq`` arms it (:meth:`arm`) with the group and
    how it crosses (``mode``): "local" (it works on the slices themselves),
    "gather" (it gathers its input: the input level is sharded, the output
    whole), "slice" (it slices its output: the other way round),
    "gather_slice" (both levels sharded, on slices it cannot work on), or
    None (both levels whole)."""

    group = None
    mode = None

    def arm(self, seq, in_sharded: bool, out_sharded: bool,
            local: bool) -> None:
        self.group = seq if in_sharded or out_sharded else None
        self.mode = "local" if local else {
            (True, False): "gather", (False, True): "slice",
            (True, True): "gather_slice"}.get((in_sharded, out_sharded))

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode in ("gather", "gather_slice"):
            return sp.gather_time(x, self.group)
        return x

    def _leave(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode in ("slice", "gather_slice"):
            return sp.slice_time(x, self.group)
        return x


class Downsample1D(_Resample):
    """Strided conv downsample (k3, s2, pad1)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, stride=2, padding=1,
                           device=device)

    def arm(self, seq, in_sharded, out_sharded, local) -> None:
        super().arm(seq, in_sharded, out_sharded, local)
        # the convolution runs before the slice: on slices only when local
        self.conv.seq = seq if local else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._leave(self.conv(self._enter(x)))


class AvgPoolDownsample1D(_Resample):
    """``AvgPool1d(2, 2)`` downsample (the reference's ``use_conv=False``),
    which cannot change the channel count."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[-1] == self.channels, (
            "AvgPool downsample cannot change channels (reference "
            "resnet.py:76 asserts the same)")
        x = self._enter(x)
        return self._leave(
            F.avg_pool1d(x.transpose(1, 2), 2, 2).transpose(1, 2))


class Upsample1D(_Resample):
    """Nearest resize to the skip's length + conv k3."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, device=device)

    def arm(self, seq, in_sharded, out_sharded, local) -> None:
        super().arm(seq, in_sharded, out_sharded, local)
        # the convolution runs after the slice, on the output level
        self.conv.seq = seq if out_sharded else None

    def forward(self, x: torch.Tensor, target_len: int) -> torch.Tensor:
        if self.mode == "local":
            # an exact 2x resize of a slice is the slice of the resize
            target_len //= self.group.size
        x = _nearest_resize(self._enter(x), target_len)
        return self.conv(self._leave(x))


class ConvTransposeUpsample1D(nn.ConvTranspose1d, _Resample):
    """``ConvTranspose1d(C, C, 4, 2, 1)`` upsample on ``[B, T, C]``: exactly
    2x the length, no nearest resize.  Computes in ``compute_dtype`` (the
    weight's dtype when None), input and params cast per call, as
    ``layers.Conv1d``.  The weight is torch's ``[in, out, k]``; the JAX
    kernel ``[k, in, out]`` is applied as a correlation of the 2-dilated
    input with the kernel flipped over k, the same map."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, device=None):
        super().__init__(channels, channels, 4, 2, 1, device=device)

    def forward(self, x: torch.Tensor, target_len: int) -> torch.Tensor:
        # exactly 2x: a sharded input level makes the output level sharded
        # too, so the mode is "local", "slice" or None
        n = self.group.size if self.mode == "local" else 1
        assert target_len == 2 * x.shape[1] * n, (
            "conv-transpose upsample is exactly 2x (reference resnet.py:38 "
            "returns self.conv(x) unconditionally)")
        dt = self.compute_dtype or self.weight.dtype
        if self.mode == "local":
            # a slice of T frames with one of each neighbour's: output
            # frames [2, 2T + 2) of its transpose are the slice's
            T = x.shape[1]
            x = sp.halo(x, self.group, 1, 1)
            y = F.conv_transpose1d(x.to(dt).transpose(1, 2),
                                   self.weight.to(dt), self.bias.to(dt),
                                   stride=2, padding=1)
            return y[:, :, 2:2 * T + 2].transpose(1, 2)
        y = F.conv_transpose1d(x.to(dt).transpose(1, 2), self.weight.to(dt),
                               self.bias.to(dt), stride=2, padding=1)
        return self._leave(y.transpose(1, 2))


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
            self.downsample = (
                AvgPoolDownsample1D(out_channels) if cfg.downsample_avg_pool
                else Downsample1D(out_channels, device=device))
        elif resample == "up":
            self.upsample = (
                ConvTransposeUpsample1D(out_channels, device=device)
                if cfg.upsample_conv_transpose
                else Upsample1D(out_channels, device=device))

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
    for bt in cfg.down_block_types:
        if bt not in ("CrossAttnDownBlock1D", "DownBlock1D"):
            raise ValueError(f"unknown down block {bt}")
    for bt in cfg.up_block_types:
        if bt not in ("CrossAttnUpBlock1D", "UpBlock1D"):
            raise ValueError(f"unknown up block {bt}")
    if cfg.mid_block_type not in (None, "UNetMidBlock1DCrossAttn"):
        raise ValueError(f"unknown mid block {cfg.mid_block_type}")


def _set_seq(module: nn.Module, seq) -> None:
    """Set ``seq`` on every layer of ``module`` that takes one."""
    for m in module.modules():
        if hasattr(type(m), "seq") and not isinstance(m, UNet1DCondition):
            m.seq = seq


class UNet1DCondition(nn.Module):
    """The conditional denoiser eps_hat(x_t, t, text_context).

    ``sample`` ``[B, T, in_channels]`` -> ``[B, T, out_channels]``;
    ``context`` is the text encoder output ``[B, S, cross_attention_dim]``.
    With ``seq`` set (a ``parallel.sp.SeqGroup``) the sample and the output
    are whole, and the levels that divide run on this rank's slice of time.
    """

    seq = None
    # ((whole length, group), plan) of the last arm_seq
    _armed = (None, None)

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        chans = cfg.block_out_channels
        n = len(chans)
        # "positional": sinusoidal features of width chans[0], embedded to
        # 4 * chans[0]; "fourier": features of width 2 * chans[0], embedded
        # to the same 2 * chans[0] (JAX unet1d.py:396-411)
        self.time_proj = None
        if cfg.time_embedding_type == "fourier":
            self.time_proj = GaussianFourierProjection(
                chans[0], flip_sin_to_cos=cfg.flip_sin_to_cos, device=device)
            feat_dim = temb_dim = chans[0] * 2
        else:
            feat_dim, temb_dim = chans[0], chans[0] * 4
        self.time_embedding = TimestepEmbedding(feat_dim, temb_dim,
                                                device=device)
        # class labels' embedding (JAX unet1d.py:414-445); "identity" and no
        # class embedding have no parameters
        self.class_embedding = None
        if cfg.class_embed_type is None and cfg.num_class_embeds:
            self.class_embedding = Embedding(cfg.num_class_embeds, temb_dim,
                                             device=device)
        elif cfg.class_embed_type == "timestep":
            self.class_embedding = TimestepEmbedding(feat_dim, temb_dim,
                                                     device=device)
        elif cfg.class_embed_type == "projection":
            self.class_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim,
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

    def level_lengths(self, T: int) -> List[int]:
        """The whole length of each level for a sample of ``T`` frames:
        ``ceil(T / 2)`` a strided-conv downsample, ``floor(T / 2)`` an
        average pool."""
        lengths = [T]
        for _ in self.config.block_out_channels[1:]:
            T = T // 2 if self.config.downsample_avg_pool else -(-T // 2)
            lengths.append(T)
        return lengths

    def arm_seq(self, T: int) -> List[bool]:
        """Arm every level for a sample of ``T`` whole frames under ``seq``:
        which levels run sharded (their lengths divide the group), each
        layer's ``seq``, and how each resampler crosses between levels.
        Armed once a length; returns the plan."""
        seq = self.seq
        if self._armed[0] == (T, seq):
            return self._armed[1]
        n = len(self.config.block_out_channels)
        L = self.level_lengths(T)
        plan = [L[i] % seq.size == 0 for i in range(n)]

        def at(i):
            return seq if plan[i] else None
        _set_seq(self.conv_in, at(0))
        _set_seq(self.conv_norm_out, at(0))
        _set_seq(self.conv_out, at(0))
        for i in range(n):
            _set_seq(getattr(self, f"down_{i}"), at(i))
            _set_seq(getattr(self, f"up_{i}"), at(n - 1 - i))
        if self.mid is not None:
            _set_seq(self.mid, at(n - 1))
        for i in range(n - 1):
            ds = self.get_submodule(f"down_{i}.downsample")
            # an even slice downsamples on its own (the left neighbour's
            # last frame): the output is the next level's slice
            local = plan[i] and (L[i] // seq.size) % 2 == 0
            ds.arm(seq, plan[i], plan[i + 1], local)
            j = n - 1 - i
            us = self.get_submodule(f"up_{i}.upsample")
            local = plan[j] and plan[j - 1] and L[j - 1] == 2 * L[j]
            us.arm(seq, plan[j], plan[j - 1], local)
        self._armed = ((T, seq), plan)
        return plan

    def _time_features(self, t: torch.Tensor) -> torch.Tensor:
        """f32 features of timesteps (or "timestep" class labels) ``[B]``."""
        if self.time_proj is not None:
            return self.time_proj(t)
        cfg = self.config
        return timestep_embedding(
            t, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift)

    def _class_embedding(self, labels: torch.Tensor,
                         temb: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.class_embed_type is None and cfg.num_class_embeds:
            return self.class_embedding(labels)
        if cfg.class_embed_type == "timestep":
            return self.class_embedding(self._time_features(labels))
        if cfg.class_embed_type == "identity":
            return labels.to(temb.dtype)
        if cfg.class_embed_type == "projection":
            return self.class_embedding(labels)
        raise ValueError("class_labels given but no class embedding "
                         "configured (set class_embed_type or "
                         "num_class_embeds)")

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor],
                cross_kv: Optional[CrossKV] = None,
                class_emb: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``class_labels``: ``[B]`` ints (the table, "timestep") or
        ``[B, dim]`` vectors ("identity": dim = the time embedding's width;
        "projection": ``projection_class_embeddings_input_dim``), through
        the configured class embedding; ``class_emb``: an already-embedded
        vector.  Both are added to the time embedding."""
        cfg = self.config
        ckv = cross_kv if cross_kv is not None else {}
        n = len(cfg.block_out_channels)
        temb = self.time_embedding(self._time_features(timesteps))
        if class_labels is not None:
            temb = temb + self._class_embedding(class_labels, temb).to(
                temb.dtype)
        if class_emb is not None:
            temb = temb + class_emb.to(temb.dtype)

        L = self.level_lengths(sample.shape[1])
        seq = self.seq
        sharded = seq is not None and self.arm_seq(L[0])[0]
        if sharded:
            sample = sp.slice_time(sample, seq)
        x = self.conv_in(sample)
        skips = [x]
        for i in range(n):
            x, new = getattr(self, f"down_{i}").down(
                x, temb, context, ckv.get(f"down_{i}"))
            skips.extend(new)
        if self.mid is not None:
            x = self.mid(x, temb, context, ckv.get("mid"))

        # each up block consumes layers_per_block+1 skips and upsamples to
        # the whole length of the next level up (the last block does not
        # upsample)
        for i in range(n):
            x = getattr(self, f"up_{i}").up(x, skips, temb, context,
                                            L[max(n - 2 - i, 0)],
                                            ckv.get(f"up_{i}"))
        x = F.silu(self.conv_norm_out(x))
        x = self.conv_out(x)
        return sp.gather_time(x, seq) if sharded else x


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
                lin(context).reshape(B, S, a.num_heads, -1)
                for lin in (a.to_k, a.to_v)))
        out.setdefault(block, {})[attn] = layers
    return out
