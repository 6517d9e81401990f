"""The EnCodec 24 kHz codec: SEANet encoder + RVQ, RVQ dequantize + SEANet
decoder.

Port of ``prompt_tts_tpu/codec/encodec.py``, the stock layer-by-layer
decoder (the JAX package's ``codec/folded.py`` is a TPU-layout rewrite of
the same math and is not ported).  Submodules are named ``layer_{i}`` after
the torch layer indices, as in the JAX param tree: a paramless ELU still
takes an index.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.codec.layers import (
    CodecConv1d, CodecConvTranspose1d, CodecLSTM, CodecResnetBlock,
)
from prompt_tts_tpu_torch.codec.rvq import rvq_decode, rvq_encode


@dataclass(frozen=True)
class EncodecConfig24k:
    """prompt_tts_tpu/codec/encodec.py:30-61 (the JAX module imports flax):
    facebook encodec_model_24khz's constants."""

    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128           # latent dim
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 128
    num_quantizers: int = 32         # available; bandwidth selects a prefix

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsampling_ratios:
            out *= r
        return out  # 320

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sampling_rate / self.hop_length)  # 75

    def num_quantizers_for_bandwidth(self, bandwidth_kbps: float) -> int:
        bw_per_q = math.log2(self.codebook_size) * self.frame_rate  # 750
        return max(1, int(math.floor(bandwidth_kbps * 1000 / bw_per_q)))


class _LayerStack(nn.Module):
    """The torch layer list in order, as ``layer_{i}`` submodules; None is a
    (paramless) ELU, which still takes an index."""

    def _register(self, layers) -> None:
        self._names = []
        for i, layer in enumerate(layers):
            if layer is not None:
                self.add_module(f"layer_{i}", layer)
            self._names.append(None if layer is None else f"layer_{i}")

    def forward(self, x: torch.Tensor,
                lstm_schedule: Optional[str] = None) -> torch.Tensor:
        for name in self._names:
            if name is None:
                x = F.elu(x)
            elif isinstance(getattr(self, name), CodecLSTM):
                x = getattr(self, name)(x, lstm_schedule)
            else:
                x = getattr(self, name)(x)
        return x


class EncodecEncoder(_LayerStack):
    """SEANet encoder: wav ``[B, T, 1]`` -> latents ``[B, ceil(T/320), 128]``."""

    def __init__(self, config: EncodecConfig24k = EncodecConfig24k(),
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        layers = [CodecConv1d(cfg.audio_channels, cfg.num_filters,
                              cfg.kernel_size, **kw)]
        scaling = 1
        for ratio in reversed(cfg.upsampling_ratios):
            current = scaling * cfg.num_filters
            layers += [CodecResnetBlock(
                current, dilation=cfg.dilation_growth_rate ** j,
                kernel_size=cfg.residual_kernel_size, compress=cfg.compress,
                **kw) for j in range(cfg.num_residual_layers)]
            layers += [None, CodecConv1d(current, current * 2, ratio * 2,
                                         stride=ratio, **kw)]
            scaling *= 2
        width = scaling * cfg.num_filters
        layers += [CodecLSTM(width, width, cfg.num_lstm_layers, **kw),
                   None, CodecConv1d(width, cfg.hidden_size,
                                     cfg.last_kernel_size, **kw)]
        self._register(layers)


class EncodecDecoder(_LayerStack):
    """SEANet decoder: latents ``[B, F, 128]`` -> wav ``[B, F*320, 1]``."""

    def __init__(self, config: EncodecConfig24k = EncodecConfig24k(),
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        scaling = 2 ** len(cfg.upsampling_ratios)
        layers = [
            CodecConv1d(cfg.hidden_size, scaling * cfg.num_filters,
                        cfg.kernel_size, **kw),
            CodecLSTM(scaling * cfg.num_filters, scaling * cfg.num_filters,
                      cfg.num_lstm_layers, **kw),
        ]
        for ratio in cfg.upsampling_ratios:
            current = scaling * cfg.num_filters
            layers += [None, CodecConvTranspose1d(current, current // 2,
                                                  ratio * 2, ratio, **kw)]
            layers += [CodecResnetBlock(
                current // 2, dilation=cfg.dilation_growth_rate ** j,
                kernel_size=cfg.residual_kernel_size, compress=cfg.compress,
                **kw) for j in range(cfg.num_residual_layers)]
            scaling //= 2
        layers += [None, CodecConv1d(cfg.num_filters, cfg.audio_channels,
                                     cfg.last_kernel_size, **kw)]
        self._register(layers)


class EncodecCodec(nn.Module):
    """The codec: ``encode(wav) -> codes``, ``decode(codes) -> wav``.

    ``codebooks`` is the single stacked param ``[num_quantizers, K, D]`` of
    the JAX codec.  The encoder is registered after the decoder and the
    codebooks, so seeded random weights (``pipeline.random_init_``, which
    draws in ``modules()`` order) keep the decode side's values.
    ``dtype`` is the layers' compute dtype over f32 parameters (JAX
    ``EncodecCodec(dtype=...)``); :meth:`at_dtype` gives a codec in
    another dtype over the same parameters.
    """

    def __init__(self, config: EncodecConfig24k = EncodecConfig24k(),
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.decoder = EncodecDecoder(config, device=device, dtype=dtype)
        self.codebooks = nn.Parameter(torch.zeros(
            config.num_quantizers, config.codebook_size, config.codebook_dim,
            device=device))
        self.encoder = EncodecEncoder(config, device=device, dtype=dtype)

    def at_dtype(self, dtype: torch.dtype) -> "EncodecCodec":
        """This codec computing in ``dtype``: a second module over the same
        parameter storage (not a copy), so weights loaded into either show
        in both; ``self`` when the dtype is its own."""
        if dtype == self.dtype:
            return self
        other = EncodecCodec(self.config, device="meta", dtype=dtype)
        other.load_state_dict(self.state_dict(), strict=True, assign=True)
        return other.train(self.training)

    def encode(self, wav: torch.Tensor, bandwidth_kbps: float = 6.0,
               lstm_schedule: Optional[str] = None) -> torch.Tensor:
        """wav ``[B, T]`` or ``[B, T, 1]`` -> int32 codes
        ``[B, n_q, ceil(T/320)]`` (n_q = 8 at 6 kbps).  ``lstm_schedule``:
        see ``codec.layers.CodecLSTM``."""
        if wav.dim() == 2:
            wav = wav[..., None]
        emb = self.encoder(wav, lstm_schedule).contiguous()
        n_q = self.config.num_quantizers_for_bandwidth(bandwidth_kbps)
        return rvq_encode(emb, self.codebooks[:n_q])

    def decode(self, codes: torch.Tensor,
               lstm_schedule: Optional[str] = None) -> torch.Tensor:
        """codes ``[B, n_q, F]`` -> wav ``[B, F*320]`` in the codec's
        dtype."""
        n_q = codes.shape[1]
        emb = rvq_decode(codes, self.codebooks[:n_q])
        return self.decoder(emb, lstm_schedule)[..., 0]
