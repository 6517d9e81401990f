"""The EnCodec 24 kHz codec, decode side: RVQ dequantize + SEANet decoder.

Port of ``EncodecDecoder`` and ``EncodecCodec.decode`` of
``prompt_tts_tpu/codec/encodec.py``, the stock layer-by-layer decoder (the
JAX package's ``codec/folded.py`` is a TPU-layout rewrite of the same math
and is not ported).  Submodules are named ``layer_{i}`` after the torch
layer indices, as in the JAX param tree.  The encoder is not ported yet.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.codec.layers import (
    CodecConv1d, CodecConvTranspose1d, CodecLSTM, CodecResnetBlock,
)
from prompt_tts_tpu_torch.codec.rvq import rvq_decode


@dataclass(frozen=True)
class EncodecConfig24k:
    """The fields of prompt_tts_tpu/codec/encodec.py:30-61 (the JAX module
    imports flax): facebook encodec_model_24khz's constants.  The
    encode-side helpers are not copied."""

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


class EncodecDecoder(nn.Module):
    """SEANet decoder: latents ``[B, F, 128]`` -> wav ``[B, F*320, 1]``."""

    def __init__(self, config: EncodecConfig24k = EncodecConfig24k(),
                 device=None):
        super().__init__()
        cfg = config
        scaling = 2 ** len(cfg.upsampling_ratios)
        # the torch layer list in order; None is a (paramless) ELU, which
        # still takes an index
        layers = [
            CodecConv1d(cfg.hidden_size, scaling * cfg.num_filters,
                        cfg.kernel_size, device=device),
            CodecLSTM(scaling * cfg.num_filters, scaling * cfg.num_filters,
                      cfg.num_lstm_layers, device=device),
        ]
        for ratio in cfg.upsampling_ratios:
            current = scaling * cfg.num_filters
            layers += [None, CodecConvTranspose1d(current, current // 2,
                                                  ratio * 2, ratio,
                                                  device=device)]
            layers += [CodecResnetBlock(
                current // 2, dilation=cfg.dilation_growth_rate ** j,
                kernel_size=cfg.residual_kernel_size, compress=cfg.compress,
                device=device) for j in range(cfg.num_residual_layers)]
            scaling //= 2
        layers += [None, CodecConv1d(cfg.num_filters, cfg.audio_channels,
                                     cfg.last_kernel_size, device=device)]
        self._names = []
        for i, layer in enumerate(layers):
            if layer is not None:
                self.add_module(f"layer_{i}", layer)
            self._names.append(None if layer is None else f"layer_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._names:
            x = F.elu(x) if name is None else getattr(self, name)(x)
        return x


class EncodecCodec(nn.Module):
    """Decode side of the codec: ``decode(codes) -> wav``.

    ``codebooks`` is the single stacked param ``[num_quantizers, K, D]`` of
    the JAX codec.
    """

    def __init__(self, config: EncodecConfig24k = EncodecConfig24k(),
                 device=None):
        super().__init__()
        self.config = config
        self.decoder = EncodecDecoder(config, device=device)
        self.codebooks = nn.Parameter(torch.zeros(
            config.num_quantizers, config.codebook_size, config.codebook_dim,
            device=device))

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, n_q, F]`` -> wav ``[B, F*320]``."""
        n_q = codes.shape[1]
        emb = rvq_decode(codes, self.codebooks[:n_q])
        return self.decoder(emb)[..., 0]
