"""Codec conv/LSTM primitives with EnCodec's exact padding semantics.

Port of ``prompt_tts_tpu/codec/layers.py``.  Modules take and return
channels-last ``[B, T, C]``; the convolutions run on a transposed view, so
between layers the data stays channels-first in memory.  Padding amounts
are computed from the input length, reproducing the causal reflect padding
of the torch ``EncodecConv1d``.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_t,
)

# The LSTM recurrence's two schedules: "step" (csrc/lstm.cu, one launch per
# timestep) and "persistent" (csrc/lstm_t.cu, one cooperative launch).  The
# default is the one the H100 measured faster at every batch of the codec's
# paths (B = 4 decode and prompt encode, B = 32 generate_codes; PERF.md
# section 6).
LSTM_SCHEDULES = ("step", "persistent")
DEFAULT_LSTM_SCHEDULE = "persistent"


def causal_pad_amounts(length: int, kernel_size: int, stride: int,
                       dilation: int = 1) -> Tuple[int, int]:
    """(left, right) pads for a causal EnCodec conv at ``length``: left =
    effective kernel - stride; right = extra padding so the final window
    lands exactly at the end (ceil semantics)."""
    k_eff = (kernel_size - 1) * dilation + 1
    padding_total = k_eff - stride
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - padding_total
    return padding_total, ideal - length


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad along T of ``[B, T, C]`` with torch's small-input
    fallback (zero-extend right first when T <= max pad)."""
    xc = x.transpose(1, 2)
    T = xc.shape[-1]
    max_pad = max(left, right)
    if T <= max_pad:
        extra = max_pad - T + 1
        xc = F.pad(xc, (0, extra))
        padded = F.pad(xc, (left, right), mode="reflect")
        return padded[..., : padded.shape[-1] - extra].transpose(1, 2)
    return F.pad(xc, (left, right), mode="reflect").transpose(1, 2)


class CodecConv1d(nn.Module):
    """Causal conv with EnCodec padding (weight norm already folded)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                              dilation=dilation, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        left, right = causal_pad_amounts(x.shape[1], c.kernel_size[0],
                                         c.stride[0], c.dilation[0])
        x = reflect_pad(x, left, right)
        return c(x.transpose(1, 2)).transpose(1, 2)


class CodecConvTranspose1d(nn.Module):
    """Transposed conv with causal right-trim (trim_right_ratio = 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, device=None):
        super().__init__()
        self.conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size,
                                       stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.transpose(1, 2))
        trim = self.conv.kernel_size[0] - self.conv.stride[0]
        return y[..., : y.shape[-1] - trim].transpose(1, 2)


class CodecLSTM(nn.Module):
    """2-layer LSTM + residual, torch gate semantics.

    The input projection ``x @ W_ih^T + b`` for all timesteps is one matmul
    outside the recurrence; the recurrence itself is an LSTM kernel
    (``ops/cuda/lstm.py``) on CUDA and its plain version on the CPU, in the
    ``schedule`` given to ``forward`` ("step" or "persistent"; None: the
    measured default, ``DEFAULT_LSTM_SCHEDULE``).
    Params keep the JAX names: ``l{n}_w_ih`` [4H, C], ``l{n}_w_hh`` [4H, H],
    ``l{n}_b`` [4H] (b_ih + b_hh).
    """

    def __init__(self, in_channels: int, hidden: int, num_layers: int = 2,
                 device=None):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        for layer in range(num_layers):
            cin = in_channels if layer == 0 else hidden
            for name, shape in ((f"l{layer}_w_ih", (4 * hidden, cin)),
                                (f"l{layer}_w_hh", (4 * hidden, hidden)),
                                (f"l{layer}_b", (4 * hidden,))):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(shape, device=device)))

    def forward(self, x: torch.Tensor,
                schedule: Optional[str] = None) -> torch.Tensor:  # [B, T, C]
        schedule = schedule or DEFAULT_LSTM_SCHEDULE
        if schedule not in LSTM_SCHEDULES:
            raise ValueError(f"unknown LSTM schedule {schedule!r}, expected "
                             f"one of {LSTM_SCHEDULES}")
        residual = x
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"l{layer}_w_ih")
            w_hh = getattr(self, f"l{layer}_w_hh")      # [4H, H]
            b = getattr(self, f"l{layer}_b")
            x_proj = torch.einsum("btc,gc->btg", x, w_ih) + b    # [B, T, 4H]
            x_proj = x_proj.transpose(0, 1).contiguous()        # [T, B, 4H]
            if schedule == "step":
                hs = lstm_recurrence(x_proj, w_hh.t().contiguous())
            else:
                hs = lstm_recurrence_t(x_proj, w_hh)
            x = hs.transpose(0, 1)
        return x + residual


class CodecResnetBlock(nn.Module):
    """SEANet residual unit: ELU-conv(k,dil)-ELU-conv(1) + 1x1 shortcut."""

    def __init__(self, dim: int, dilation: int = 1, kernel_size: int = 3,
                 compress: int = 2, device=None):
        super().__init__()
        hidden = dim // compress
        self.block_1 = CodecConv1d(dim, hidden, kernel_size,
                                   dilation=dilation, device=device)
        self.block_3 = CodecConv1d(hidden, dim, 1, device=device)
        self.shortcut = CodecConv1d(dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block_3(F.elu(self.block_1(F.elu(x))))
        return self.shortcut(x) + h
