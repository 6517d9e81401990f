"""Codec conv/LSTM primitives with EnCodec's exact padding semantics.

Port of ``prompt_tts_tpu/codec/layers.py``.  Modules take and return
channels-last ``[B, T, C]``; the convolutions run on a transposed view, so
between layers the data stays channels-first in memory.  Padding amounts
are computed from the input length, reproducing the causal reflect padding
of the torch ``EncodecConv1d``.

``dtype`` is the compute dtype, as flax's ``dtype=``: the parameters stay
f32, and a bf16 layer casts its input and weights per call (the convs then
run on bf16 activations and weights, cuDNN's bf16 convolutions on the
card).  The LSTM's input projection takes bf16 operands with f32
accumulation, plus the f32 bias, and its recurrence stays f32
(JAX ``codec/layers.py:143-147``), so the LSTM kernels keep their f32
contract.
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
# paths (PERF.md section 6): "persistent", 2.47 / 4.27 / 0.574 ms a layer
# against 3.59 / 6.53 / 0.907 at T=900 B=4 (decode), T=900 B=32
# (generate_codes) and T=225 B=4 (prompt encode), H = 512, NVIDIA H100 80GB
# HBM3 at 700.00 W (chip_smoke.py).
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
                 stride: int = 1, dilation: int = 1, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                              dilation=dilation, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.conv, self.dtype
        left, right = causal_pad_amounts(x.shape[1], c.kernel_size[0],
                                         c.stride[0], c.dilation[0])
        x = reflect_pad(x.to(dt), left, right)
        return c._conv_forward(x.transpose(1, 2), c.weight.to(dt),
                               c.bias.to(dt)).transpose(1, 2)


class CodecConvTranspose1d(nn.Module):
    """Transposed conv with causal right-trim (trim_right_ratio = 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size,
                                       stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.conv, self.dtype
        y = F.conv_transpose1d(x.to(dt).transpose(1, 2), c.weight.to(dt),
                               c.bias.to(dt), c.stride, c.padding,
                               c.output_padding, c.groups, c.dilation)
        trim = c.kernel_size[0] - c.stride[0]
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
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
            if self.dtype != torch.float32:
                # bf16 operands, f32 accumulation (JAX's einsum with
                # preferred_element_type=f32): the rounded operands'
                # products are exact in f32 (TF32 holds a bf16 too)
                x, w_ih = (t.to(self.dtype).float() for t in (x, w_ih))
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
                 compress: int = 2, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = dim // compress
        self.block_1 = CodecConv1d(dim, hidden, kernel_size,
                                   dilation=dilation, device=device,
                                   dtype=dtype)
        self.block_3 = CodecConv1d(hidden, dim, 1, device=device, dtype=dtype)
        self.shortcut = CodecConv1d(dim, dim, 1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block_3(F.elu(self.block_1(F.elu(x))))
        return self.shortcut(x) + h
