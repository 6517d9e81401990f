"""Core compute layers: conv/norm wrappers, attention, transformer block.

Port of ``prompt_tts_tpu/models/layers.py``.  Public layout is
channels-last ``[B, T, C]`` as in the JAX package.  Submodules are named
after the JAX param tree (``conv/conv``, ``norm1/norm``, ``attn1/to_q``, ...)
so ``convert.py`` maps a JAX checkpoint by layout rules alone.

Mixed precision follows flax's ``dtype=`` semantics: matmul, conv and
embedding layers compute in their compute dtype, while the norms keep f32
params and compute their statistics in f32, returning the input's dtype.
Two ways to set it: inference casts the weights once, in place
(``cast_compute_``), and the layers compute in the weights' dtype; training
keeps f32 parameters for the optimizer and casts weights and inputs per
call (``set_compute_dtype_``), as flax does.

Dropout sits where the JAX model has it (attention output, GEGLU hidden,
UNet resnet block) and is active only in ``module.train()``.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.ops.attention import scaled_dot_product_attention


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (the weight's dtype when
    None), input and params cast per call (flax Dense)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Embedding(nn.Embedding):
    """``nn.Embedding`` looking up in ``compute_dtype`` (flax Embed)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.embedding(ids, self.weight.to(dt))


class Conv1d(nn.Module):
    """1-D convolution on ``[B, T, C]`` with torch-style explicit padding."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 use_bias: bool = True, device=None):
        super().__init__()
        if padding is None:
            padding = (kernel_size - 1) // 2
        self.conv = nn.Conv1d(in_channels, features, kernel_size, stride,
                              padding, bias=use_bias, device=device)

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        dt = self.compute_dtype or c.weight.dtype
        x = x.to(dt).transpose(1, 2)
        return c._conv_forward(x, c.weight.to(dt),
                               _cast(c.bias, dt)).transpose(1, 2)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis of ``[B, T, C]`` (torch semantics),
    statistics in f32."""

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, channels, eps=epsilon,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        y = F.group_norm(x.float().transpose(1, 2), n.num_groups,
                         n.weight.float(), n.bias.float(), n.eps)
        return y.transpose(1, 2).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics, returning the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class Attention(nn.Module):
    """Multi-head attention with optional cross-context and additive bias
    (diffusers ``CrossAttention`` numerics: q/k/v without bias, output
    projection with bias, scale ``head_dim**-0.5``)."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, out_dim: Optional[int] = None,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.num_heads = num_heads
        self.head_dim = head_dim
        inner = num_heads * head_dim
        self.to_q = Dense(query_dim, inner, bias=False, device=device)
        self.to_k = Dense(context_dim, inner, bias=False, device=device)
        self.to_v = Dense(context_dim, inner, bias=False, device=device)
        self.to_out = Dense(inner, out_dim or inner, device=device)

    def forward(
        self,
        x: torch.Tensor,                          # [B, Tq, C]
        context: Optional[torch.Tensor] = None,   # [B, Tk, Cc] or None (self)
        bias: Optional[torch.Tensor] = None,      # additive, [B,1,1,Tk]
        kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        B, Tq, _ = x.shape
        q = self.to_q(x).reshape(B, Tq, self.num_heads, self.head_dim)
        if kv_cache is not None:
            # k/v precomputed from a loop-invariant context (the sampler
            # hoist), already [B, Tk, H, D] in the compute dtype
            k, v = kv_cache
        else:
            ctx = x if context is None else context
            Tk = ctx.shape[1]
            k = self.to_k(ctx).reshape(B, Tk, self.num_heads, self.head_dim)
            v = self.to_v(ctx).reshape(B, Tk, self.num_heads, self.head_dim)
        out = scaled_dot_product_attention(q, k, v, bias=bias)
        return self.dropout(self.to_out(out.reshape(B, Tq, -1)))


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward ``Dense(8C) -> value * gelu(gate) -> Dense(C)``,
    exact-erf GELU (diffusers ``FeedForward(activation_fn="geglu")``)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.proj = Dense(dim, inner * 2, device=device)
        self.dropout = nn.Dropout(dropout)
        self.out = Dense(inner, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(self.dropout(value * F.gelu(gate)))


class TransformerBlock(nn.Module):
    """Pre-norm block == diffusers ``BasicTransformerBlock``: self-attn,
    [cross-attn when ``cross_attention_dim`` is set], GEGLU FF, each with a
    LayerNorm (eps 1e-5) in front and a residual around it; ``dropout`` on
    each attention output and on the feed-forward's hidden activations."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn1 = Attention(dim, dim, num_heads, head_dim, dim,
                               dropout=dropout, device=device)
        self.has_cross = cross_attention_dim is not None
        if self.has_cross:
            self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
            self.attn2 = Attention(dim, cross_attention_dim, num_heads,
                                   head_dim, dim, dropout=dropout,
                                   device=device)
        self.norm3 = LayerNorm(dim, eps=1e-5, device=device)
        self.ff = GEGLUFeedForward(dim, dropout=dropout, device=device)

    def forward(
        self,
        x: torch.Tensor,                          # [B, T, C]
        context: Optional[torch.Tensor] = None,   # [B, S, Cc]
        self_attn_bias: Optional[torch.Tensor] = None,
        cross_attn_bias: Optional[torch.Tensor] = None,
        cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), bias=self_attn_bias)
        if self.has_cross:
            if context is None and cross_kv is None:
                raise ValueError("cross-attention block requires context")
            x = x + self.attn2(self.norm2(x), context=context,
                               bias=cross_attn_bias, kv_cache=cross_kv)
        return x + self.ff(self.norm3(x))


def mask_to_bias(mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """0/1 key mask ``[B, S]`` -> additive bias ``[B, 1, 1, S]``:
    ``(1 - mask) * -10000`` (reference tts/models.py:107-110)."""
    bias = (1.0 - mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]


def cast_compute_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matmul/conv/embedding weights of ``module`` to ``dtype`` in
    place; norm params stay f32.  The port of a flax model run with
    ``dtype=bf16`` over f32 params, for inference: the cast happens once,
    not per call.  The UNet resnet blocks' weights on the card are packed
    into the fused kernel's layout here, once, too."""
    from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
    from prompt_tts_tpu_torch.ops.resnet import pack_kernel_weights_
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Embedding)):
            m.to(dtype)
    for m in module.modules():
        if isinstance(m, ResnetBlock1D):
            pack_kernel_weights_(m)
    return module


def set_compute_dtype_(module: nn.Module,
                       dtype: Optional[torch.dtype]) -> nn.Module:
    """Make the matmul/conv/embedding layers of ``module`` compute in
    ``dtype`` (None: in their weights' dtype), casting weights and inputs
    per call: the parameters keep their dtype (f32 for training) and
    receive f32 gradients through the casts."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv1d, Embedding)):
            m.compute_dtype = dtype
    return module
