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

Tensor parallelism (``parallel/tp.py``): ``parallel.tp.shard_model_`` sets
``tp`` on the layers it slices.  An ``Attention`` then computes its local
heads (q/k/v column-parallel), its ``to_out`` and a ``GEGLUFeedForward``'s
``out`` are row-parallel ``Dense``s (their partial products summed over
the model group before the bias), and a sliced ``Conv1d`` or ``Embedding``
gathers its output channels.  With ``tp`` None (the default) nothing
changes.

Sequence parallelism (``parallel/sp.py``): the UNet sets ``seq`` (a
``parallel.sp.SeqGroup``) on the layers of the levels it runs sharded,
whose ``[B, T, C]`` inputs are then this rank's slice of time.  A k=3
``Conv1d`` pads its slice with its neighbours' edge frames, a
``GroupNorm`` reduces its statistics over the group, an ``Attention``
runs its self-attention on the ring, and the dropouts keep their slice of
one whole mask.  With ``seq`` None nothing changes.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.ops.attention import scaled_dot_product_attention
from prompt_tts_tpu_torch.parallel import sp
from prompt_tts_tpu_torch.parallel.tp import (
    copy_to_model, gather_from_model, reduce_from_model, sharded_dropout,
)


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (the weight's dtype when
    None), input and params cast per call (flax Dense).  With ``tp`` set it
    is row-parallel: its input and weight are this rank's slices of the
    in-features, and the partial products are summed over the model group
    before the bias."""

    compute_dtype: Optional[torch.dtype] = None
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt),
                            _cast(self.bias, dt))
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)),
                              self.tp)
        return y if self.bias is None else y + self.bias.to(dt)


class Embedding(nn.Embedding):
    """``nn.Embedding`` looking up in ``compute_dtype`` (flax Embed); with
    ``tp`` set its features are sliced and gathered."""

    compute_dtype: Optional[torch.dtype] = None
    tp = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.embedding(ids, self.weight.to(dt))
        return y if self.tp is None else gather_from_model(y, self.tp)


class Conv1d(nn.Module):
    """1-D convolution on ``[B, T, C]`` with torch-style explicit padding.
    With ``seq`` set its input is this rank's slice of time: a k=3 stride-1
    convolution takes one frame of each neighbour's, a k=3 stride-2 one
    (an even slice) the previous rank's last frame only, and the output is
    this rank's slice of the whole convolution's."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 use_bias: bool = True, device=None):
        super().__init__()
        if padding is None:
            padding = (kernel_size - 1) // 2
        self.conv = nn.Conv1d(in_channels, features, kernel_size, stride,
                              padding, bias=use_bias, device=device)

    compute_dtype: Optional[torch.dtype] = None
    # set: the output channels are sliced (column-parallel) and gathered
    tp = None
    # set: the input is this rank's slice of time (parallel/sp.py)
    seq = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        dt = self.compute_dtype or c.weight.dtype
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        if self.seq is not None and c.kernel_size[0] > 1:
            return self._forward_seq(x, dt)
        x = x.to(dt).transpose(1, 2)
        y = c._conv_forward(x, c.weight.to(dt),
                            _cast(c.bias, dt)).transpose(1, 2)
        return y if self.tp is None else gather_from_model(y, self.tp)

    def _forward_seq(self, x: torch.Tensor, dt) -> torch.Tensor:
        c = self.conv
        (k,), (stride,), (pad,) = c.kernel_size, c.stride, c.padding
        if k != 3 or pad != 1 or stride not in (1, 2) or (
                stride == 2 and x.shape[1] % 2):
            raise ValueError(f"a time-sharded convolution takes k=3, "
                             f"padding 1, stride 1 or 2 (on an even slice); "
                             f"got k={k}, padding {pad}, stride {stride}, "
                             f"{x.shape[1]} frames")
        x = sp.halo(x, self.seq, 1, 1 if stride == 1 else 0)
        y = F.conv1d(x.to(dt).transpose(1, 2), c.weight.to(dt),
                     _cast(c.bias, dt), stride).transpose(1, 2)
        return y if self.tp is None else gather_from_model(y, self.tp)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis of ``[B, T, C]`` (torch semantics),
    statistics in f32; with ``seq`` set over the whole sequence of which
    the input is this rank's slice (``parallel.sp.group_norm``)."""

    seq = None

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, channels, eps=epsilon,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        if self.seq is not None:
            return sp.group_norm(x, n.num_groups, n.weight, n.bias, n.eps,
                                 self.seq)
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
    projection with bias, scale ``head_dim**-0.5``).  Under tensor
    parallelism ``num_heads`` is the local count; under sequence
    parallelism (``seq`` set) the queries are this rank's time slice, and
    self-attention runs on the ring."""

    tp = None
    seq = None

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
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
            if context is not None:
                context = copy_to_model(context, self.tp)
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
        self_attn = context is None and kv_cache is None
        out = scaled_dot_product_attention(
            q, k, v, bias=bias, seq=self.seq if self_attn else None)
        return seq_dropout(self.dropout, self.to_out(out.reshape(B, Tq, -1)),
                           self.seq)


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward ``Dense(8C) -> value * gelu(gate) -> Dense(C)``,
    exact-erf GELU (diffusers ``FeedForward(activation_fn="geglu")``).
    Under tensor parallelism ``proj`` gives this rank's ``[value | gate]``
    columns and the dropout keeps its slice of one whole mask, as it does
    under sequence parallelism (``seq`` set)."""

    tp = None
    seq = None

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.proj = Dense(dim, inner * 2, device=device)
        self.dropout = nn.Dropout(dropout)
        self.out = Dense(inner, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        value, gate = self.proj(x).chunk(2, dim=-1)
        h = value * F.gelu(gate)
        if (self.tp is not None or self.seq is not None) and \
                self.training and self.dropout.p > 0:
            return self.out(sharded_dropout(h, self.dropout.p, self.tp,
                                            self.seq))
        return self.out(self.dropout(h))


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


def seq_dropout(dropout: nn.Dropout, h: torch.Tensor, seq) -> torch.Tensor:
    """``dropout(h)``; for a time slice ``h`` (``seq`` set) in training,
    this rank's slice of one whole mask (``parallel.tp.sharded_dropout``)."""
    if seq is None or not dropout.training or dropout.p == 0:
        return dropout(h)
    return sharded_dropout(h, dropout.p, seq=seq)


def mask_to_bias(mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """0/1 key mask ``[B, S]`` -> additive bias ``[B, 1, 1, S]``:
    ``(1 - mask) * -10000`` (reference tts/models.py:107-110)."""
    bias = (1.0 - mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]


def cast_compute_(module: nn.Module, dtype: torch.dtype,
                  pack_cpu: bool = False) -> nn.Module:
    """Cast the matmul/conv/embedding weights of ``module`` to ``dtype`` in
    place; norm params stay f32.  The port of a flax model run with
    ``dtype=bf16`` over f32 params, for inference: the cast happens once,
    not per call.  The UNet resnet blocks' weights on the card (and with
    ``pack_cpu`` on the CPU too) are packed into the fused kernel's layout
    here, once, too."""
    from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
    from prompt_tts_tpu_torch.ops.resnet import pack_kernel_weights_
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d,
                          nn.Embedding)):
            m.to(dtype)
    for m in module.modules():
        if isinstance(m, ResnetBlock1D):
            pack_kernel_weights_(m, cpu=pack_cpu)
    return module


def set_compute_dtype_(module: nn.Module,
                       dtype: Optional[torch.dtype]) -> nn.Module:
    """Make the matmul/conv/embedding layers of ``module`` compute in
    ``dtype`` (None: in their weights' dtype), casting weights and inputs
    per call: the parameters keep their dtype (f32 for training) and
    receive f32 gradients through the casts."""
    from prompt_tts_tpu_torch.models.unet1d import ConvTransposeUpsample1D
    for m in module.modules():
        if isinstance(m, (Dense, Conv1d, Embedding,
                          ConvTransposeUpsample1D)):
            m.compute_dtype = dtype
    return module
