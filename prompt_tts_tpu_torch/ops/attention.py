"""Scaled dot-product attention: dispatcher + plain PyTorch version.

Port of ``prompt_tts_tpu/ops/attention.py``.  Layout is ``[B, T, H, D]``
(batch, time, heads, head_dim) at every public function, as in the JAX
package.  The bias is additive and key-only: ``[B, 1, 1, Tk]`` (the
padded-text mask of ``models.layers.mask_to_bias``) or None.

On a CUDA tensor the dispatcher launches the hand-written attention kernel
(``ops/cuda/attention.py``, the port of the TPU ``flash_attention``) at
every site; on a CPU tensor it runs :func:`attention_plain`.  When a
gradient is needed it goes through :class:`AttentionFunction` instead,
whose backward is the hand-written backward kernel
(``ops/cuda/attention_bwd.py``, the port of the TPU
``attention_fused_bwd``), or :func:`attention_bwd_plain` on the CPU.  No
flag arms it: needing a gradient is the rule.
:func:`flash_attention_plain` is the TPU kernel's own math, which the bf16
kernel computes; the card's checks hold that kernel to it.

Under sequence parallelism (``parallel/sp.py``) the dispatcher consults
the seq group first, as JAX's consults its armed mesh: self-attention over
time-sharded tensors runs the ring (``ops/ring_attention.py``, kernels #1
and #2 at each step); cross-attention and every call without a group run
as above.
"""

from typing import Optional

import torch

from prompt_tts_tpu_torch.parallel import sp


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Port of ``_xla_attention`` (prompt_tts_tpu/ops/attention.py:73-102).

    f32: f32 scores and softmax.  bf16: bf16 scores, max-subtracted, with
    exp and sum in f32 and the probabilities cast back to bf16 for PV.
    """
    scale = q.shape[-1] ** -0.5
    if q.dtype == torch.bfloat16:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if bias is not None:
            s = s + bias.to(s.dtype)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp((s - m).float())
        probs = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Port of the TPU kernel's math (``_attn_kernel``, prompt_tts_tpu/ops/
    pallas/attention.py:40-67): what the bf16 CUDA kernel computes.

    f32 scores plus the f32 bias, f32 max, exp and sum; the unnormalised
    probabilities rounded to the input dtype for PV with f32 accumulation,
    divided by the f32 sum; the output at q's dtype.  For f32 inputs this
    is f32 attention.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (out / denom).permute(0, 2, 1, 3).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        bias: Optional[torch.Tensor] = None):
    """Port of ``_bwd_impl``'s math (prompt_tts_tpu/ops/pallas/
    attention_bwd.py:61-185), step by step on whole tensors.

    Recomputes the f32 probabilities, then ``delta = rowsum(do*o)``,
    ``dv = p^T do``, ``ds = p*(do v^T - delta)``, ``dq = ds k*scale``,
    ``dk = ds^T q*scale`` with f32 accumulation; p and ds*scale are rounded
    to the input dtype before their products, as the TPU kernel does.
    Returns dq, dk, dv at the input dtype and the f32 bias gradient
    ``[B, 1, 1, Tk]`` (ds summed over heads and query rows).
    """
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    delta = (dof * o.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta)
    dbias = ds.sum(dim=(1, 2))[:, None, None, :]
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


class AttentionFunction(torch.autograd.Function):
    """Attention for training: the forward kernel, which also keeps the row
    log-sum-exp, and the backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        # imported here: ops/cuda/*.py import the plain versions from
        # this module
        from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
        o, lse = flash_attention(q, k, v, bias, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        return o

    @staticmethod
    def backward(ctx, do):
        from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
        q, k, v, o, lse, bias = ctx.saved_tensors
        return attention_bwd(q, k, v, o, do, bias, lse,
                             need_dbias=ctx.needs_input_grad[3])


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None,
                                 seq=None) -> torch.Tensor:
    """Attention over ``[B, T, H, D]`` tensors with an optional key bias.
    ``seq``: the ``parallel.sp.SeqGroup`` over which q, k and v are this
    rank's time slices (None: the armed one, ``parallel.sp.enable``, or
    whole tensors)."""
    ring = sp.maybe_ring_attention(q, k, v, bias, seq)
    if ring is not None:
        return ring
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return AttentionFunction.apply(q, k, v, bias)
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    return flash_attention(q, k, v, bias)
