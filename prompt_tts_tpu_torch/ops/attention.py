"""Scaled dot-product attention: dispatcher + plain PyTorch version.

Port of ``prompt_tts_tpu/ops/attention.py``.  Layout is ``[B, T, H, D]``
(batch, time, heads, head_dim) at every public function, as in the JAX
package.  The bias is additive and key-only: ``[B, 1, 1, Tk]`` (the
padded-text mask of ``models.layers.mask_to_bias``) or None.

On a CUDA tensor the dispatcher launches the hand-written attention kernel
(``ops/cuda/attention.py``, the port of the TPU ``flash_attention``) at
every site; on a CPU tensor it runs :func:`attention_plain`.  Ring
attention, sequence parallelism and the fused-backward arming of the JAX
package are not ported.
"""

from typing import Optional

import torch


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


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Attention over ``[B, T, H, D]`` tensors with an optional key bias."""
    # imported here: ops/cuda/attention.py imports attention_plain from
    # this module
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    return flash_attention(q, k, v, bias)
