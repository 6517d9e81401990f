"""The UNet resnet block: dispatcher + plain PyTorch version.

Port of the op that ``prompt_tts_tpu/ops/pallas/resnet.py:
fused_resnet_block`` computes: ``ResnetBlock1D`` on channels-last
``[B, T, C]``, GN1 -> SiLU -> conv3 -> + temb_proj -> GN2 -> SiLU ->
dropout -> conv3 -> + shortcut, with ``temb_proj = time_emb_proj(silu(temb))``
computed outside (``[B, Cout]``).

On a CUDA tensor, when no gradient is needed, :func:`resnet_block` launches
the hand-written kernel (``ops/cuda/resnet.py``) on the weights that
:func:`pack_kernel_weights_` packed into its layout once, when
``models.layers.cast_compute_`` cast the model for inference; on a CPU
tensor it runs :func:`resnet_block_plain`.  Training needs gradients and
the kernel has none, so there the module arithmetic runs under autograd
(:func:`resnet_block_plain`), as the JAX training path keeps XLA for this
op.
"""

import torch
import torch.nn.functional as F


def resnet_block_plain(block, x: torch.Tensor,
                       temb_proj: torch.Tensor) -> torch.Tensor:
    """The module arithmetic of ``block`` (a ``models.unet1d.
    ResnetBlock1D``): f32 GroupNorm statistics (``F.group_norm``), the
    convolutions and products in the compute dtype."""
    h = block.conv1(F.silu(block.norm1(x)))
    h = h + temb_proj[:, None, :]
    h = block.conv2(block.dropout(F.silu(block.norm2(h))))
    if block.conv_shortcut is not None:
        x = block.conv_shortcut(x)
    return x + h


def _needs_grad(block, *tensors) -> bool:
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or any(p.requires_grad for p in block.parameters()))


def _kernel_dtype(block) -> torch.dtype:
    return block.conv1.compute_dtype or block.conv1.conv.weight.dtype


def pack_kernel_weights_(block) -> None:
    """Keep ``block``'s weights in the kernel's layout as
    ``block.kernel_weights``, which every later kernel call reads.  The copy
    does not follow later changes to the weights: cast (and so pack) again
    after loading new ones.  Weights off the card are not packed: the plain
    version reads the module."""
    block.kernel_weights = None
    if block.conv1.conv.weight.device.type == "cuda":
        from prompt_tts_tpu_torch.ops.cuda.resnet import pack_resnet_weights
        block.kernel_weights = pack_resnet_weights(block,
                                                   _kernel_dtype(block))


def resnet_block(block, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """``ResnetBlock1D`` forward: ``x [B, T, Cin]``, ``temb [B, temb_dim]``
    -> ``[B, T, Cout]``."""
    temb_proj = block.time_emb_proj(F.silu(temb))
    dropout = block.training and block.dropout.p > 0
    if x.device.type == "cpu" or dropout or _needs_grad(block, x, temb):
        return resnet_block_plain(block, x, temb_proj)
    from prompt_tts_tpu_torch.ops.cuda.resnet import (
        fused_resnet_block, pack_resnet_weights,
    )
    dt = _kernel_dtype(block)
    packed = block.kernel_weights
    if packed is None or packed["w1"].dtype != dt:
        # not cast for inference (a training model's eval loss, whose
        # weights change every step): pack for this call
        packed = pack_resnet_weights(block, dt)
    norm = block.norm1.norm
    return fused_resnet_block(x.to(dt).contiguous(), temb_proj, packed,
                              norm.num_groups, norm.eps)
