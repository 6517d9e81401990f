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
tensor it runs :func:`resnet_block_plain`, unless the block's weights were
packed on the CPU too (the synthesis programs', ``pipeline.Synthesizer``),
where it runs the kernel's plain version on them, as the exported program
does (``ops/cuda/resnet.py:fused_resnet_block_plain``).  The packed
tensors are the block's non-persistent buffers, so an export passes them
to the kernel's op as the module's state.  Training needs gradients and
the kernel has none, so there the module arithmetic runs under autograd
(:func:`resnet_block_plain`), as the JAX training path keeps XLA for this
op.

Under tensor parallelism (``parallel/tp.py``) a block's convolutions hold
this rank's output channels and gather them, and the kernel takes a whole
block's packed weights: a sharded block runs the module arithmetic
(:func:`resnet_block_plain` on the sharded convolutions), with or without
a gradient.  This is a dispatch by configuration, not a fallback: the
kernel stays the path of every unsharded block.  The same holds under
sequence parallelism (``parallel/sp.py``): a block at a level the UNet
runs on this rank's slice of time (``block.seq`` set) needs its
neighbours' edge frames for its convolutions and the group's GroupNorm
statistics, which the kernel, taking a whole block, does not exchange; it
runs the module arithmetic over the sharded layers.  The blocks of the
levels that run whole keep the kernel.
"""

import torch
import torch.nn.functional as F

from prompt_tts_tpu_torch.ops.cuda.library import traced
from prompt_tts_tpu_torch.ops.cuda.resnet import (
    _ORDER, fused_resnet_block, pack_resnet_weights,
)


def resnet_block_plain(block, x: torch.Tensor,
                       temb_proj: torch.Tensor) -> torch.Tensor:
    """The module arithmetic of ``block`` (a ``models.unet1d.
    ResnetBlock1D``): f32 GroupNorm statistics (``F.group_norm``), the
    convolutions and products in the compute dtype."""
    from prompt_tts_tpu_torch.models.layers import seq_dropout
    h = block.conv1(F.silu(block.norm1(x)))
    h = h + temb_proj[:, None, :]
    h = block.conv2(seq_dropout(block.dropout, F.silu(block.norm2(h)),
                                getattr(block, "seq", None)))
    if block.conv_shortcut is not None:
        x = block.conv_shortcut(x)
    return x + h


def _needs_grad(block, *tensors) -> bool:
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or any(p.requires_grad for p in block.parameters()))


def _kernel_dtype(block) -> torch.dtype:
    return block.conv1.compute_dtype or block.conv1.conv.weight.dtype


def pack_kernel_weights_(block, cpu: bool = False) -> None:
    """Keep ``block``'s weights in the kernel's layout as
    ``block.kernel_weights``, which every later kernel call reads, and as
    its non-persistent buffers ``kernel_<name>`` (not in the state dict),
    which an export reads.  The copy does not follow later changes to the
    weights: cast (and so pack) again after loading new ones.  Weights off
    the card are packed only with ``cpu``; else the plain version reads
    the module."""
    packed = None
    # a sharded block never takes the kernel
    if block.conv1.tp is None and (
            cpu or block.conv1.conv.weight.device.type == "cuda"):
        packed = pack_resnet_weights(block, _kernel_dtype(block))
    block.kernel_weights = packed
    for name in _ORDER:
        block.register_buffer(f"kernel_{name}",
                              None if packed is None else packed[name],
                              persistent=False)


def resnet_block(block, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """``ResnetBlock1D`` forward: ``x [B, T, Cin]``, ``temb [B, temb_dim]``
    -> ``[B, T, Cout]``."""
    temb_proj = block.time_emb_proj(F.silu(temb))
    dropout = block.training and block.dropout.p > 0
    packed = getattr(block, "kernel_weights", None)
    sharded = block.conv1.tp is not None or \
        getattr(block, "seq", None) is not None
    if (x.device.type == "cpu" and packed is None) or dropout or sharded \
            or _needs_grad(block, x, temb):
        return resnet_block_plain(block, x, temb_proj)
    dt = _kernel_dtype(block)
    if packed is not None and traced():
        # the buffers, which the export lifts as the module's state
        packed = {k: getattr(block, f"kernel_{k}") for k in _ORDER}
    if packed is None or packed["w1"].dtype != dt:
        # not cast for inference (a training model's eval loss, whose
        # weights change every step): pack for this call
        packed = pack_resnet_weights(block, dt)
    norm = block.norm1.norm
    return fused_resnet_block(x.to(dt).contiguous(), temb_proj, packed,
                              norm.num_groups, norm.eps)
