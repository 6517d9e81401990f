"""Residual vector quantizer: nearest-codebook search + dequantization.

Port of ``prompt_tts_tpu/codec/rvq.py``.  Semantics are EnCodec's
euclidean codebook: score = -(|x|^2 - 2 x.E^T + |E|^2), argmax over the
codes (the first index wins ties), residual peeled per layer in f32.
``rvq_encode`` is the hand-written kernel on a CUDA tensor and the plain
per-layer loop on a CPU tensor (``ops/cuda/rvq.py``).  The decode sum runs
layer by layer in the JAX scan's order, so decoded vectors are
bit-identical.
"""

import torch

from prompt_tts_tpu_torch.ops.cuda.rvq import codebook_quantize, rvq_encode

__all__ = ["codebook_quantize", "codebook_decode", "rvq_encode",
           "rvq_decode"]


def codebook_decode(indices: torch.Tensor,
                    embed: torch.Tensor) -> torch.Tensor:
    """Indices ``[...]`` -> vectors ``[..., D]`` (embedding gather)."""
    return embed[indices.long()]


def rvq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Codes ``[B, n_q, T]`` -> summed quantized vectors ``[B, T, D]``."""
    B, n_q, T = codes.shape
    acc = torch.zeros(B, T, codebooks.shape[-1], dtype=torch.float32,
                      device=codebooks.device)
    for q in range(n_q):
        acc = acc + codebook_decode(codes[:, q], codebooks[q])
    return acc
