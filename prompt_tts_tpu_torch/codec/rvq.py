"""Residual vector quantizer, decode side.

Port of ``rvq_decode`` / ``codebook_decode`` of
``prompt_tts_tpu/codec/rvq.py``.  The sum runs layer by layer in the JAX
scan's order, so decoded vectors are bit-identical.  Encode (and its TPU
kernel ``rvq_encode_fused``) is not ported yet.
"""

import torch


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
