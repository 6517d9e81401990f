"""Text encoder: embedding + transposed positional table + self-attn stack.

Port of ``prompt_tts_tpu/models/text_encoder.py``: word embedding, the
reference's transposed sinusoidal positional table, then ``num_layers``
self-attention-only transformer blocks with the 0/1 mask turned into an
additive -1e4 key bias; ``dropout`` (``text_encoder_dropout``, 0.1 by
default) in every block.
"""

import torch
from torch import nn

from prompt_tts_tpu_torch.models.embeddings import (
    transposed_positional_encoding,
)
from prompt_tts_tpu_torch.models.layers import (
    Embedding, TransformerBlock, mask_to_bias,
)


class TextEncoder(nn.Module):
    def __init__(self, vocab_len: int, seq_len: int, dim: int,
                 attention_head_dim: int, num_layers: int = 1,
                 dropout: float = 0.0, device=None):
        super().__init__()
        if dim % attention_head_dim != 0:
            raise ValueError("dim must be a multiple of attention_head_dim")
        num_heads = dim // attention_head_dim
        self.word_embedding = Embedding(vocab_len, dim, device=device)
        self.register_buffer(
            "pos", torch.from_numpy(
                transposed_positional_encoding(seq_len, dim)).to(device),
            persistent=False)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                dim, num_heads, attention_head_dim, dropout=dropout,
                device=device))

    def forward(self, input_ids: torch.Tensor,     # [B, S] int
                attention_mask: torch.Tensor,      # [B, S] 0/1
                ) -> torch.Tensor:                 # [B, S, dim]
        bias = mask_to_bias(attention_mask)
        x = self.word_embedding(input_ids.long())
        x = x + self.pos[None, : x.shape[1], :].to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, self_attn_bias=bias)
        return x
