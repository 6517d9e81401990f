"""Reference-audio prompt encoder of the prompt-conditioned family.

Port of ``prompt_tts_tpu/models/prompt_encoder.py``: normalized EnCodec code
latents ``[B, Tp, n_q]`` -> ``prompt_tokens [B, K, dim]`` (K learned queries
pooled over the prompt, appended to the text context for cross-attention)
and ``speaker_emb [B, speaker_emb_dim]`` (added to the UNet's time
embedding).  A strided conv stem (75 Hz -> ~19 Hz), self-attention blocks,
then Perceiver-style pooling, so the token count is static whatever the
prompt's length.  Submodules carry the JAX param tree's names.
"""

import torch
import torch.nn.functional as F
from torch import nn

from prompt_tts_tpu_torch.models.layers import (
    Attention, Conv1d, Dense, LayerNorm, TransformerBlock,
)


class PromptEncoder(nn.Module):
    def __init__(self, dim: int, speaker_emb_dim: int, in_channels: int,
                 num_layers: int = 2, num_tokens: int = 32,
                 num_heads: int = 8, dropout: float = 0.0, device=None):
        super().__init__()
        self.num_layers = num_layers
        head_dim = dim // num_heads
        self.stem1 = Conv1d(in_channels, dim // 2, 3, stride=2, device=device)
        self.stem2 = Conv1d(dim // 2, dim, 3, stride=2, device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                dim, num_heads, head_dim, dropout=dropout, device=device))
        # drawn N(0, 0.02) by pipeline.random_init_, as flax's initializer
        self.queries = nn.Parameter(torch.empty(num_tokens, dim,
                                                device=device))
        self.pool = Attention(dim, dim, num_heads, head_dim, out_dim=dim,
                              device=device)
        self.token_norm = LayerNorm(dim, eps=1e-5, device=device)
        self.spk_proj1 = Dense(dim, speaker_emb_dim, device=device)
        self.spk_proj2 = Dense(speaker_emb_dim, speaker_emb_dim,
                               device=device)

    def forward(self, prompt_latents: torch.Tensor):
        """``[B, Tp, n_q]`` in [-1, 1] -> (tokens ``[B, K, dim]``,
        speaker ``[B, speaker_emb_dim]``)."""
        h = F.silu(self.stem1(prompt_latents))
        h = F.silu(self.stem2(h))
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h)
        q = self.queries[None].expand(h.shape[0], -1, -1)
        tokens = self.token_norm(self.pool(q, context=h))
        g = self.spk_proj2(F.silu(self.spk_proj1(tokens.mean(dim=1))))
        return tokens, g
