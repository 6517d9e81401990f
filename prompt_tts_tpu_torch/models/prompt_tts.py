"""TTSPromptSpeaker: the prompt-conditioned (multi-speaker) model.

Port of ``prompt_tts_tpu/models/prompt_tts.py``: the text encoder, a
reference-audio :class:`PromptEncoder` and the UNet.  The prompt tokens are
appended to the text context for cross-attention (``[B, S + K, dim]``); the
speaker embedding is added to the UNet's time embedding (``class_emb``).
``encode_conditioning`` runs once per utterance, ``denoise`` every step.
"""

from typing import Optional

import torch
from torch import nn

from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.models.prompt_encoder import PromptEncoder
from prompt_tts_tpu_torch.models.text_encoder import TextEncoder
from prompt_tts_tpu_torch.models.unet1d import CrossKV, UNet1DCondition


class TTSPromptSpeaker(nn.Module):
    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = cfg = config
        self.text_encoder = TextEncoder(
            vocab_len=cfg.cmu_vocab_len, seq_len=cfg.cmu_seq_len,
            dim=cfg.cross_attention_dim,
            attention_head_dim=cfg.attention_head_dim,
            num_layers=cfg.text_encoder_layers,
            dropout=cfg.text_encoder_dropout, device=device)
        self.prompt_encoder = PromptEncoder(
            dim=cfg.cross_attention_dim,
            speaker_emb_dim=cfg.block_out_channels[0] * 4,
            in_channels=cfg.in_channels,
            num_layers=cfg.prompt_encoder_layers,
            num_tokens=cfg.prompt_tokens, dropout=cfg.dropout, device=device)
        self.unet = UNet1DCondition(cfg, device=device)

    def encode_conditioning(self, text_seq_ids: torch.Tensor,
                            attention_mask: torch.Tensor,
                            prompt_latents: torch.Tensor):
        """ids/mask ``[B, S]``, prompt latents ``[B, Tp, n_q]`` ->
        (context ``[B, S + K, dim]``, speaker_emb ``[B, 4 * chans[0]]``)."""
        text_ctx = self.text_encoder(text_seq_ids, attention_mask)
        tokens, speaker = self.prompt_encoder(prompt_latents)
        context = torch.cat([text_ctx, tokens.to(text_ctx.dtype)], dim=1)
        return context, speaker

    def denoise(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor], speaker_emb: torch.Tensor,
                cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
        """sample ``[B, T, C]``, timesteps ``[B]`` -> eps ``[B, T, C]``."""
        return self.unet(sample, timesteps, context, cross_kv=cross_kv,
                         class_emb=speaker_emb)

    def forward(self, sample, timesteps, text_seq_ids, attention_mask,
                prompt_latents):
        context, speaker = self.encode_conditioning(
            text_seq_ids, attention_mask, prompt_latents)
        return self.denoise(sample, timesteps, context, speaker)
