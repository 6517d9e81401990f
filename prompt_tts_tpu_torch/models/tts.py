"""TTSSingleSpeaker: text encoder + conditional UNet denoiser.

Port of ``prompt_tts_tpu/models/tts.py``.  ``encode_text`` and ``denoise``
are separate so the sampler runs the text encoder once per utterance and
hoists the cross-attention k/v out of the denoising loop.  The padded-text
mask gates the text encoder's self-attention only; the UNet's
cross-attention runs unmasked, as in the reference.
"""

from typing import Optional

import torch
from torch import nn

from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.models.text_encoder import TextEncoder
from prompt_tts_tpu_torch.models.unet1d import CrossKV, UNet1DCondition


class TTSSingleSpeaker(nn.Module):
    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        if config.prompt_conditioning:
            raise ValueError(
                "TTSSingleSpeaker is the single-speaker family: use "
                "models.prompt_tts.TTSPromptSpeaker for a config with "
                "prompt_conditioning")
        self.config = config
        self.text_encoder = TextEncoder(
            vocab_len=config.cmu_vocab_len, seq_len=config.cmu_seq_len,
            dim=config.cross_attention_dim,
            attention_head_dim=config.attention_head_dim,
            num_layers=config.text_encoder_layers,
            dropout=config.text_encoder_dropout, device=device)
        self.unet = UNet1DCondition(config, device=device)

    def encode_text(self, text_seq_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """ids/mask ``[B, S]`` -> context ``[B, S, cross_attention_dim]``."""
        return self.text_encoder(text_seq_ids, attention_mask)

    def denoise(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor],
                cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
        """sample ``[B, T, C]``, timesteps ``[B]`` -> eps ``[B, T, C]``."""
        return self.unet(sample, timesteps, context, cross_kv=cross_kv)

    def forward(self, sample, timesteps, text_seq_ids, attention_mask):
        context = self.encode_text(text_seq_ids, attention_mask)
        return self.denoise(sample, timesteps, context)
