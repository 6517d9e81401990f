"""End-to-end synthesis: text -> phonemes -> DDIM denoising -> codec -> wav.

Port of ``prompt_tts_tpu/pipeline.py`` for the single-speaker model, the
DDIM sampler and ``guidance_scale=1``.  Code normalization contract: model
latents live in [-1, 1] via ``c * 2/1023 - 1``; synthesis inverts with
round + clip before the codec decode.
"""

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from prompt_tts_tpu_torch.config import Config
from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
from prompt_tts_tpu_torch.codec.layers import CodecLSTM
from prompt_tts_tpu_torch.diffusion.ddim import ddim_sample
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.unet1d import cross_attention_kv

SAMPLE_RATE = 24000
# seeds of the CPU generators that draw random weights (no checkpoint given)
MODEL_INIT_SEED, CODEC_INIT_SEED = 0, 1


def codes_to_latents(codes: torch.Tensor) -> torch.Tensor:
    """int codes ``[B, n_q, T]`` -> latents ``[B, T, n_q]`` in [-1, 1]."""
    x = codes.float() * (2.0 / 1023.0) - 1.0
    return x.transpose(1, 2)


def latents_to_codes(latents: torch.Tensor) -> torch.Tensor:
    """latents ``[B, T, n_q]`` -> int codes ``[B, n_q, T]`` in [0, 1023]."""
    c = torch.round((latents + 1.0) * (1023.0 / 2.0))
    return c.clamp(0, 1023).to(torch.int32).transpose(1, 2)


def wav_to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """float wav in [-1, 1] -> int16 PCM: clip(round-half-to-even(x*32767)),
    bit-identical to ``prompt_tts_tpu.utils.wav.pcm16_bytes``."""
    return torch.round(wav * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)


@contextlib.contextmanager
def full_f32():
    """Run f32 convolutions and matmuls in full f32, not TF32.

    cuDNN convolutions default to TF32 on the card (about three decimal
    digits), which would miss the codec's 1e-5 decode contract; the flags
    are restored on exit.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from the CPU ``generator``, in
    the manner of the JAX package's flax initializers: lecun-normal
    matmul/conv weights, zero biases, unit norm scales, xavier-uniform LSTM
    weights, unit-normal codebooks.  The repo holds no checkpoint, so the
    port runs on weights like these; drawn on the CPU, one seed gives the
    same weights on every device."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose1d)
                      else w.shape[1]) * math.prod(w.shape[2:])
            normal_(w, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.weight.shape[0] ** -0.5)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, CodecLSTM):
            for name, p in m.named_parameters():
                if name.endswith("_b"):
                    p.zero_()
                else:
                    bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                    p.copy_((torch.rand(p.shape, generator=generator) * 2
                             - 1) * bound)
        elif isinstance(m, EncodecCodec):
            normal_(m.codebooks, 1.0)
    return module


class CodecRunner:
    """The f32 EnCodec decoder on one device."""

    def __init__(self, device, codec_state: Optional[dict] = None):
        self.device = torch.device(device)
        self.codec = EncodecCodec(device=self.device)
        if codec_state is not None:
            self.codec.load_state_dict(codec_state, strict=True)
        else:
            random_init_(self.codec,
                         torch.Generator().manual_seed(CODEC_INIT_SEED))
        self.codec.eval()

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """int codes ``[B, n_q, T]`` -> wav ``[B, T*320]`` f32 @ 24 kHz."""
        codes = torch.as_tensor(codes, device=self.device)
        with full_f32():
            return self.codec.decode(codes)


class Synthesizer:
    """Owns the model and codec and runs text -> wav.

    The denoiser computes in ``dtype`` (bf16 by default) over params drawn
    or loaded in f32; the codec decodes in f32.  ``model_state`` /
    ``codec_state`` are port state dicts (see ``convert.py``); without them
    the weights are random, drawn from CPU ``torch.Generator``s with fixed
    seeds, so every device gets the same weights.
    """

    def __init__(self, config: Optional[Config] = None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 num_inference_steps: int = 50,
                 model_state: Optional[dict] = None,
                 codec_state: Optional[dict] = None):
        self.config = config or Config()
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_inference_steps = num_inference_steps
        mcfg = self.config.model
        self.model = TTSSingleSpeaker(mcfg, device=self.device)
        if model_state is not None:
            self.model.load_state_dict(model_state, strict=True)
        else:
            random_init_(self.model,
                         torch.Generator().manual_seed(MODEL_INIT_SEED))
        cast_compute_(self.model.eval(), dtype)
        self.codec_runner = CodecRunner(self.device, codec_state)
        self.schedule = linear_schedule(
            self.config.train.num_train_timesteps, device=self.device)
        self.tokenizer = Tokenizer(max_len=mcfg.cmu_seq_len)

    @torch.no_grad()
    def denoise_latents(self, x_T: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """DDIM from ``x_T`` ``[B, T, n_q]`` to latents, conditioned on
        ids/mask ``[B, S]``: the text encoder runs once and the
        cross-attention k/v are hoisted out of the loop."""
        scope = full_f32() if self.dtype == torch.float32 else (
            contextlib.nullcontext())
        with scope:
            context = self.model.encode_text(ids, mask)
            kv = cross_attention_kv(self.model.unet, context)
            return ddim_sample(
                lambda x, t: self.model.denoise(x, t, context, cross_kv=kv),
                self.schedule, x_T, self.num_inference_steps)

    @torch.no_grad()
    def synthesize(self, texts: Sequence[str], seed: int = 0,
                   x_T: Optional[torch.Tensor] = None,
                   return_codes: bool = False, pcm16: bool = False):
        """texts -> f32 wav ``[B, frames*320]`` at 24 kHz as numpy (int16
        PCM with ``pcm16=True``); with ``return_codes`` also the codes
        ``[B, n_q, frames]``.  ``x_T`` ``[B, frames, n_q]`` replaces the
        noise drawn from ``seed`` (on a CPU generator, so one seed gives the
        same x_T on every device)."""
        mcfg = self.config.model
        ids, mask = self.tokenizer.encode_batch(list(texts))
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        if x_T is None:
            g = torch.Generator().manual_seed(seed)
            x_T = torch.randn((len(texts), mcfg.sample_size, mcfg.in_channels),
                              generator=g)
        latents = self.denoise_latents(x_T.to(self.device), ids, mask)
        codes = latents_to_codes(latents)
        wav = self.codec_runner.decode(codes)
        if pcm16:
            wav = wav_to_pcm16(wav)
        wav = wav.cpu().numpy()
        if return_codes:
            return wav, codes.cpu().numpy()
        return wav
