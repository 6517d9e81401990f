"""End-to-end synthesis: text (+ a voice prompt) -> phonemes -> denoising
-> codec -> wav.

Port of ``prompt_tts_tpu/pipeline.py``: both model families (the
single-speaker ``TTSSingleSpeaker`` and the prompt-conditioned
``TTSPromptSpeaker``, chosen by ``config.model.prompt_conditioning``), the
DDIM and DPM-Solver++(2M) samplers, and classifier-free guidance for both
families.  Code normalization contract: model latents live in [-1, 1] via
``c * 2/1023 - 1``; synthesis inverts with round + clip before the codec
decode.
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
from prompt_tts_tpu_torch.diffusion.dpm import dpm_solver_sample
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.prompt_encoder import PromptEncoder
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
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
    weights, unit-normal codebooks, N(0, 0.02) prompt queries.  The repo holds no checkpoint, so the
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
        elif isinstance(m, PromptEncoder):
            normal_(m.queries, 0.02)
    return module


class CodecRunner:
    """The f32 EnCodec codec on one device: encode and decode, with TF32
    off.  ``lstm_schedule`` picks the LSTM kernel's schedule ("step" or
    "persistent"; None: the measured default, ``codec.layers.
    DEFAULT_LSTM_SCHEDULE``)."""

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
    def decode(self, codes, lstm_schedule: Optional[str] = None
               ) -> torch.Tensor:
        """int codes ``[B, n_q, T]`` -> wav ``[B, T*320]`` f32 @ 24 kHz."""
        codes = torch.as_tensor(codes, device=self.device)
        with full_f32():
            return self.codec.decode(codes, lstm_schedule=lstm_schedule)

    @torch.no_grad()
    def encode(self, wav, lstm_schedule: Optional[str] = None
               ) -> torch.Tensor:
        """wav ``[B, T]`` f32 @ 24 kHz -> int32 codes ``[B, 8, ceil(T/320)]``
        (6 kbps)."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        with full_f32():
            return self.codec.encode(wav, lstm_schedule=lstm_schedule)


class Synthesizer:
    """Owns the model and codec and runs text (+ a voice prompt) -> wav.

    The denoiser computes in ``dtype`` (bf16 by default) over params drawn
    or loaded in f32; the codec decodes in f32.  ``model_state`` /
    ``codec_state`` are port state dicts (see ``convert.py``); without them
    the weights are random, drawn from CPU ``torch.Generator``s with fixed
    seeds, so every device gets the same weights.  ``sampler`` is "ddim"
    or "dpm" (DPM-Solver++(2M)); ``guidance_scale`` != 1 runs
    classifier-free guidance, the conditional and null branches
    concatenated on the batch axis.  A prompt-conditioned config
    (``prompt_conditioning``) builds ``TTSPromptSpeaker``, which takes a
    voice prompt per request.
    """

    def __init__(self, config: Optional[Config] = None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 num_inference_steps: int = 50,
                 model_state: Optional[dict] = None,
                 codec_state: Optional[dict] = None,
                 sampler: str = "ddim", guidance_scale: float = 1.0):
        if sampler not in ("ddim", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.config = config or Config()
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_inference_steps = num_inference_steps
        self.sampler = sampler
        self.guidance_scale = float(guidance_scale)
        mcfg = self.config.model
        self.prompted = mcfg.prompt_conditioning
        model_cls = TTSPromptSpeaker if self.prompted else TTSSingleSpeaker
        self.model = model_cls(mcfg, device=self.device)
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

    def _condition(self, ids, mask, prompt):
        """(context, speaker_emb or None) for ids/mask (and the prompt
        latents of the prompt family)."""
        if self.prompted:
            return self.model.encode_conditioning(ids, mask, prompt)
        return self.model.encode_text(ids, mask), None

    @torch.no_grad()
    def denoise_latents(self, x_T: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor,
                        prompt: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Sample latents from ``x_T`` ``[B, T, n_q]``, conditioned on
        ids/mask ``[B, S]`` (and, for the prompt family, the prompt latents
        ``[B, prompt_frames, n_q]``).  The conditioning runs once (twice
        under CFG: the null branch is zero ids, zero mask and zero prompt
        latents) and the cross-attention k/v are hoisted out of the loop,
        once for the whole (doubled) context."""
        if self.prompted and prompt is None:
            raise ValueError("the prompt-conditioned model needs prompt "
                             "latents")
        scope = full_f32() if self.dtype == torch.float32 else (
            contextlib.nullcontext())
        with scope:
            context, speaker = self._condition(ids, mask, prompt)
            s = self.guidance_scale
            if s != 1.0:
                null_ctx, null_spk = self._condition(
                    torch.zeros_like(ids), torch.zeros_like(mask),
                    None if prompt is None else torch.zeros_like(prompt))
                context = torch.cat([context, null_ctx])
                if speaker is not None:
                    speaker = torch.cat([speaker, null_spk])
            kv = cross_attention_kv(self.model.unet, context)

            def model_eps(x, t):
                if self.prompted:
                    return self.model.denoise(x, t, context, speaker,
                                              cross_kv=kv)
                return self.model.denoise(x, t, context, cross_kv=kv)

            def denoise(x, t):
                if s == 1.0:
                    return model_eps(x, t)
                eps_c, eps_u = model_eps(torch.cat([x, x]),
                                         torch.cat([t, t])).float().chunk(2)
                return eps_u + s * (eps_c - eps_u)

            sample = dpm_solver_sample if self.sampler == "dpm" else (
                ddim_sample)
            return sample(denoise, self.schedule, x_T,
                          self.num_inference_steps)

    def prompt_latents(self, prompt_wav=None, prompt_codes=None
                       ) -> torch.Tensor:
        """The prompt family's fixed-length prompt: ``prompt_codes``
        ``[B, n_q, Tp]`` (or ``prompt_wav`` ``[B, samples]`` @ 24 kHz,
        encoded first) -> latents zero-padded or cropped in latent space to
        ``prompt_frames``: ``[B, prompt_frames, n_q]`` f32 on the device."""
        if prompt_codes is None:
            if prompt_wav is None:
                raise ValueError("the prompt-conditioned model needs "
                                 "prompt_wav or prompt_codes")
            prompt_codes = self.codec_runner.encode(prompt_wav)
        lat = codes_to_latents(torch.as_tensor(prompt_codes,
                                               device=self.device))
        Tp = self.config.model.prompt_frames
        fixed = lat.new_zeros(lat.shape[0], Tp, lat.shape[2])
        n = min(Tp, lat.shape[1])
        fixed[:, :n] = lat[:, :n]
        return fixed

    @torch.no_grad()
    def synthesize(self, texts: Sequence[str], seed: int = 0,
                   x_T: Optional[torch.Tensor] = None,
                   return_codes: bool = False, pcm16: bool = False,
                   prompt_wav=None, prompt_codes=None):
        """texts -> f32 wav ``[B, frames*320]`` at 24 kHz as numpy (int16
        PCM with ``pcm16=True``); with ``return_codes`` also the codes
        ``[B, n_q, frames]``.  ``x_T`` ``[B, frames, n_q]`` replaces the
        noise drawn from ``seed`` (on a CPU generator, so one seed gives the
        same x_T on every device).  The prompt family takes ``prompt_wav``
        ``[B, samples]`` @ 24 kHz or ``prompt_codes`` ``[B, n_q, Tp]``."""
        mcfg = self.config.model
        ids, mask = self.tokenizer.encode_batch(list(texts))
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        prompt = (self.prompt_latents(prompt_wav, prompt_codes)
                  if self.prompted else None)
        if x_T is None:
            g = torch.Generator().manual_seed(seed)
            x_T = torch.randn((len(texts), mcfg.sample_size, mcfg.in_channels),
                              generator=g)
        latents = self.denoise_latents(x_T.to(self.device), ids, mask, prompt)
        codes = latents_to_codes(latents)
        wav = self.codec_runner.decode(codes)
        if pcm16:
            wav = wav_to_pcm16(wav)
        wav = wav.cpu().numpy()
        if return_codes:
            return wav, codes.cpu().numpy()
        return wav

    def decode_codes(self, codes) -> torch.Tensor:
        """int codes ``[B, n_q, T]`` -> wav (the decode_codec tool path)."""
        return self.codec_runner.decode(codes)

    def encode_audio(self, wav) -> torch.Tensor:
        """wav ``[B, T]`` @ 24 kHz -> int codes ``[B, 8, ceil(T/320)]``
        (6 kbps)."""
        return self.codec_runner.encode(wav)
