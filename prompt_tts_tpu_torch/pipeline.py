"""End-to-end synthesis: text (+ a voice prompt) -> phonemes -> denoising
-> codec -> wav.

Port of ``prompt_tts_tpu/pipeline.py``: both model families (the
single-speaker ``TTSSingleSpeaker`` and the prompt-conditioned
``TTSPromptSpeaker``, chosen by ``config.model.prompt_conditioning``), the
DDIM and DPM-Solver++(2M) samplers, and classifier-free guidance for both
families; synthesis in one call, dispatched without a host pull
(``synthesize_async``), streamed by growing code prefixes
(``synthesize_stream``), and long-form over several windows
(``synthesize_long``, ``synthesize_long_stream``).  Code normalization
contract: model latents live in [-1, 1] via ``c * 2/1023 - 1``; synthesis
inverts with round + clip before the codec decode.

Tensor parallelism: in a process group whose model axis has more than
one rank (``parallel.init_distributed(n_model=...)``), a ``Synthesizer``
holds its rank's slices of the denoiser (``parallel/tp.py``), and the
ranks of a model group run every call together, as one program: each
draws the same x_T from its seeded CPU generator, decodes with its whole
copy of the codec and returns the same wav (a CLI writes on rank 0).  A
server runs the calls on rank 0 only: :meth:`Synthesizer.lead` makes
rank 0 send each denoise's inputs to the group before it runs, and the
other ranks run them in :meth:`Synthesizer.follow`.

Sequence parallelism: in a process group whose seq axis has more than one
rank (``parallel.init_distributed(n_seq=...)``), the UNet runs latent time
sharded over the seq group (``parallel/sp.py``): every rank draws the
whole x_T, the UNet takes its slice of each level that divides the group
and returns the whole eps, so the sampler's state (``[B, T, n_q]``, a few
kilobytes) stays whole on every rank and the latents need no gather
before the rounding and the codec, which run whole on every rank.  A
server leads and follows as under tensor parallelism, over the ranks of
one data row (model x seq).
"""

import contextlib
import copy
import math
import re
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from prompt_tts_tpu_torch.config import Config
from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
from prompt_tts_tpu_torch.codec.layers import CodecLSTM
from prompt_tts_tpu_torch.diffusion.ddim import ddim_step
from prompt_tts_tpu_torch.diffusion.dpm import dpm_step
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.diffusion.steps import (
    SAMPLERS, initial_noise, run_steps, sampler_tables,
)
from prompt_tts_tpu_torch.models.embeddings import GaussianFourierProjection
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.prompt_encoder import PromptEncoder
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.unet1d import cross_attn_sites
from prompt_tts_tpu_torch.parallel import (
    block_group, block_rank, block_src, model_group, model_rank, model_size,
    seq_size,
)
from prompt_tts_tpu_torch.parallel.sp import mesh_seq, shard_seq_
from prompt_tts_tpu_torch.parallel.tp import shard_model_
from prompt_tts_tpu_torch.utils.precision import (  # noqa: F401
    _f32_scope, denoise_scope, full_f32,
)

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


def stream_scope(stream):
    """A scope that puts torch's work on ``stream`` (None: the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from the CPU ``generator``, in
    the manner of the JAX package's flax initializers: lecun-normal
    matmul/conv weights, zero biases, unit norm scales, xavier-uniform LSTM
    weights, unit-normal codebooks, N(0, 0.02) prompt queries, the Fourier
    time projection's N(0, scale^2) buffer.  The repo holds no checkpoint,
    so the port runs on weights like these; drawn on the CPU, one seed gives
    the same weights on every device."""
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
        elif isinstance(m, GaussianFourierProjection):
            normal_(m.weight, m.scale)
        elif isinstance(m, EncodecCodec):
            normal_(m.codebooks, 1.0)
        elif isinstance(m, PromptEncoder):
            normal_(m.queries, 0.02)
    return module


class CodecRunner:
    """The f32 EnCodec codec on one device: encode and decode, with TF32
    off.  ``lstm_schedule`` picks the LSTM kernel's schedule ("step" or
    "persistent"; None: the measured default, ``codec.layers.
    DEFAULT_LSTM_SCHEDULE``).  :meth:`at_dtype` gives a runner whose decode
    computes in another dtype over the same parameters."""

    def __init__(self, device, codec_state: Optional[dict] = None):
        self.device = torch.device(device)
        self.codec = EncodecCodec(device=self.device)
        if codec_state is not None:
            self.codec.load_state_dict(codec_state, strict=True)
        else:
            random_init_(self.codec,
                         torch.Generator().manual_seed(CODEC_INIT_SEED))
        self.codec.eval()

    def at_dtype(self, dtype: torch.dtype) -> "CodecRunner":
        """A runner over this one's parameters (shared, not copied) whose
        codec computes in ``dtype`` (JAX ``Synthesizer._codec_fast``);
        ``self`` for f32."""
        if dtype == self.codec.dtype:
            return self
        other = copy.copy(self)
        other.codec = self.codec.at_dtype(dtype)
        return other

    @torch.no_grad()
    def decode(self, codes, lstm_schedule: Optional[str] = None
               ) -> torch.Tensor:
        """int codes ``[B, n_q, T]`` -> wav ``[B, T*320]`` f32 @ 24 kHz."""
        codes = torch.as_tensor(codes, device=self.device)
        with full_f32():
            return self.codec.decode(codes,
                                     lstm_schedule=lstm_schedule).float()

    @torch.no_grad()
    def encode(self, wav, lstm_schedule: Optional[str] = None
               ) -> torch.Tensor:
        """wav ``[B, T]`` f32 @ 24 kHz -> int32 codes ``[B, 8, ceil(T/320)]``
        (6 kbps)."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        with full_f32():
            return self.codec.encode(wav, lstm_schedule=lstm_schedule)


class ConditionProgram(nn.Module):
    """A synthesis's conditioning, once a call: ids/mask ``[B, S]`` (and
    the prompt family's prompt latents ``[B, prompt_frames, n_q]``) -> the
    step program's ``cond``, a tuple of every cross-attention ``(k, v)`` of
    the UNet, flattened in ``cross_attn_sites`` order (hoisted out of the
    sampler loop), then the prompt family's speaker embedding.  Under
    classifier-free guidance (``guidance_scale`` != 1) the null branch --
    zero ids, zero mask and zero prompt latents -- is concatenated after
    the conditional rows.  It owns the encoders and the UNet's
    cross-attention ``to_k``/``to_v``, and no other weights."""

    def __init__(self, model: nn.Module, guidance_scale: float):
        super().__init__()
        self.prompted = isinstance(model, TTSPromptSpeaker)
        self.guidance_scale = guidance_scale
        self.text_encoder = model.text_encoder
        if self.prompted:
            self.prompt_encoder = model.prompt_encoder
        unet = model.unet
        attn2 = [getattr(getattr(getattr(unet, block), attn),
                         f"block_{l}").attn2
                 for block, attn, n in cross_attn_sites(unet.config)
                 for l in range(n)]
        # each site's (local, under tensor parallelism) head count
        self.num_heads = [a.num_heads for a in attn2]
        self.to_k = nn.ModuleList(a.to_k for a in attn2)
        self.to_v = nn.ModuleList(a.to_v for a in attn2)

    def encode(self, ids, mask, prompt=None):
        """(context, speaker_emb or None) for ids/mask (and the prompt
        family's prompt latents)."""
        context = self.text_encoder(ids, mask)
        if not self.prompted:
            return context, None
        tokens, speaker = self.prompt_encoder(prompt)
        return torch.cat([context, tokens.to(context.dtype)], dim=1), speaker

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                prompt: Optional[torch.Tensor] = None) -> tuple:
        context, speaker = self.encode(ids, mask, prompt)
        if self.guidance_scale != 1.0:
            null_ctx, null_spk = self.encode(
                torch.zeros_like(ids), torch.zeros_like(mask),
                None if prompt is None else torch.zeros_like(prompt))
            context = torch.cat([context, null_ctx])
            if speaker is not None:
                speaker = torch.cat([speaker, null_spk])
        B, S, _ = context.shape
        cond = []
        for to_k, to_v, heads in zip(self.to_k, self.to_v, self.num_heads):
            cond += [lin(context).reshape(B, S, heads, -1)
                     for lin in (to_k, to_v)]
        if speaker is not None:
            cond.append(speaker)
        return tuple(cond)


class StepProgram(nn.Module):
    """One sampler step: ``(t, coef, cond, state) -> state``.  ``t`` is the
    step's timestep ``[B]`` (int64), ``coef`` its table row
    (``diffusion.steps.sampler_tables``), ``cond`` the condition program's
    output and ``state`` ``(x,)`` for DDIM or ``(x, x0_prev)`` for
    DPM-Solver++(2M), f32.  The UNet's eps (under classifier-free guidance
    the conditional and null rows in one batch, ``eps_u + s (eps_c -
    eps_u)``), then :func:`~prompt_tts_tpu_torch.diffusion.ddim.ddim_step`
    or :func:`~prompt_tts_tpu_torch.diffusion.dpm.dpm_step`.  It owns the
    UNet."""

    def __init__(self, model: nn.Module, guidance_scale: float,
                 sampler: str):
        super().__init__()
        self.unet = model.unet
        self.prompted = isinstance(model, TTSPromptSpeaker)
        self.guidance_scale = guidance_scale
        self.sampler = sampler
        self.sites = list(cross_attn_sites(model.unet.config))

    def eps(self, x: torch.Tensor, t: torch.Tensor,
            cond: tuple) -> torch.Tensor:
        """The (guided) eps of the f32 state ``x`` at ``t``, in f32."""
        kv, i = {}, 0
        for block, attn, n in self.sites:
            kv.setdefault(block, {})[attn] = [
                (cond[i + 2 * l], cond[i + 2 * l + 1]) for l in range(n)]
            i += 2 * n
        speaker = cond[-1] if self.prompted else None
        s = self.guidance_scale
        if s == 1.0:
            return self.unet(x, t, None, cross_kv=kv,
                             class_emb=speaker).float()
        eps_c, eps_u = self.unet(torch.cat([x, x]), torch.cat([t, t]), None,
                                 cross_kv=kv,
                                 class_emb=speaker).float().chunk(2)
        return eps_u + s * (eps_c - eps_u)

    def forward(self, t: torch.Tensor, coef: torch.Tensor, cond: tuple,
                state: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        x = state[0]
        eps = self.eps(x, t, cond)
        if self.sampler == "dpm":
            return dpm_step(x, eps, state[1], coef[0], coef[1], coef[2],
                            coef[3])
        return (ddim_step(x, eps, coef[0], coef[1]),)


class FinishProgram(nn.Module):
    """Latents ``[B, T, n_q]`` -> ``(wav, codes)``: the codes rounded from
    the latents, the codec's decode in its dtype, the wav in f32 and with
    ``pcm16`` quantized to int16 PCM on the device.  The decode is the
    runner's (:meth:`CodecRunner.decode`, TF32 off), whose codec this
    program owns as a registered submodule, so an export takes its weights
    as the program's state."""

    def __init__(self, runner: "CodecRunner", pcm16: bool):
        super().__init__()
        self.runner = runner
        self.codec = runner.codec
        self.pcm16 = pcm16

    def forward(self, latents: torch.Tensor):
        codes = latents_to_codes(latents)
        wav = self.runner.decode(codes)
        if self.pcm16:
            wav = wav_to_pcm16(wav)
        return wav, codes


class Synthesizer:
    """Owns the model and codec and runs text (+ a voice prompt) -> wav.

    The denoiser computes in ``dtype`` (bf16 by default) over params drawn
    or loaded in f32; the codec decodes in ``codec_dtype`` (f32 by default;
    bf16 is the optional fast decode: a second codec over the same f32
    parameters, for every decode of a synthesis, streamed or long-form;
    the prompt's encode and :meth:`decode_codes` stay f32).  ``model_state`` /
    ``codec_state`` are port state dicts (see ``convert.py``); without them
    the weights are random, drawn from CPU ``torch.Generator``s with fixed
    seeds, so every device gets the same weights.  ``sampler`` is "ddim"
    or "dpm" (DPM-Solver++(2M)); ``guidance_scale`` != 1 runs
    classifier-free guidance, the conditional and null branches
    concatenated on the batch axis.  A prompt-conditioned config
    (``prompt_conditioning``) builds ``TTSPromptSpeaker``, which takes a
    voice prompt per request.

    A call runs three programs (nn.Modules over the model's and codec's
    own weights, which ``aot.export_synthesis`` exports as they are): the
    conditioning (:class:`ConditionProgram`), one sampler step a step
    (:class:`StepProgram`, run by ``diffusion.steps.run_steps``) and the
    decode (:class:`FinishProgram`).  On the CPU the UNet's resnet blocks
    take the fused kernel's plain version on packed weights, as the card
    takes the kernel.

    On the card a call's device work goes on the caller's current stream:
    several threads may call at once, each on a stream of its own.

    In a process group with a model axis of ``tp > 1`` ranks the denoiser
    is sharded by ``parallel/tp.py``'s rules, and with a seq axis of ``sp
    > 1`` ranks its latent time by ``parallel/sp.py``'s; every rank of the
    data row makes the same calls (see the module docstring); ``tp`` and
    ``sp`` are those sizes.
    """

    def __init__(self, config: Optional[Config] = None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 num_inference_steps: int = 50,
                 model_state: Optional[dict] = None,
                 codec_state: Optional[dict] = None,
                 sampler: str = "ddim", guidance_scale: float = 1.0,
                 codec_dtype: torch.dtype = torch.float32):
        if sampler not in SAMPLERS:
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
        self.tp = model_size()
        if self.tp > 1:
            shard_model_(self.model, model_rank(), self.tp, model_group())
        self.sp = seq_size()
        shard_seq_(self.model, mesh_seq())
        # set by lead(): the lock that holds one denoise's broadcast and
        # collectives together
        self._leading = None
        cast_compute_(self.model.eval(), dtype, pack_cpu=True)
        self.codec_runner = CodecRunner(self.device, codec_state)
        self.codec_fast = self.codec_runner.at_dtype(codec_dtype)
        self.schedule = linear_schedule(
            self.config.train.num_train_timesteps, device=self.device)
        self.tokenizer = Tokenizer(max_len=mcfg.cmu_seq_len)
        # the programs and tables of the current sampler settings, which
        # callers may change between calls
        self._programs: dict = {}
        # the first setting's table goes to the device here, before any
        # call, as the schedule does: a stream a server makes later waits
        # on the work queued before it
        self._device_tables()

    def _cached(self, key, make):
        if key not in self._programs:
            self._programs[key] = make()
        return self._programs[key]

    def condition_program(self) -> ConditionProgram:
        """The conditioning program at the current guidance scale."""
        return self._cached(("condition", self.guidance_scale),
                            lambda: ConditionProgram(self.model,
                                                     self.guidance_scale))

    def step_program(self) -> StepProgram:
        """The step program of the current sampler and guidance scale."""
        return self._cached(
            ("step", self.sampler, self.guidance_scale),
            lambda: StepProgram(self.model, self.guidance_scale,
                                self.sampler))

    def finish_program(self, pcm16: bool) -> FinishProgram:
        """The decode program (int16 PCM out with ``pcm16``)."""
        return self._cached(("finish", bool(pcm16)),
                            lambda: FinishProgram(self.codec_fast,
                                                  bool(pcm16)))

    def sampler_tables(self):
        """``(ts, coef)`` of the current sampler and step count, ``coef``
        the f32 table ``[N, k]`` as host numpy
        (``diffusion.steps.sampler_tables``), from this device's schedule."""
        return self._cached(
            ("tables", self.sampler, self.num_inference_steps),
            lambda: sampler_tables(
                self.sampler, self.schedule.alphas_cumprod.cpu().numpy(),
                self.num_inference_steps))

    def _device_tables(self):
        """:meth:`sampler_tables` with ``coef`` on the device, uploaded once
        a setting."""
        ts, coef = self.sampler_tables()
        return ts, self._cached(
            ("coef", self.sampler, self.num_inference_steps),
            lambda: torch.from_numpy(coef).to(self.device))

    def _stream(self):
        """The caller's current stream, where a call's device work goes
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def _upload(self, x) -> torch.Tensor:
        """A host array on the device.  On the card it goes through pinned
        memory without a wait: a copy from pageable memory would
        synchronise the stream with the work already queued on it."""
        t = torch.as_tensor(x)
        if self.device.type != "cuda" or t.device.type != "cpu":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def noise(self, seed: int, batch: int) -> torch.Tensor:
        """x_T ``[batch, sample_size, in_channels]`` for ``seed``, drawn on
        a CPU generator, so one seed gives the same x_T on every device.
        Every entry point draws its noise here."""
        mcfg = self.config.model
        return initial_noise(seed, (batch, mcfg.sample_size,
                                    mcfg.in_channels))

    def _condition(self, ids, mask, prompt):
        """(context, speaker_emb or None) for ids/mask (and the prompt
        latents of the prompt family)."""
        return self.condition_program().encode(ids, mask, prompt)

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
        if self._leading is not None:
            with self._leading:
                self._send((x_T, ids, mask, prompt))
                return self._denoise(x_T, ids, mask, prompt)
        return self._denoise(x_T, ids, mask, prompt)

    def _denoise(self, x_T, ids, mask, prompt):
        ts, coef = self._device_tables()
        with denoise_scope(self.dtype):
            cond = self.condition_program()(
                ids, mask, *((prompt,) if self.prompted else ()))
            return run_steps(self.step_program(), cond, x_T, ts, coef,
                             self.sampler)

    def _send(self, inputs) -> None:
        """Broadcast a denoise's inputs and the sampler settings to the
        data row's ranks (None: the followers return)."""
        msg = None
        if inputs is not None:
            msg = (tuple(None if t is None else t.cpu() for t in inputs),
                   (self.sampler, self.num_inference_steps,
                    self.guidance_scale))
        torch.distributed.broadcast_object_list(
            [msg], src=block_src(), group=block_group())

    def lead(self) -> None:
        """On rank 0 of a data row of more than one rank (``tp`` or ``sp``
        > 1): from now on every denoise first sends its inputs (x_T, ids,
        mask, prompt latents) and the sampler, step count and guidance
        scale to the row, whose other ranks run it in :meth:`follow`; one
        denoise at a time, from any thread.  :meth:`release` ends the
        followers."""
        if self.tp * self.sp == 1 or block_rank() != 0:
            raise ValueError("lead() is for rank 0 of a model x seq group "
                             "of more than one rank")
        self._leading = threading.Lock()

    def release(self) -> None:
        """Tell the followers to return (rank 0, after :meth:`lead`)."""
        if self._leading is not None:
            with self._leading:
                self._send(None)
            self._leading = None

    @torch.no_grad()
    def follow(self) -> int:
        """On the other ranks of a data row: run each denoise rank 0 sends
        (:meth:`lead`), with its settings, until it releases the row.
        Returns the number of denoises run."""
        if self.tp * self.sp == 1 or block_rank() == 0:
            raise ValueError("follow() is for the ranks other than 0 of a "
                             "model x seq group of more than one rank")
        n = 0
        while True:
            box = [None]
            torch.distributed.broadcast_object_list(
                box, src=block_src(), group=block_group())
            if box[0] is None:
                return n
            inputs, settings = box[0]
            (self.sampler, self.num_inference_steps,
             self.guidance_scale) = settings
            x_T, ids, mask, prompt = (
                None if t is None else t.to(self.device) for t in inputs)
            self._denoise(x_T, ids, mask, prompt)
            n += 1

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
        lat = codes_to_latents(self._upload(prompt_codes))
        Tp = self.config.model.prompt_frames
        fixed = lat.new_zeros(lat.shape[0], Tp, lat.shape[2])
        n = min(Tp, lat.shape[1])
        fixed[:, :n] = lat[:, :n]
        return fixed

    def _latents(self, texts, seed, x_T, prompt_wav, prompt_codes
                 ) -> torch.Tensor:
        """Tokenize, draw x_T (unless given) and denoise: latents ``[B,
        frames, n_q]`` on the device, on the current stream."""
        ids, mask = self.tokenizer.encode_batch(list(texts))
        prompt = (self.prompt_latents(prompt_wav, prompt_codes)
                  if self.prompted else None)
        if x_T is None:
            x_T = self.noise(seed, len(texts))
        return self.denoise_latents(self._upload(x_T), self._upload(ids),
                                    self._upload(mask), prompt)

    def _codes(self, texts, seed, x_T, prompt_wav, prompt_codes
               ) -> torch.Tensor:
        """:meth:`_latents` rounded: int codes ``[B, n_q, frames]``."""
        return latents_to_codes(self._latents(texts, seed, x_T, prompt_wav,
                                              prompt_codes))

    @torch.no_grad()
    def _dispatch(self, texts, seed, x_T, prompt_wav, prompt_codes, pcm16):
        """Enqueue the whole program on the current stream: ``(wav, codes,
        event)`` on the device, the event (None on the CPU) recorded after
        the last kernel."""
        latents = self._latents(texts, seed, x_T, prompt_wav, prompt_codes)
        wav, codes = self.finish_program(pcm16)(latents)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return wav, codes, event

    def synthesize_async(self, texts: Sequence[str], seed: int = 0,
                         prompt_wav=None, prompt_codes=None,
                         pcm16: bool = False):
        """Enqueue synthesis without a host pull: ``(wav, event)``, the wav
        ``[B, frames*320]`` on the device (int16 PCM quantized there with
        ``pcm16=True``) and a CUDA event recorded after its last kernel
        (None on the CPU, where the call has finished).  Arguments as
        :meth:`synthesize`.  Another thread may wait on the event and then
        copy the wav out."""
        wav, _, event = self._dispatch(texts, seed, None, prompt_wav,
                                       prompt_codes, pcm16)
        return wav, event

    @torch.no_grad()
    def synthesize(self, texts: Sequence[str], seed: int = 0,
                   x_T: Optional[torch.Tensor] = None,
                   return_codes: bool = False, pcm16: bool = False,
                   prompt_wav=None, prompt_codes=None):
        """texts -> f32 wav ``[B, frames*320]`` at 24 kHz as numpy (int16
        PCM with ``pcm16=True``); with ``return_codes`` also the codes
        ``[B, n_q, frames]``.  ``x_T`` ``[B, frames, n_q]`` replaces the
        noise drawn from ``seed`` (:meth:`noise`).  The prompt family takes
        ``prompt_wav`` ``[B, samples]`` @ 24 kHz or ``prompt_codes``
        ``[B, n_q, Tp]``.  The same program as :meth:`synthesize_async`,
        then the pull."""
        wav, codes, event = self._dispatch(texts, seed, x_T, prompt_wav,
                                           prompt_codes, pcm16)
        if event is not None:
            event.synchronize()
        wav = wav.cpu().numpy()
        if return_codes:
            return wav, codes.cpu().numpy()
        return wav

    def synthesize_stream(self, texts: Sequence[str], seed: int = 0,
                          chunk_frames: int = 300, prompt_wav=None,
                          prompt_codes=None, pcm16: bool = False):
        """Yield wav chunks ``[B, chunk*320]`` as host numpy, f32 (int16
        PCM with ``pcm16=True``), as they decode.

        The codes are denoised once; then each growing prefix
        ``codes[:, :, :end]`` is decoded and its new samples yielded.  The
        SEANet decoder is causal, so a prefix's decode is the prefix of the
        full decode, and the first audio leaves after one prefix decode
        instead of the whole window's."""
        # a generator runs on whichever stream its consumer has current:
        # hold every step to the stream of the first
        stream = self._stream()
        with stream_scope(stream):
            codes = self._codes(texts, seed, None, prompt_wav, prompt_codes)
        yield from self._decode_stream(codes, chunk_frames, pcm16, stream)

    def _decode_stream(self, codes, chunk_frames, pcm16, stream=None):
        """The prefix decodes of :meth:`synthesize_stream` for int codes
        ``[B, n_q, T]``, on ``stream``."""
        T = codes.shape[-1]
        bounds = list(range(chunk_frames, T, chunk_frames)) + [T]
        prev = 0
        for end in bounds:
            with stream_scope(stream):
                wav = self.codec_fast.decode(
                    codes[:, :, :end].contiguous())[:, prev * 320:end * 320]
                if pcm16:
                    wav = wav_to_pcm16(wav)
                wav = wav.cpu().numpy()
            yield wav
            prev = end

    def split_long_text(self, text: str) -> list:
        """Split ``text`` into chunks whose token sequences fit the model.

        Sentences (split on ``.!?;`` + whitespace) are greedily packed up
        to ``cmu_seq_len`` tokens; a single overlong sentence is hard-split
        on word boundaries."""
        limit = self.config.model.cmu_seq_len
        sentences = [s for s in re.split(r"(?<=[.!?;])\s+", text.strip())
                     if s]

        def n_tokens(t: str) -> int:
            return len(self.tokenizer.ids(t))

        # hard-split any single sentence that alone exceeds the limit
        units: list = []
        for s in sentences:
            if n_tokens(s) <= limit:
                units.append(s)
                continue
            cur = ""
            for w in s.split():
                cand = (cur + " " + w).strip()
                if cur and n_tokens(cand) > limit:
                    units.append(cur)
                    cur = w
                else:
                    cur = cand
            if cur:
                units.append(cur)

        chunks: list = []
        cur = ""
        for u in units:
            cand = (cur + " " + u).strip()
            if cur and n_tokens(cand) > limit:
                chunks.append(cur)
                cur = u
            else:
                cur = cand
        if cur:
            chunks.append(cur)
        return chunks or [""]

    def _continuity_tail(self, codes: np.ndarray, wav_len: int):
        """The last ``prompt_frames`` spoken code frames of a window (codes
        ``[n_q, T]``, ``wav_len`` its sample count after the trim): the
        next window's continuity prompt ``[1, n_q, <= prompt_frames]``."""
        Tp = self.config.model.prompt_frames
        end = max(1, min(codes.shape[-1], -(-wav_len // 320)))
        return codes[None, :, max(0, end - Tp): end]

    def synthesize_long(self, text: str, seed: int = 0, max_batch: int = 8,
                        trim_threshold_db: Optional[float] = -40.0,
                        prompt_wav=None, prompt_codes=None,
                        pcm16: bool = False, pad_groups: bool = False,
                        crossfade_ms: float = 0.0,
                        continuity_prompt: bool = False) -> np.ndarray:
        """Long-form synthesis: split -> synthesize in groups of
        ``max_batch`` windows -> trim each -> join, as host numpy.

        Group k, which starts at chunk i, draws its noise from ``seed + i``;
        a trailing partial group is padded to ``max_batch`` with empty
        texts when there is more than one group or with ``pad_groups``
        (a server keeps to the batch size it warmed up).  Trailing silence
        is trimmed per window (``trim_threshold_db``; None keeps whole
        windows), and ``crossfade_ms > 0`` joins the windows with an
        equal-power crossfade.  ``continuity_prompt`` (prompt family only)
        runs the windows one by one, window i from ``seed + i``, each
        prompted by the previous window's spoken tail codes; the user's
        prompt conditions the first."""
        from prompt_tts_tpu_torch.utils.wav import (
            crossfade_join, trim_trailing_silence,
        )
        if continuity_prompt and not self.prompted:
            raise ValueError("continuity_prompt needs the prompt-"
                             "conditioned model family")
        chunks = self.split_long_text(text)
        pieces = []
        if continuity_prompt:
            prev_tail = None
            for i, chunk in enumerate(chunks):
                group = [chunk]
                if pad_groups:
                    group = group + [""] * (max_batch - 1)
                if prev_tail is None:
                    kw = dict(prompt_wav=_repeat(prompt_wav, len(group)),
                              prompt_codes=_repeat(prompt_codes, len(group)))
                else:
                    kw = dict(prompt_codes=np.repeat(prev_tail, len(group),
                                                     0))
                wavs, codes = self.synthesize(group, seed=seed + i,
                                              pcm16=pcm16,
                                              return_codes=True, **kw)
                wav = wavs[0]
                if trim_threshold_db is not None:
                    wav = trim_trailing_silence(
                        wav, threshold_db=trim_threshold_db)
                prev_tail = self._continuity_tail(codes[0], len(wav))
                pieces.append(wav)
        else:
            for i in range(0, len(chunks), max_batch):
                group = chunks[i:i + max_batch]
                n_real = len(group)
                if ((pad_groups or len(chunks) > max_batch)
                        and n_real < max_batch):
                    group = group + [""] * (max_batch - n_real)
                kw = {}
                if self.prompted:
                    kw = dict(prompt_wav=_repeat(prompt_wav, len(group)),
                              prompt_codes=_repeat(prompt_codes, len(group)))
                wavs = self.synthesize(group, seed=seed + i, pcm16=pcm16,
                                       **kw)[:n_real]
                for wav in wavs:
                    if trim_threshold_db is not None:
                        wav = trim_trailing_silence(
                            wav, threshold_db=trim_threshold_db)
                    pieces.append(wav)
        if not pieces:
            return np.zeros(0, dtype=np.int16 if pcm16 else np.float32)
        if crossfade_ms > 0.0:
            return crossfade_join(pieces, int(crossfade_ms * 24))
        return np.concatenate(pieces)

    def synthesize_long_stream(self, text: str, seed: int = 0,
                               trim_threshold_db: Optional[float] = -40.0,
                               prompt_wav=None, prompt_codes=None,
                               pcm16: bool = False, crossfade_ms: float = 0.0,
                               continuity_prompt: bool = False):
        """Yield one trimmed wav piece per window of a long text, as host
        numpy.

        Window i is synthesized at batch 1 from ``seed + i`` (through
        :meth:`synthesize_stream` with one chunk, or :meth:`synthesize`
        under ``continuity_prompt``) and yielded as soon as it is trimmed.
        With ``crossfade_ms > 0`` each piece's overlap tail is held back
        until the next window arrives and the last is yielded at the end,
        so the concatenated stream is :meth:`synthesize_long`'s crossfaded
        wav at ``max_batch=1``."""
        from prompt_tts_tpu_torch.utils.wav import (
            crossfade_join, trim_trailing_silence,
        )
        if continuity_prompt and not self.prompted:
            raise ValueError("continuity_prompt needs the prompt-"
                             "conditioned model family")
        T = self.config.model.sample_size
        n_fade = int(crossfade_ms * 24) if crossfade_ms > 0 else 0
        kw = {}
        if self.prompted:
            kw = dict(prompt_wav=prompt_wav, prompt_codes=prompt_codes)
        held = None  # the previous piece's held-back crossfade tail
        for i, chunk in enumerate(self.split_long_text(text)):
            if continuity_prompt:
                wavs, codes = self.synthesize([chunk], seed=seed + i,
                                              pcm16=pcm16,
                                              return_codes=True, **kw)
                wav = wavs[0]
            else:
                pieces = list(self.synthesize_stream(
                    [chunk], seed=seed + i, chunk_frames=T, pcm16=pcm16,
                    **kw))
                wav = np.concatenate(pieces, axis=1)[0]
            if trim_threshold_db is not None:
                wav = trim_trailing_silence(
                    wav, threshold_db=trim_threshold_db)
            if continuity_prompt:
                kw = dict(prompt_codes=self._continuity_tail(
                    codes[0], len(wav)))
            if n_fade > 0:
                if held is not None:
                    wav = crossfade_join([held, wav], n_fade)
                k = min(n_fade, len(wav))
                held, wav = wav[len(wav) - k:], wav[: len(wav) - k]
                if len(wav) == 0:
                    continue
            yield wav
        if held is not None and len(held):
            yield held

    def decode_codes(self, codes) -> torch.Tensor:
        """int codes ``[B, n_q, T]`` -> wav (the decode_codec tool path)."""
        return self.codec_runner.decode(codes)

    def encode_audio(self, wav) -> torch.Tensor:
        """wav ``[B, T]`` @ 24 kHz -> int codes ``[B, 8, ceil(T/320)]``
        (6 kbps)."""
        return self.codec_runner.encode(wav)


def _repeat(a, n: int):
    """The first row of a prompt array repeated ``n`` times (None stays
    None)."""
    return None if a is None else np.repeat(np.asarray(a)[:1], n, 0)
