"""Prompt-conditioned synthesis: the PyTorch port against the JAX package.

Tiny prompt-family config (``__graft_entry__._dryrun_impl``'s widths with
``prompt_conditioning``), f32, dropout off.  JAX param trees are filled
from a numpy seed and loaded into the port through ``convert.py``; inputs,
x_T and prompt codes come from the same seed.  Tolerances: the model-level
5e-4 contract (ARCHITECTURE.md "Numerics contracts") for the model and the
sampled latents (f32 on both sides, summation order differs); 1e-5 for the
DPM-Solver++ update on a fixed linear denoiser (f32 tables from the same
f64 host computation).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu.config import Config as JaxConfig
from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.diffusion.dpm import dpm_solver_sample as jax_dpm
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxSingle
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu_torch.config import Config, ModelConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.diffusion.dpm import dpm_solver_sample
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.pipeline import Synthesizer

MODEL_TOL = LATENT_TOL = 5e-4
DPM_TOL = 1e-5
WIDTHS = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=48, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
JCFG = JaxModelConfig(prompt_conditioning=True, **WIDTHS)
CFG = ModelConfig(prompt_conditioning=True, **WIDTHS)
TEXTS = ["hello world", "printing, in the only sense"]
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: the shapes are tiny,
    and OpenMP's spinning worker threads stall when the suite's parallel
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """Params of the given shapes: fan-in-scaled kernels, non-trivial
    biases, norm scales and prompt queries."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name in ("bias", "queries") else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(model, rng, prompt: bool):
    B, S, T, C = 1, CFG.cmu_seq_len, CFG.sample_size, CFG.in_channels
    args = [jnp.zeros((B, T, C)), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, S), jnp.int32), jnp.ones((B, S), jnp.int32)]
    if prompt:
        args.append(jnp.zeros((B, CFG.prompt_frames, C)))
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args),
                 rng)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = _params(JaxPrompt(JCFG), rng, True)
    single = _params(JaxSingle(dataclasses.replace(
        JCFG, prompt_conditioning=False)), rng, False)
    codec = jax.tree.map(np.zeros_like, jax.eval_shape(
        lambda r, w: JaxCodec().init(r, w, 6.0), jax.random.PRNGKey(1),
        jnp.zeros((1, 3200))))
    B, T, C = len(TEXTS), CFG.sample_size, CFG.in_channels
    return dict(
        params=params, single=single, codec=codec,
        x_T=rng.standard_normal((B, T, C)).astype(np.float32),
        codes=rng.integers(0, 1024, (B, C, 30)),
        sample=rng.standard_normal((B, T, C)).astype(np.float32),
        prompt=(rng.standard_normal((B, CFG.prompt_frames, C)) * 0.5
                ).astype(np.float32),
        state=model_state_from_jax(jax.tree.map(np.asarray, params)),
        single_state=model_state_from_jax(jax.tree.map(np.asarray, single)))


def test_prompt_tree_loads_strict(setup):
    port = TTSPromptSpeaker(CFG)
    port.load_state_dict(setup["state"], strict=True)
    np.testing.assert_array_equal(
        port.prompt_encoder.queries.detach().numpy(),
        setup["params"]["params"]["prompt_encoder"]["queries"])


def test_model_matches_jax(setup):
    """encode_conditioning (text + prompt encoder) and the full forward."""
    model = JaxPrompt(JCFG)
    ids = np.array([[5, 17, 30, 2] + [0] * 28] * 2, np.int32)
    mask = (ids > 0).astype(np.int32)
    t = np.array([999, 17], np.int32)
    s, p = setup["sample"], setup["prompt"]

    @jax.jit
    def ref(params):
        ctx, spk = model.apply(params, ids, mask, p,
                               method=JaxPrompt.encode_conditioning)
        return ctx, spk, model.apply(params, s, t, ids, mask, p)

    ctx_j, spk_j, eps_j = ref(setup["params"])
    port = TTSPromptSpeaker(CFG)
    port.load_state_dict(setup["state"], strict=True)
    port.eval()
    args = [torch.from_numpy(a) for a in (ids, mask, p)]
    with torch.no_grad():
        ctx, spk = port.encode_conditioning(*args)
        eps = port(torch.from_numpy(s), torch.from_numpy(t), *args)
    assert ctx.shape == (2, CFG.cmu_seq_len + CFG.prompt_tokens,
                         CFG.cross_attention_dim)
    assert spk.shape == (2, 4 * CFG.block_out_channels[0])
    for got, want in ((ctx, ctx_j), (spk, spk_j), (eps, eps_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("steps", [25, 2])
def test_dpm_solver_matches_jax(steps):
    rng = np.random.default_rng(steps)
    x_T = rng.standard_normal((2, 12, 8)).astype(np.float32)

    def lin(x, t, xp):
        return 0.3 * x + 1e-4 * t.astype(x.dtype)[:, None, None] if xp is jnp \
            else 0.3 * x + 1e-4 * t.float()[:, None, None]

    ref = jax_dpm(lambda x, t: lin(x, t, jnp), jax_schedule(1000),
                  jnp.asarray(x_T), num_inference_steps=steps)
    out = dpm_solver_sample(lambda x, t: lin(x, t, torch), linear_schedule(),
                            torch.from_numpy(x_T), num_inference_steps=steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DPM_TOL,
                               rtol=0)


@pytest.fixture(scope="module")
def synth_pair(setup):
    """A JAX and a port Synthesizer per family on the same weights; the
    sampler and guidance are set per case."""
    def pair(jcfg, cfg, params, state):
        jsynth = JaxSynthesizer(config=JaxConfig(model=jcfg),
                                model_params=params,
                                codec_params=setup["codec"],
                                num_inference_steps=STEPS, dtype=jnp.float32)
        port = Synthesizer(config=Config(model=cfg), device="cpu",
                           dtype=torch.float32, num_inference_steps=STEPS,
                           model_state=state)
        return jsynth, port
    return {"prompt": pair(JCFG, CFG, setup["params"], setup["state"]),
            "single": pair(dataclasses.replace(JCFG, prompt_conditioning=False),
                           dataclasses.replace(CFG, prompt_conditioning=False),
                           setup["single"], setup["single_state"])}


def test_prompt_latents_pad_and_crop_as_jax(setup, synth_pair):
    """prompt_codes -> latents zero-padded or cropped to prompt_frames in
    latent space, as the JAX Synthesizer's ``_device_args``."""
    jsynth, port = synth_pair["prompt"]
    for n in (30, 10):
        codes = setup["codes"][..., :n]
        want = np.asarray(jsynth._device_args(TEXTS, 0,
                                              prompt_codes=codes)[3])
        got = port.prompt_latents(prompt_codes=codes)
        assert got.shape == (2, CFG.prompt_frames, 8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family,sampler,scale", [
    ("prompt", "ddim", 1.0), ("prompt", "ddim", 3.0), ("prompt", "dpm", 1.0),
    ("prompt", "dpm", 3.0), ("single", "dpm", 3.0)])
def test_synthesizer_latents_match_jax(setup, synth_pair, family, sampler,
                                       scale):
    """The sampled latents from the same x_T, text and prompt codes; CFG
    runs the conditional and the null branch as one doubled batch."""
    jsynth, port = synth_pair[family]
    jsynth.sampler = port.sampler = sampler
    jsynth.guidance_scale = port.guidance_scale = scale
    ids, mask = jsynth.tokenizer.encode_batch(TEXTS)
    x_T = setup["x_T"]
    prompt_j = prompt_p = None
    if family == "prompt":
        prompt_j = jsynth._device_args(TEXTS, 0,
                                       prompt_codes=setup["codes"])[3]
        prompt_p = port.prompt_latents(prompt_codes=setup["codes"])
    ref = jax.jit(jsynth._denoise_latents)(jsynth.model_params, x_T, ids,
                                           mask, prompt_j)
    out = port.denoise_latents(torch.from_numpy(x_T), torch.from_numpy(ids),
                               torch.from_numpy(mask), prompt_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LATENT_TOL,
                               rtol=0)


def test_prompt_wav_is_encode_then_prompt_codes(synth_pair):
    """A prompt wav goes through the codec's encoder and then the same
    pad/crop as prompt codes: 10000 samples (32 frames, cropped to 24) and
    3000 (10 frames, padded)."""
    _, port = synth_pair["prompt"]
    rng = np.random.default_rng(5)
    for n in (10000, 3000):
        wav = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
        codes = port.codec_runner.encode(wav)
        assert codes.shape[-1] == -(-n // 320)
        got = port.prompt_latents(prompt_wav=wav)
        torch.testing.assert_close(got,
                                   port.prompt_latents(prompt_codes=codes),
                                   atol=0, rtol=0)
        if n < 320 * CFG.prompt_frames:
            assert got[:, codes.shape[-1]:].abs().max() == 0


def test_cli_synthesize_prompt_dpm_on_cpu(tmp_path):
    """The prompt family through the CLI: a 22.05 kHz prompt wav (resampled
    to 24 kHz), DPM, CFG; one 24 kHz wav per text."""
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav
    cfg_path, wav_path = tmp_path / "prompt.json", tmp_path / "voice.wav"
    Config(model=CFG).to_json(str(cfg_path))
    t = np.arange(11025) / 22050.0
    write_wav(str(wav_path), (0.4 * np.sin(2 * np.pi * 180 * t)).astype(
        np.float32), 22050)
    paths, wavs, codes = cli.main([
        "--text", TEXTS[0], "--text", TEXTS[1], "--out",
        str(tmp_path / "out.wav"), "--config_file", str(cfg_path),
        "--prompt_wav", str(wav_path), "--sampler", "dpm", "--steps", "2",
        "--guidance_scale", "3", "--device", "cpu", "--dtype", "f32"])
    assert [os.path.basename(p) for p in paths] == ["out_0.wav", "out_1.wav"]
    for p in paths:
        audio, sr = read_wav(p)
        assert sr == 24000 and audio.shape[0] == CFG.sample_size * 320
    assert codes.shape == (2, 8, CFG.sample_size)
    assert np.isfinite(wavs).all()
