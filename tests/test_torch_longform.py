"""The rest of the port's ``Synthesizer`` against the JAX package: prefix
streaming, long-form synthesis (split, seed schedule, padding, trim,
crossfade, continuity prompt) and the dispatch without a pull; and the
process-wide ``full_f32`` scope under two threads.

Tiny models (24-frame windows, 2 steps) and the full-width f32 codec, on
the same weights (JAX param trees filled from a numpy seed, converted with
``convert.py``).  The JAX ``Synthesizer``s trace with
``PROMPT_TTS_FOLDED_DECODE=0`` (the stock decoder, which the port is held
to).  JAX draws a window's noise as ``jax.random.normal(PRNGKey(s))``; the
port's is injected per seed through ``Synthesizer.noise``.  Every JAX
reference is computed once, in the module fixture.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu.config import Config as JaxConfig
from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxSingle
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu_torch import pipeline
from prompt_tts_tpu_torch.config import Config, ModelConfig
from prompt_tts_tpu_torch.convert import (
    codec_state_from_jax, model_state_from_jax,
)
from prompt_tts_tpu_torch.pipeline import Synthesizer

# the wav decoded from equal codes: the codec's 1e-5 decode contract
WAV_TOL = 1e-5
# codes: a latent within the 5e-4 model contract may round to the
# neighbouring code at a .5 boundary; at most 0.1% may differ, by 1
MAX_FLIP_SHARE = 1e-3
WIDTHS = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=24, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0)
PROMPT = dict(prompt_conditioning=True, prompt_frames=8,
              prompt_encoder_layers=1, prompt_tokens=4)
STEPS = 2
T = WIDTHS["sample_size"]
# five chunks at cmu_seq_len 32: three groups at max_batch 2, the last
# padded
LONG = "Hello there. General synthesis! Another sentence here."
SPLIT_TEXTS = [
    LONG,
    "The first sentence. A second one follows! Then a third; and a "
    "fourth? Finally the fifth.",
    # one sentence over the limit: hard-split on words, and single words
    # over the limit kept whole
    "supercalifragilistic expialidocious antidisestablishmentarianism "
    "pneumonoultramicroscopic silicovolcanoconiosis",
    "Short.",
    "",
]


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
    """Params of the given shapes: fan-in-scaled kernels and LSTM weights,
    unit-normal embeddings and codebooks, non-trivial biases, norm scales
    and prompt queries."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if "_w_" in name:
            return x / np.sqrt(s.shape[1])
        if name == "scale":
            return 1.0 + 0.1 * x
        if name in ("bias", "l0_b", "l1_b", "queries"):
            return 0.1 * x
        return x
    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _model_params(model, cfg, rng):
    S, C = cfg.cmu_seq_len, cfg.in_channels
    args = [jnp.zeros((1, T, C)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, S), jnp.int32), jnp.ones((1, S), jnp.int32)]
    if cfg.prompt_conditioning:
        args.append(jnp.zeros((1, cfg.prompt_frames, C)))
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args),
                 rng)


def jax_noise(seed: int, batch: int) -> torch.Tensor:
    """The x_T JAX's ``_device_args`` draws for ``seed``."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (batch, T, 8))))


def _pair(widths, mparams, cparams):
    jsynth = JaxSynthesizer(config=JaxConfig(model=JaxModelConfig(**widths)),
                            model_params=mparams, codec_params=cparams,
                            num_inference_steps=STEPS, dtype=jnp.float32)
    port = Synthesizer(config=Config(model=ModelConfig(**widths)),
                       device="cpu", dtype=torch.float32,
                       num_inference_steps=STEPS,
                       model_state=model_state_from_jax(mparams),
                       codec_state=codec_state_from_jax(cparams))
    port.noise = jax_noise
    return jsynth, port


def _key(texts, seed, prompt_codes):
    pc = None if prompt_codes is None else np.asarray(prompt_codes)
    return (tuple(texts), seed,
            None if pc is None else (pc.shape, pc.tobytes()))


def _recording(jsynth, record):
    """Wrap ``jsynth.synthesize`` to record each call's codes under its
    texts, seed and prompt codes."""
    orig = jsynth.synthesize

    def synthesize(texts, seed=0, return_codes=False, prompt_codes=None,
                   **kw):
        wav, codes = orig(texts, seed=seed, return_codes=True,
                          prompt_codes=prompt_codes, **kw)
        record[_key(texts, seed, prompt_codes)] = np.array(codes)
        return (wav, codes) if return_codes else wav
    jsynth.synthesize = synthesize


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    single_cfg = JaxModelConfig(**WIDTHS)
    prompt_cfg = JaxModelConfig(**WIDTHS, **PROMPT)
    single = _model_params(JaxSingle(single_cfg), single_cfg, rng)
    prompted = _model_params(JaxPrompt(prompt_cfg), prompt_cfg, rng)
    cparams = _fill(jax.eval_shape(
        lambda r, w: JaxCodec().init(r, w, 6.0), jax.random.PRNGKey(1),
        jnp.zeros((1, 3200))), rng)
    prompt_codes = rng.integers(0, 1024, (1, 8, 6)).astype(np.int32)
    out = {"prompt_codes": prompt_codes, "codes": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROMPT_TTS_FOLDED_DECODE", "0")
        jsynth, port = _pair(WIDTHS, single, cparams)
        jprompt, pport = _pair(dict(WIDTHS, **PROMPT), prompted, cparams)
        out["split"] = [jsynth.split_long_text(t) for t in SPLIT_TEXTS]
        out["stream"] = np.concatenate(list(jsynth.synthesize_stream(
            ["hello stream"], seed=3, chunk_frames=T // 2)), axis=1)
        out["stream_codes"] = np.array(jsynth._codes_fn(
            jsynth.model_params, *jsynth._device_args(["hello stream"], 3)))
        _recording(jsynth, out["codes"])
        _recording(jprompt, out["codes"])
        for fade in (0.0, 10.0):
            out[f"long_{fade}"] = jsynth.synthesize_long(
                LONG, seed=5, max_batch=2, crossfade_ms=fade)
        out["continuity"] = jprompt.synthesize_long(
            LONG, seed=7, max_batch=2, prompt_codes=prompt_codes,
            crossfade_ms=10.0, continuity_prompt=True)
        # the latents of each group of the long schedule: starts 0, 2, 4
        chunks = jsynth.split_long_text(LONG)
        out["long_groups"] = [((chunks[i:i + 2] + [""])[:2], 5 + i)
                              for i in range(0, len(chunks), 2)]
        denoise = jax.jit(jsynth._denoise_latents)
        out["long_latents"] = [np.asarray(denoise(
            jsynth.model_params, *jsynth._device_args(g, s)))
            for g, s in out["long_groups"]]
    out.update(port=port, pport=pport)
    return out


def _flip_rule(got, want):
    """Codes of the port's latents ``got`` against JAX's ``want`` [B, T,
    n_q], both within the 5e-4 model contract: each code that differs is
    off by one at a JAX latent within 5e-4 of a rounding boundary, and at
    most max(1, 0.1 %) of the codes differ."""
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    c = (want + 1.0) * (1023.0 / 2.0)
    diff = np.abs(np.clip(np.round((got + 1.0) * (1023.0 / 2.0)), 0, 1023)
                  - np.clip(np.round(c), 0, 1023))
    assert diff.max() <= 1
    assert np.all(np.abs(c - np.floor(c) - 0.5)[diff > 0]
                  <= 5e-4 * 1023.0 / 2.0)
    assert (diff > 0).sum() <= max(1, MAX_FLIP_SHARE * diff.size)


def _from_jax_codes(monkeypatch, synth, codes):
    """Make ``synth`` denoise to the codes JAX made for the same texts,
    seed and prompt codes: the long-form composition is then held on equal
    codes, and a window whose seed, padding or prompt differs from JAX's
    finds none."""
    def lookup(texts, seed, x_T, prompt_wav, prompt_codes):
        return torch.from_numpy(codes[_key(texts, seed, prompt_codes)])
    monkeypatch.setattr(synth, "_codes", lookup)


@pytest.mark.parametrize("i", range(len(SPLIT_TEXTS)))
def test_split_long_text_matches_jax(ref, i):
    assert ref["port"].split_long_text(SPLIT_TEXTS[i]) == ref["split"][i]


def test_split_packs_long_text_into_more_chunks_than_a_batch(ref):
    chunks = ref["split"][0]
    assert len(chunks) == 5
    limit = WIDTHS["cmu_seq_len"]
    tok = ref["port"].tokenizer
    assert all(len(tok.ids(c)) <= limit for c in chunks)


def test_continuity_tail_matches_jax(ref):
    jsynth = JaxSynthesizer.__new__(JaxSynthesizer)
    jsynth.config = JaxConfig(model=JaxModelConfig(**WIDTHS, **PROMPT))
    codes = np.arange(8 * T).reshape(8, T)
    for wav_len in (0, 1, 320, 321, 5 * 320, T * 320, 2 * T * 320):
        np.testing.assert_array_equal(
            ref["pport"]._continuity_tail(codes, wav_len),
            jsynth._continuity_tail(codes, wav_len))


def test_synthesize_stream_matches_jax(ref):
    port = ref["port"]
    chunks = list(port.synthesize_stream(["hello stream"], seed=3,
                                         chunk_frames=T // 2))
    assert [c.shape for c in chunks] == [(1, T // 2 * 320)] * 2
    _, codes = port.synthesize(["hello stream"], seed=3, return_codes=True)
    diff = np.abs(codes.astype(np.int64) - ref["stream_codes"])
    assert diff.max() <= 1
    assert (diff > 0).sum() <= max(1, MAX_FLIP_SHARE * diff.size)
    # the port's prefix decodes of JAX's codes, against JAX's stream
    same = np.concatenate(list(port._decode_stream(
        torch.from_numpy(ref["stream_codes"]), T // 2, False)), axis=1)
    np.testing.assert_allclose(same, ref["stream"], atol=WAV_TOL, rtol=0)
    # and the port's stream is its prefix decodes of its own codes
    own = np.concatenate(list(port._decode_stream(
        torch.from_numpy(codes), T // 2, False)), axis=1)
    assert np.concatenate(chunks, axis=1).tobytes() == own.tobytes()


def test_long_groups_denoise_as_jax(ref):
    """Each group of the long schedule (group k from seed + its start
    index, the last padded with an empty text), from JAX's noise: the
    port's latents and codes against JAX's."""
    port = ref["port"]
    assert [s for _, s in ref["long_groups"]] == [5, 7, 9]
    assert ref["long_groups"][-1][0][1] == ""
    for (g, seed), want in zip(ref["long_groups"], ref["long_latents"]):
        ids, mask = port.tokenizer.encode_batch(g)
        got = port.denoise_latents(port.noise(seed, len(g)),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(mask))
        _flip_rule(got.numpy(), want)


@pytest.mark.parametrize("fade", [0.0, 10.0])
def test_synthesize_long_matches_jax(ref, fade, monkeypatch):
    _from_jax_codes(monkeypatch, ref["port"], ref["codes"])
    wav = ref["port"].synthesize_long(LONG, seed=5, max_batch=2,
                                      crossfade_ms=fade)
    want = ref[f"long_{fade}"]
    assert wav.dtype == want.dtype == np.float32
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=WAV_TOL, rtol=0)


def test_continuity_prompt_matches_jax(ref, monkeypatch):
    _from_jax_codes(monkeypatch, ref["pport"], ref["codes"])
    wav = ref["pport"].synthesize_long(
        LONG, seed=7, max_batch=2, prompt_codes=ref["prompt_codes"],
        crossfade_ms=10.0, continuity_prompt=True)
    assert wav.shape == ref["continuity"].shape
    np.testing.assert_allclose(wav, ref["continuity"], atol=WAV_TOL, rtol=0)


@pytest.mark.parametrize("case", ["crossfade_pcm16", "continuity"])
def test_long_stream_is_synthesize_long(ref, case):
    """Bit-equal at max_batch=1, where both synthesize window i alone from
    seed + i."""
    if case == "continuity":
        synth = ref["pport"]
        kw = dict(prompt_codes=ref["prompt_codes"], continuity_prompt=True,
                  crossfade_ms=10.0)
    else:
        synth = ref["port"]
        kw = dict(pcm16=True, crossfade_ms=10.0)
    whole = synth.synthesize_long(LONG, seed=11, max_batch=1, **kw)
    pieces = list(synth.synthesize_long_stream(LONG, seed=11, **kw))
    assert len(pieces) == len(synth.split_long_text(LONG)) + 1
    streamed = np.concatenate(pieces)
    assert streamed.dtype == whole.dtype
    assert streamed.tobytes() == whole.tobytes()


def test_continuity_prompt_needs_the_prompt_family(ref):
    with pytest.raises(ValueError, match="prompt-conditioned"):
        ref["port"].synthesize_long(LONG, continuity_prompt=True)
    with pytest.raises(ValueError, match="prompt-conditioned"):
        next(ref["port"].synthesize_long_stream(LONG,
                                                continuity_prompt=True))


def test_synthesize_async_pull_is_synthesize(ref):
    port = ref["port"]
    texts = ["hello", ""]
    wav, event = port.synthesize_async(texts, seed=2, pcm16=True)
    assert event is None and wav.device.type == "cpu"
    assert wav.dtype == torch.int16 and wav.shape == (2, T * 320)
    pulled = port.synthesize(texts, seed=2, pcm16=True)
    assert wav.numpy().tobytes() == pulled.tobytes()


def test_full_f32_holds_while_any_thread_is_inside():
    """Two threads' entries and exits interleave: A in, B in, A out, B
    out.  The flags stay off until the last exit, then come back."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = tuple(f.allow_tf32 for f in flags)
    for f in flags:
        f.allow_tf32 = True
    steps = [threading.Event() for _ in range(4)]
    seen = {}

    def a():
        with pipeline.full_f32():
            steps[0].set()
            steps[1].wait(10)
        seen["a_left"] = tuple(f.allow_tf32 for f in flags)
        steps[2].set()

    def b():
        steps[0].wait(10)
        with pipeline.full_f32():
            steps[1].set()
            steps[2].wait(10)
            seen["b_inside_after_a_left"] = tuple(f.allow_tf32
                                                  for f in flags)
        steps[3].set()

    try:
        threads = [threading.Thread(target=a), threading.Thread(target=b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        assert all(s.is_set() for s in steps)
        assert seen["a_left"] == (False, False)
        assert seen["b_inside_after_a_left"] == (False, False)
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
        assert pipeline._f32_scope["depth"] == 0
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_full_f32_stress():
    """Sixteen threads enter and leave the scope 200 times each at a short
    switch interval: inside, the flags are always off; afterwards they are
    back and the count is 0 (a lost update of the count would leave it
    elsewhere, or restore the flags under a thread still inside)."""
    import sys
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = tuple(f.allow_tf32 for f in flags)
    interval = sys.getswitchinterval()
    bad = []

    def work():
        for _ in range(200):
            with pipeline.full_f32():
                if any(f.allow_tf32 for f in flags):
                    bad.append(1)

    try:
        for f in flags:
            f.allow_tf32 = True
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert pipeline._f32_scope["depth"] == 0
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
    finally:
        sys.setswitchinterval(interval)
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
