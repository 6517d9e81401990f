"""The optional bf16 codec decode: the port against the JAX package.

The full-width EnCodec 24 kHz codec over a numpy-seeded JAX param tree
(as ``test_torch_codec.py``), carried into the port: the port's bf16
decode (``EncodecCodec.at_dtype(torch.bfloat16)``, the same f32
parameters) against JAX's ``EncodecCodec(dtype=bfloat16)`` decode on the
same codes; the f32 default still at the 1e-5 decode contract;
``Synthesizer(codec_dtype=torch.bfloat16)`` end to end at a tiny model,
every decode of a synthesis through the bf16 codec.

Tolerance of the bf16 decode (on the CPU: XLA's bf16 convolutions against
oneDNN's, which round in other places): relative Frobenius error
``BF16_FRO`` and largest error ``BF16_MAX`` of max |wav|.  Measured: 1.14e-2
and 1.22e-2 -- as far as JAX's own bf16 decode is from its f32 decode
(1.08e-2, 1.16e-2), so the gap is bf16's rounding, not a different map.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
from prompt_tts_tpu_torch.config import Config, ModelConfig
from prompt_tts_tpu_torch.convert import codec_state_from_jax
from prompt_tts_tpu_torch.pipeline import CodecRunner, Synthesizer
from prompt_tts_tpu_torch.utils.mel import log_mel

TOL = 1e-5                     # the f32 decode contract
BF16_FRO, BF16_MAX = 2e-2, 2.5e-2
FRAMES = 16
CFG = ModelConfig(
    block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
    sample_size=FRAMES, layers_per_block=1, unet_num_heads=4)
TEXTS = ["hello world", "printing, in the only sense"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec_pair():
    rng = np.random.default_rng(0)
    codec = JaxCodec()
    shapes = jax.eval_shape(lambda r, w: codec.init(r, w, 6.0),
                            jax.random.PRNGKey(0), jnp.zeros((1, 3200)))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(s.shape[0] * s.shape[1])
        if name == "codebooks":
            return x
        if "_w_" in name:
            return x / np.sqrt(s.shape[1])
        return 0.1 * x
    params = jax.tree_util.tree_map_with_path(leaf, shapes)

    @jax.jit
    def decode(params, codes):
        return (codec.apply(params, codes, method=JaxCodec.decode),
                JaxCodec(dtype=jnp.bfloat16).apply(
                    params, codes, method=JaxCodec.decode
                ).astype(jnp.float32))
    port = EncodecCodec()
    port.load_state_dict(codec_state_from_jax(params), strict=True)
    return params, decode, port.eval()


def _bf16_held(got, want):
    fro = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max() / np.abs(want).max()
    assert fro <= BF16_FRO and worst <= BF16_MAX, (fro, worst)


def test_bf16_decode_matches_jax(codec_pair):
    params, decode, port = codec_pair
    codes = np.random.default_rng(1).integers(0, 1024, (2, 8, FRAMES))
    want32, want16 = (np.asarray(a) for a in decode(
        params, jnp.asarray(codes, jnp.int32)))
    fast = port.at_dtype(torch.bfloat16)
    with torch.no_grad():
        got16 = fast.decode(torch.from_numpy(codes))
        got32 = port.decode(torch.from_numpy(codes))
    assert got16.dtype == torch.bfloat16 and got16.shape == (2, FRAMES * 320)
    got16 = got16.float().numpy()
    assert np.isfinite(got16).all()
    _bf16_held(got16, want16)
    # the f32 default is untouched: the decode contract
    np.testing.assert_allclose(got32.numpy(), want32, atol=TOL, rtol=0)
    # bf16 moves the wav, and its mel, by what bf16 moves JAX's
    assert np.abs(got16 - got32.numpy()).max() > 100 * TOL

    def mel_distance(a, b):
        return np.mean([np.abs(log_mel(x) - log_mel(y)).mean()
                        for x, y in zip(a, b)])
    dist = mel_distance(got16, got32.numpy())
    jdist = mel_distance(want16, want32)
    assert dist <= 2 * jdist, (dist, jdist)


def test_bf16_codec_shares_the_f32_parameters(codec_pair):
    """``at_dtype`` is a second module over the same storage: no copy, and
    a later load into the f32 codec shows in the bf16 one; the f32 dtype is
    the codec itself, and the encode stays f32."""
    _, _, port = codec_pair
    runner = CodecRunner("cpu")
    assert runner.at_dtype(torch.float32) is runner
    fast = runner.at_dtype(torch.bfloat16)
    assert fast.codec.dtype == torch.bfloat16
    f32 = dict(runner.codec.named_parameters())
    for name, p in fast.codec.named_parameters():
        assert p.dtype == torch.float32
        assert p.data_ptr() == f32[name].data_ptr(), name
    runner.codec.load_state_dict(port.state_dict())
    assert torch.equal(fast.codec.decoder.layer_0.conv.weight,
                       port.decoder.layer_0.conv.weight)
    codes = torch.randint(0, 1024, (1, 8, 4),
                          generator=torch.Generator().manual_seed(0))
    wav = fast.decode(codes)
    assert wav.dtype == torch.float32       # the runner hands out f32
    with torch.no_grad():
        assert torch.equal(
            wav, port.at_dtype(torch.bfloat16).decode(codes).float())


def test_synthesizer_decodes_every_path_in_bf16(codec_pair):
    """``Synthesizer(codec_dtype=torch.bfloat16)`` on the CPU: the same codes
    as the f32 default (the denoiser is untouched), each wav the bf16
    codec's decode of them, within the bf16 tolerance of JAX's bf16 decode;
    ``synthesize``, the streamed prefixes and the long-form windows all
    decode through the bf16 codec and never through the f32 one."""
    params, decode, _ = codec_pair
    cstate = codec_state_from_jax(params)
    kw = dict(config=Config(model=CFG), device="cpu", dtype=torch.float32,
              num_inference_steps=2, codec_state=cstate)
    ref = Synthesizer(**kw)
    synth = Synthesizer(codec_dtype=torch.bfloat16, **kw)
    assert synth.codec_fast is not synth.codec_runner
    assert ref.codec_fast is ref.codec_runner
    calls = {"f32": 0, "bf16": 0}

    def counted(runner, key):
        inner = runner.decode

        def decode_(*a, **k):
            calls[key] += 1
            return inner(*a, **k)
        runner.decode = decode_
    counted(synth.codec_runner, "f32")
    counted(synth.codec_fast, "bf16")

    wav, codes = synth.synthesize(TEXTS, seed=3, return_codes=True)
    wav_ref, codes_ref = ref.synthesize(TEXTS, seed=3, return_codes=True)
    np.testing.assert_array_equal(codes, codes_ref)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    with torch.no_grad():
        own = synth.codec_runner.codec.at_dtype(torch.bfloat16).decode(
            torch.from_numpy(codes)).float().numpy()
    np.testing.assert_array_equal(wav, own)
    _, want16 = decode(params, jnp.asarray(codes, jnp.int32))
    _bf16_held(wav, np.asarray(want16))
    assert np.abs(wav - wav_ref).max() > 100 * TOL
    assert calls == {"f32": 0, "bf16": 1}

    chunks = list(synth.synthesize_stream(TEXTS, seed=3, chunk_frames=6))
    assert len(chunks) == 3 and calls == {"f32": 0, "bf16": 4}
    streamed = np.concatenate(chunks, axis=1)
    assert streamed.shape == wav.shape and np.isfinite(streamed).all()

    long = synth.synthesize_long(" ".join(TEXTS * 4), seed=3, max_batch=2)
    assert long.ndim == 1 and np.isfinite(long).all()
    assert calls["f32"] == 0 and calls["bf16"] >= 5
    # the tool path and the prompt's encode stay f32
    synth.decode_codes(codes)
    assert calls["f32"] == 1
