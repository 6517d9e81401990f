"""The denoiser: the PyTorch port against the JAX package, in f32.

Tiny config (``__graft_entry__._dryrun_impl``'s widths).  The JAX param
tree (its shapes from ``model.init``) is filled from a numpy seed and
loaded into the port through ``model_state_from_jax``.  Tolerance 5e-4
absolute is the model-level contract of ARCHITECTURE.md "Numerics
contracts": f32 on both sides, differing in summation order only.
"""

import numpy as np
import pytest
import torch

import jax

from prompt_tts_tpu.config import ModelConfig
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.models.unet1d import cross_attention_kv as jax_cross_kv
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.unet1d import cross_attention_kv

TOL = 5e-4
CFG = ModelConfig(
    block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
    sample_size=48, layers_per_block=1, unet_num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: the shapes are tiny,
    and OpenMP's spinning worker threads stall when the suite's parallel
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(shapes, rng):
    """Params of the given shape tree drawn from ``rng``: lecun-scaled
    kernels, non-trivial biases and norm scales (flax's init would make
    them 0 and 1)."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    """The JAX outputs for one input set, from ONE jitted program (a
    compile per JAX call would dominate this file's time)."""
    rng = np.random.default_rng(0)
    B, S, T = 2, CFG.cmu_seq_len, CFG.sample_size
    ids = rng.integers(1, 149, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, 20:] = 0
    ids[0, 20:] = 0
    sample = rng.standard_normal((B, T, CFG.in_channels), dtype=np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rng.standard_normal((B, S, CFG.cross_attention_dim),
                              dtype=np.float32)

    model = JaxTTS(CFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, t,
                            ids, mask)
    params = random_params(shapes, rng)

    @jax.jit
    def ref(params, sample, t, ids, mask, ctx):
        enc = model.apply(params, ids, mask, method=JaxTTS.encode_text)
        eps = model.apply(params, sample, t, ids, mask)
        kv = jax_cross_kv(params["params"]["unet"], ctx, CFG)
        eps_ctx = model.apply(params, sample, t, ctx, cross_kv=kv,
                              method=JaxTTS.denoise)
        return enc, eps, eps_ctx

    enc, eps, eps_ctx = ref(params, sample, t, ids, mask, ctx)
    port = TTSSingleSpeaker(CFG)
    port.load_state_dict(model_state_from_jax(params), strict=True)
    port.eval()
    inputs = {k: torch.from_numpy(v) for k, v in
              dict(ids=ids, mask=mask, sample=sample, t=t, ctx=ctx).items()}
    return dict(params=params, port=port, enc=np.asarray(enc),
                eps=np.asarray(eps), eps_ctx=np.asarray(eps_ctx), **inputs)


def test_text_encoder_matches(pair):
    p = pair
    with torch.no_grad():
        out = p["port"].encode_text(p["ids"], p["mask"])
    np.testing.assert_allclose(out.numpy(), p["enc"], atol=TOL, rtol=0)


def test_forward_matches(pair):
    p = pair
    with torch.no_grad():
        out = p["port"](p["sample"], p["t"], p["ids"], p["mask"])
    assert out.shape == (2, CFG.sample_size, CFG.out_channels)
    np.testing.assert_allclose(out.numpy(), p["eps"], atol=TOL, rtol=0)


def test_unet_with_and_without_cross_kv(pair):
    """The hoisted cross k/v give the same UNet output as the in-call
    projections; the JAX side runs with its own hoist."""
    p = pair
    port, x, t, c = p["port"], p["sample"], p["t"], p["ctx"]
    with torch.no_grad():
        plain = port.denoise(x, t, c)
        hoisted = port.denoise(x, t, None,
                               cross_kv=cross_attention_kv(port.unet, c))
    np.testing.assert_allclose(plain.numpy(), p["eps_ctx"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(hoisted.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)


def test_converter_consumes_every_leaf(pair):
    state = model_state_from_jax(pair["params"])
    assert set(state) == set(pair["port"].state_dict())
    extra = {"params": dict(pair["params"]["params"],
                            stray={"unknown_leaf": np.zeros(3)})}
    with pytest.raises(ValueError, match="stray/unknown_leaf"):
        model_state_from_jax(extra)
    state.pop("unet.conv_out.conv.bias")
    with pytest.raises(RuntimeError, match="conv_out.conv.bias"):
        TTSSingleSpeaker(CFG).load_state_dict(state, strict=True)


def test_optional_unet_variants_raise():
    import dataclasses
    with pytest.raises(NotImplementedError, match="fourier"):
        TTSSingleSpeaker(dataclasses.replace(
            CFG, time_embedding_type="fourier"))
