"""The codec decode: the PyTorch port against the JAX package, in f32.

(The encode side is in ``test_torch_encode.py`` and ``test_torch_rvq.py``.)

The full-width EnCodec 24 kHz decoder over 16 frames: the JAX param tree
(shapes from ``EncodecCodec.init``) is filled from a numpy seed, loaded into
the port through ``codec_state_from_jax``, and both decode the same codes.
The JAX side runs its stock decoder (``EncodecCodec.decode``), not the
folded TPU-layout rewrite.  Tolerance 1e-5 absolute is the codec decode
contract of ARCHITECTURE.md "Numerics contracts".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu.codec.layers import reflect_pad as jax_reflect_pad
from prompt_tts_tpu.codec.rvq import rvq_decode as jax_rvq_decode
from prompt_tts_tpu_torch.codec.encodec import EncodecCodec, EncodecConfig24k
from prompt_tts_tpu_torch.codec.layers import reflect_pad
from prompt_tts_tpu_torch.codec.rvq import rvq_decode
from prompt_tts_tpu_torch.convert import codec_state_from_jax

TOL = 1e-5
FRAMES = 16


@pytest.fixture(scope="module")
def codec_pair():
    rng = np.random.default_rng(0)
    codec = JaxCodec()
    shapes = jax.eval_shape(lambda r, w: codec.init(r, w, 6.0),
                            jax.random.PRNGKey(0), jnp.zeros((1, 3200)))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":     # conv [k, in, out] or convT [k, out, in]
            return x / np.sqrt(s.shape[0] * s.shape[1])
        if name == "codebooks":
            return x
        if "_w_" in name:        # LSTM [4H, C]
            return x / np.sqrt(s.shape[1])
        return 0.1 * x           # biases
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    port = EncodecCodec()
    port.load_state_dict(codec_state_from_jax(params), strict=True)
    port.eval()
    return codec, params, port


def test_decode_matches_stock_jax_decoder(codec_pair):
    codec, params, port = codec_pair
    codes = np.random.default_rng(1).integers(0, 1024, (2, 8, FRAMES))
    ref = jax.jit(lambda p, c: codec.apply(p, c, method=JaxCodec.decode))(
        params, jnp.asarray(codes, jnp.int32))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(codes))
    assert out.shape == (2, FRAMES * 320)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_rvq_decode_exact():
    rng = np.random.default_rng(2)
    cb = rng.standard_normal((8, 1024, 128)).astype(np.float32)
    codes = rng.integers(0, 1024, (2, 8, 30))
    ref = jax_rvq_decode(jnp.asarray(codes, jnp.int32), jnp.asarray(cb))
    out = rvq_decode(torch.from_numpy(codes), torch.from_numpy(cb))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("T,left,right", [(10, 6, 0), (3, 6, 1), (1, 2, 2)])
def test_reflect_pad_matches(T, left, right):
    """Including torch's small-input fallback (T <= max pad)."""
    x = np.random.default_rng(3).standard_normal((2, T, 4)).astype(
        np.float32)
    ref = jax_reflect_pad(jnp.asarray(x), left, right)
    out = reflect_pad(torch.from_numpy(x), left, right)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_converter_drops_only_the_encoder(codec_pair):
    """The converter now drops nothing: the port has the encoder too, and
    every leaf of the JAX tree, the encoder's included, lands in it."""
    _, params, port = codec_pair
    state = codec_state_from_jax(params)
    assert set(state) == set(port.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_leaves
    assert sum(k.startswith("encoder.") for k in state) == len(
        jax.tree_util.tree_leaves(params["params"]["encoder"]))


class TestStructuralConstants:
    """tests/test_codec_vs_torch.py::TestStructuralConstants on the port's
    copy of the config."""

    def test_hop_and_frame_rate(self):
        cfg = EncodecConfig24k()
        assert cfg.hop_length == 320
        assert cfg.frame_rate == 75

    def test_bandwidth_to_n_q(self):
        cfg = EncodecConfig24k()
        assert cfg.num_quantizers_for_bandwidth(6.0) == 8
        assert cfg.num_quantizers_for_bandwidth(1.5) == 2
        assert cfg.num_quantizers_for_bandwidth(24.0) == 32
