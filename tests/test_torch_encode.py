"""The encode path: the PyTorch port against the JAX package and torch EnCodec.

The full-width EnCodec 24 kHz encoder in f32 on CPU tensors (the LSTM and
RVQ kernels' plain versions).  Weights: a JAX param tree filled from a
numpy seed and converted with ``codec_state_from_jax`` (loaded with
``strict=True``), and a ``transformers.EncodecModel(EncodecConfig())``
built offline with seeded codebooks, converted from its state dict with
``codec_state_from_encodec``.  Contracts (ARCHITECTURE.md "Numerics
contracts", ``tests/test_codec_vs_torch.py``): encoder latents to 1e-5,
codes bit-equal, decode to 1e-5.  Then the slice as a whole: the port's
``cli.generate_codes`` against the JAX CLI on the same weights, member for
member, and ``cli.decode_codec`` / ``cli.convert_codec``.
"""

import io
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu.codec.encodec import EncodecEncoder as JaxEncoder
from prompt_tts_tpu.codec.io import save_codec_params
from prompt_tts_tpu.utils.wav import read_wav, write_wav
from prompt_tts_tpu_torch.codec.convert import codec_state_from_encodec
from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
from prompt_tts_tpu_torch.convert import codec_state_from_jax

TOL = 1e-5


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
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_pair():
    codec = JaxCodec()
    params = _fill(jax.eval_shape(lambda r, w: codec.init(r, w, 6.0),
                                  jax.random.PRNGKey(0),
                                  jnp.zeros((1, 3200))),
                   np.random.default_rng(0))
    port = EncodecCodec()
    port.load_state_dict(codec_state_from_jax(params), strict=True)
    return codec, params, port.eval()


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import EncodecConfig, EncodecModel
    torch.manual_seed(0)
    model = EncodecModel(EncodecConfig()).eval()  # 24 kHz defaults
    with torch.no_grad():
        for layer in model.quantizer.layers:
            layer.codebook.embed.normal_()
    port = EncodecCodec()
    port.load_state_dict(codec_state_from_encodec(model.state_dict()),
                         strict=True)
    return model, port.eval()


@pytest.mark.parametrize("samples", [24000, 23999, 3200])
def test_encoder_latents_match_jax(jax_pair, samples):
    _, params, port = jax_pair
    wav = np.random.default_rng(samples).standard_normal(
        (2, samples, 1)).astype(np.float32)
    ref = jax.jit(JaxEncoder().apply)({"params": params["params"]["encoder"]},
                                      jnp.asarray(wav))
    with torch.no_grad():
        out = port.encoder(torch.from_numpy(wav))
    assert out.shape == (2, -(-samples // 320), 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_encode_codes_equal_jax(jax_pair):
    codec, params, port = jax_pair
    wav = np.random.default_rng(7).standard_normal((2, 24000)).astype(
        np.float32)
    ref = jax.jit(lambda p, w: codec.apply(p, w, 6.0,
                                           method=JaxCodec.encode))(
        params, jnp.asarray(wav))
    with torch.no_grad():
        out = port.encode(torch.from_numpy(wav))
    assert out.shape == (2, 8, 75) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_encodec_state_matches_transformers(hf_pair):
    """Latents 1e-5, codes bit-equal, decode 1e-5 against the torch model
    the converter read."""
    model, port = hf_pair
    torch.manual_seed(2)
    wav = torch.randn(2, 1, 24000)
    with torch.no_grad():
        t_lat = model.encoder(wav)                         # [B, 128, F]
        t_codes = model.encode(wav, bandwidth=6.0).audio_codes[0]
        t_wav = model.decode(t_codes[None], [None]).audio_values
        lat = port.encoder(wav.transpose(1, 2))
        codes = port.encode(wav[:, 0])
        out = port.decode(codes)
    np.testing.assert_allclose(lat.transpose(1, 2).numpy(), t_lat.numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(codes.numpy(), t_codes.numpy())
    np.testing.assert_allclose(out.numpy(), t_wav[:, 0].numpy(), atol=TOL,
                               rtol=0)


def test_encodec_converter_spellings_and_refusals(hf_pair):
    """The old weight_g/weight_v spelling gives the same state; a key no
    rule consumes, or half a weight-norm pair, raises."""
    model, _ = hf_pair
    sd = model.state_dict()
    new = codec_state_from_encodec(sd)
    old = codec_state_from_encodec({
        k.replace("parametrizations.weight.original0", "weight_g")
         .replace("parametrizations.weight.original1", "weight_v"): v
        for k, v in sd.items()})
    assert set(old) == set(new)
    for k in new:
        assert torch.equal(old[k], new[k]), k
    assert new["codebooks"].shape == (32, 1024, 128)
    with pytest.raises(ValueError, match="no conversion rule"):
        codec_state_from_encodec({**sd, "encoder.layers.0.extra": sd[
            "encoder.layers.0.conv.bias"]})
    half = {k: v for k, v in sd.items()
            if k != "decoder.layers.3.conv.parametrizations.weight.original0"}
    with pytest.raises(ValueError, match="g and v"):
        codec_state_from_encodec(half)


def _wav_bytes(audio, sr):
    buf = io.BytesIO()
    write_wav(buf, audio, sr)
    return buf.getvalue()


@pytest.fixture
def wav_tar(tmp_path):
    """Two 22.05 kHz clips of different lengths (one longer than the 1 s
    window, so it is cut; one shorter, so it is padded), with transcripts,
    under a directory as corpus tars have them."""
    rng = np.random.default_rng(11)
    path = tmp_path / "wavs.tar"
    with tarfile.open(path, "w") as tf:
        for stem, n in (("a", 30000), ("b", 13000)):
            t = np.arange(n) / 22050
            audio = (0.4 * np.sin(2 * np.pi * 220 * t)
                     + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for name, data in ((f"corpus/{stem}.wav", _wav_bytes(audio,
                                                                 22050)),
                               (f"corpus/{stem}.txt", f"text {stem}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def _members(path):
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


def test_generate_codes_equals_jax_cli(jax_pair, wav_tar, tmp_path):
    """The slice: the same wav tar and weights through both CLIs give the
    same members with the same bytes (codes, lengths, transcripts)."""
    from prompt_tts_tpu.cli.generate_codes import main as jax_main
    from prompt_tts_tpu_torch.cli.decode_codec import main as decode
    from prompt_tts_tpu_torch.cli.generate_codes import main
    _, params, port = jax_pair
    msgpack, state = tmp_path / "codec.msgpack", tmp_path / "codec.pt"
    save_codec_params(params, str(msgpack))
    torch.save(port.state_dict(), state)
    args = ["--batch_size", "2", "--max_duration", "1"]
    jax_main(["--input_file", str(wav_tar), "--codec_params", str(msgpack),
              "--cpu", *args])
    ref = _members(tmp_path / "wavs_processed.tar")
    (tmp_path / "wavs_processed.tar").unlink()
    out_file, n, _ = main(["--input_file", str(wav_tar), "--codec_params",
                           str(state), "--device", "cpu", *args])
    got = _members(out_file)
    assert n == 2
    assert [m[0] for m in got] == ["a.npy", "a.len.txt", "b.npy",
                                   "b.len.txt", "a.txt", "b.txt"]
    assert got == ref
    codes = np.load(io.BytesIO(dict(got)["b.npy"]))
    assert codes.shape == (8, 75) and codes.dtype == np.int64
    # 13000 samples at 22.05 kHz -> 14149 at 24 kHz -> 45 frames
    assert dict(got)["b.len.txt"] == b"45.0"

    npy = tmp_path / "b.npy"
    np.save(npy, codes)
    wav_path = decode(["--npy_path", str(npy), "--codec_params", str(state),
                       "--device", "cpu"])
    audio, sr = read_wav(wav_path)
    assert sr == 24000 and audio.shape == (75 * 320, 1)


def test_convert_codec_cli(hf_pair, tmp_path):
    from prompt_tts_tpu_torch.cli.convert_codec import main
    model, port = hf_pair
    sd_path, out = tmp_path / "hf.pt", tmp_path / "codec.pt"
    torch.save(model.state_dict(), sd_path)
    state = main(["--torch_state", str(sd_path), "--out", str(out)])
    saved = torch.load(out, weights_only=True)
    for k, v in port.state_dict().items():
        assert torch.equal(saved[k], v) and torch.equal(state[k], v), k
    a = main(["--random", "--seed", "3", "--out", str(out)])
    b = main(["--random", "--seed", "3", "--out", str(out)])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["codebooks"], state["codebooks"])
