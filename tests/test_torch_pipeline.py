"""The synthesis slice as a whole: the PyTorch port against the JAX package.

Tiny model plus the full-width f32 codec, 3 DDIM steps.  The same x_T,
ids and mask go to the JAX ``Synthesizer``'s device program (the body of
``_synthesize_device``, which ``_synth_fn`` jits, traced once with the
latents kept; stock decoder: ``PROMPT_TTS_FOLDED_DECODE=0`` is set before
it is traced) and to the port's ``Synthesizer``, on the same weights (JAX
param trees filled from a numpy seed, converted with ``convert.py``).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.codec import EncodecCodec as JaxCodec
from prompt_tts_tpu.config import Config, ModelConfig
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu.pipeline import codec_decode, latents_to_codes
from prompt_tts_tpu.utils.wav import pcm16_bytes, read_wav
from prompt_tts_tpu_torch.convert import (
    codec_state_from_jax, model_state_from_jax,
)
from prompt_tts_tpu_torch.diffusion.ddim import ddim_sample, ddim_timesteps
from prompt_tts_tpu_torch.diffusion.schedule import add_noise, linear_schedule
from prompt_tts_tpu_torch.pipeline import Synthesizer, wav_to_pcm16

# latents: the model-level 5e-4 contract (f32 both sides, summation order
# differs), carried through 3 DDIM updates whose x0 step divides by
# sqrt(acp_t) >= 0.1 at these timesteps and is then clipped.
LATENT_TOL = 5e-4
# wav decoded from the SAME codes: the codec's 1e-5 decode contract.
WAV_TOL = 1e-5
# codes: a latent within 5e-4 can still round to the neighbouring code at
# a .5 boundary; at most 0.1% of entries may differ, and only by 1.
MAX_FLIP_SHARE = 1e-3

CFG = ModelConfig(
    block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
    sample_size=48, layers_per_block=1, unet_num_heads=4)
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
    """A param tree of the given shapes from ``rng``: fan-in-scaled
    kernels and LSTM weights, unit-normal embeddings and codebooks,
    non-trivial biases and norm scales."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if "_w_" in name:
            return x / np.sqrt(s.shape[1])
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name in ("bias", "l0_b", "l1_b") else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.default_rng(0)
    S, T, C = CFG.cmu_seq_len, CFG.sample_size, CFG.in_channels
    model, codec = JaxTTS(CFG), JaxCodec()
    mparams = _fill(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, T, C)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, S), jnp.int32),
        jnp.ones((1, S), jnp.int32)), rng)
    cparams = _fill(jax.eval_shape(
        lambda r, w: codec.init(r, w, 6.0), jax.random.PRNGKey(1),
        jnp.zeros((1, 3200))), rng)
    x_T = rng.standard_normal((len(TEXTS), T, C)).astype(np.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROMPT_TTS_FOLDED_DECODE", "0")
        jsynth = JaxSynthesizer(config=Config(model=CFG),
                                model_params=mparams, codec_params=cparams,
                                num_inference_steps=STEPS,
                                dtype=jnp.float32)
        ids, mask = jsynth.tokenizer.encode_batch(TEXTS)

        @jax.jit   # one program: _synthesize_device's body, latents kept
        def run(mp, cp, x_T, ids, mask):
            lat = jsynth._denoise_latents(mp, x_T, ids, mask)
            codes = latents_to_codes(lat)
            return lat, codes, codec_decode(jsynth._codec_fast, cp, codes)

        lat_j, codes_j, wav_j = run(mparams, cparams, x_T, ids, mask)

    port = Synthesizer(config=Config(model=CFG), device="cpu",
                       dtype=torch.float32, num_inference_steps=STEPS,
                       model_state=model_state_from_jax(mparams),
                       codec_state=codec_state_from_jax(cparams))
    lat_p = port.denoise_latents(torch.from_numpy(x_T),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    wav_p, codes_p = port.synthesize(TEXTS, x_T=torch.from_numpy(x_T),
                                     return_codes=True)
    pcm_p = port.synthesize(TEXTS, x_T=torch.from_numpy(x_T), pcm16=True)
    wav_same_codes = port.codec_runner.decode(np.array(codes_j))
    return dict(lat_j=np.asarray(lat_j), lat_p=lat_p.numpy(),
                codes_j=np.asarray(codes_j), codes_p=codes_p,
                wav_j=np.asarray(wav_j), wav_p=wav_p, pcm_p=pcm_p,
                wav_same_codes=wav_same_codes.numpy())


def test_latents_match(slice_pair):
    np.testing.assert_allclose(slice_pair["lat_p"], slice_pair["lat_j"],
                               atol=LATENT_TOL, rtol=0)


def test_codes_match(slice_pair):
    cj, cp = slice_pair["codes_j"], slice_pair["codes_p"]
    assert cp.shape == (len(TEXTS), 8, CFG.sample_size)
    assert cp.min() >= 0 and cp.max() <= 1023
    diff = np.abs(cp.astype(np.int64) - cj)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_FLIP_SHARE


def test_wav_from_same_codes_matches(slice_pair):
    wav = slice_pair["wav_same_codes"]
    assert wav.shape == (len(TEXTS), CFG.sample_size * 320)
    np.testing.assert_allclose(wav, slice_pair["wav_j"], atol=WAV_TOL,
                               rtol=0)
    assert slice_pair["wav_p"].shape == wav.shape
    assert np.isfinite(slice_pair["wav_p"]).all()


def test_synthesize_pcm16_is_the_quantized_wav(slice_pair):
    pcm, wav = slice_pair["pcm_p"], slice_pair["wav_p"]
    assert pcm.dtype == np.int16
    assert pcm.tobytes() == pcm16_bytes(wav)


def test_pcm16_matches_host_quantizer():
    wav = np.random.default_rng(4).uniform(-1.2, 1.2, 4096).astype(
        np.float32)
    wav[:4] = [0.5 / 32767, 1.5 / 32767, -2.5 / 32767, 1.0]  # ties, edges
    out = wav_to_pcm16(torch.from_numpy(wav)).numpy()
    assert out.tobytes() == pcm16_bytes(wav)


@pytest.fixture
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "block_out_channels": list(CFG.block_out_channels),
        "cross_attention_dim": 64, "attention_head_dim": 32,
        "text_encoder_layers": 1, "cmu_seq_len": 32, "sample_size": 48,
        "layers_per_block": 1, "unet_num_heads": 4}))
    return str(path)


def test_cli_writes_wav(tmp_path, tiny_config):
    from prompt_tts_tpu_torch.cli.synthesize import main
    out = str(tmp_path / "x.wav")
    paths, wavs, codes = main(["--text", "hello", "--out", out, "--steps",
                               "2", "--device", "cpu", "--config_file",
                               tiny_config])
    assert paths == [out]
    audio, sr = read_wav(out)
    assert sr == 24000 and audio.shape == (48 * 320, 1)
    # PCM16 on disk: within two quantization steps of the returned wav
    np.testing.assert_allclose(audio[:, 0], np.clip(wavs[0], -1, 1),
                               atol=2 / 32767)
    assert codes.shape == (1, 8, 48)


def test_port_runs_without_jax(tmp_path, tiny_config):
    """A process that imports the port, runs the CPU slice, a tiny train
    step and an encode of a one-clip wav tar never loads jax, flax, optax
    or any module of the JAX package."""
    import io
    import tarfile
    from prompt_tts_tpu_torch.utils.wav import write_wav
    buf = io.BytesIO()
    write_wav(buf, np.zeros(2205, np.float32), 22050)
    with tarfile.open(tmp_path / "w.tar", "w") as tf:
        info = tarfile.TarInfo("u.wav")
        info.size = len(buf.getvalue())
        tf.addfile(info, io.BytesIO(buf.getvalue()))
    code = (
        "import sys\n"
        "from prompt_tts_tpu_torch.cli.synthesize import main\n"
        "from prompt_tts_tpu_torch.cli.train import main as train\n"
        "from prompt_tts_tpu_torch.cli.generate_codes import main as encode\n"
        f"main(['--text', 'a b', '--out', {str(tmp_path / 'y.wav')!r},"
        f" '--steps', '1', '--device', 'cpu', '--dtype', 'bf16',"
        f" '--config_file', {tiny_config!r}])\n"
        f"t = train(['--smoke', '--device', 'cpu', '--log_dir',"
        f" {str(tmp_path / 'log')!r}])\n"
        "assert t.global_step == 2\n"
        f"_, n, _ = encode(['--input_file', {str(tmp_path / 'w.tar')!r},"
        f" '--max_duration', '1', '--device', 'cpu'])\n"
        "assert n == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'prompt_tts_tpu')]\n"
        "assert not bad, bad\n")
    root = str(pathlib.Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "y.wav").exists()
    with tarfile.open(tmp_path / "w_processed.tar") as tf:
        assert tf.getnames() == ["u.npy", "u.len.txt"]


def test_port_sources_import_no_jax():
    """Statically: no module of the port, and not ``chip_smoke.py``,
    imports jax, flax, optax or the JAX package ``prompt_tts_tpu``."""
    import ast
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "prompt_tts_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 30
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(root)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in
                    ("jax", "flax", "optax", "prompt_tts_tpu")]
    assert not bad, bad


def test_packaging_names_the_port():
    """pyproject's package discovery takes in every port package, and its
    package-data ships the CUDA sources the kernels are built from."""
    import tomllib
    from setuptools import find_packages
    root = pathlib.Path(__file__).resolve().parents[1]
    tool = tomllib.loads((root / "pyproject.toml").read_text())["tool"]
    found = set(find_packages(
        where=str(root), include=tool["setuptools"]["packages"]["find"][
            "include"]))
    port = root / "prompt_tts_tpu_torch"
    want = {".".join(p.parent.relative_to(root).parts)
            for p in port.rglob("__init__.py")}
    assert want <= found and "prompt_tts_tpu_torch.ops.cuda" in want
    globs = tool["setuptools"]["package-data"]["prompt_tts_tpu_torch"]
    shipped = {p for g in globs for p in port.glob(g)}
    assert set(port.glob("csrc/*.cu")) <= shipped
    assert {p.name for p in shipped} >= {"attention.cu", "attention_bwd.cu",
                                          "lstm.cu", "rvq.cu"}
    # the port's own copy of the CMU dictionary ships with its frontend
    globs = tool["setuptools"]["package-data"]["prompt_tts_tpu_torch.frontend"]
    assert any((port / "frontend").glob(g) for g in globs)
    assert (port / "frontend/data/cmu_dictionary.gz").exists()


def _eps_models(rng):
    """The same analytic eps(x, t) for both samplers: a bounded nonlinear
    map of x, scaled with t."""
    w = (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    return (lambda x, t: jnp.tanh(x @ wj) * (t[:, None, None] / 1000.0),
            lambda x, t: torch.tanh(x @ wt) * (t[:, None, None] / 1000.0))


def test_ddim_matches_jax_sampler():
    """The sampler alone against JAX ``ddim_sample``: "leading" timesteps,
    x0 clipping, f32 state.  1e-5: f32 both sides; the schedule tables
    (linspace, cumprod) round in another order."""
    from prompt_tts_tpu.diffusion import (ddim_sample as jax_ddim,
                                          ddim_timesteps as jax_timesteps,
                                          linear_schedule as jax_schedule)
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((2, 16, 8)).astype(np.float32)
    eps_j, eps_t = _eps_models(rng)
    ref = jax_ddim(eps_j, jax_schedule(), jnp.asarray(x_T),
                   num_inference_steps=10)
    out = ddim_sample(eps_t, linear_schedule(), torch.from_numpy(x_T), 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert ddim_timesteps(1000, 50) == np.asarray(
        jax_timesteps(1000, 50)).tolist()


def test_ddim_eta_takes_an_explicit_generator():
    rng = np.random.default_rng(6)
    x_T = torch.from_numpy(rng.standard_normal((1, 8, 8)).astype(np.float32))
    _, eps_t = _eps_models(rng)
    sched = linear_schedule()
    with pytest.raises(ValueError, match="Generator"):
        ddim_sample(eps_t, sched, x_T, 5, eta=1.0)
    a, b = (ddim_sample(eps_t, sched, x_T, 5, eta=1.0,
                        generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, ddim_sample(eps_t, sched, x_T, 5))


def test_add_noise_matches_jax():
    from prompt_tts_tpu.diffusion import add_noise as jax_add_noise
    from prompt_tts_tpu.diffusion import linear_schedule as jax_schedule
    rng = np.random.default_rng(7)
    x0, noise = (rng.standard_normal((3, 10, 8)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 499, 999])
    ref = jax_add_noise(jax_schedule(), jnp.asarray(x0), jnp.asarray(noise),
                        jnp.asarray(t))
    out = add_noise(linear_schedule(), torch.from_numpy(x0),
                    torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
