"""The port's AOT synthesis-program export (``aot.py``,
``cli/export_program.py``).

The tiny model of ``tests/test_torch_pipeline.py`` (f32, 2 DDIM steps) on
JAX param trees filled from a numpy seed and converted to the port: one
module-scoped artifact at batch 2 (int16 PCM), exported, saved and loaded
on the CPU, must give the live port ``Synthesizer``'s PCM and codes bit
for bit, and its codes must meet the JAX package's live program on the
same weights and x_T to ``test_torch_pipeline``'s contract.  The artifact
holds one step program (one UNet forward's kernel ops, whatever the step
count), no weight as a lifted constant, and loads in a process that
imports no model code.  The refusals follow ``tests/test_aot.py``.  The
f32-wav artifact, the prompted artifact and the CLI's ``--check`` are
``slow``, as the JAX package marks its own.
"""

import collections
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import Config as JaxConfig
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu.pipeline import latents_to_codes as jax_codes
from prompt_tts_tpu_torch import aot
from prompt_tts_tpu_torch.config import Config, ModelConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.diffusion.steps import initial_noise
from prompt_tts_tpu_torch.models.unet1d import cross_attn_sites
from prompt_tts_tpu_torch.pipeline import Synthesizer, codes_to_latents

CFG = ModelConfig(
    block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
    sample_size=48, layers_per_block=1, unet_num_heads=4)
TEXTS = ["hello world", "printing, in the only sense"]
STEPS = 2
SEED = 3
# tests/test_torch_pipeline.py's code contract: a latent within 5e-4 of
# JAX's may round to the neighbouring code at a .5 boundary, in at most
# 0.1 % of the entries (counted over four seeds' 3,072 entries: one call's
# 768 would allow none)
LATENT_TOL = 5e-4
MAX_FLIP_SHARE = 1e-3
CODE_SEEDS = (SEED, 4, 5, 6)
# the schedule's f32 table has 1,000 entries: nothing larger may be baked
# into a program as a constant (the weights are its state)
MAX_CONSTANT = 1024


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """A param tree of ``shapes`` from ``rng``: fan-in-scaled kernels,
    unit-normal embeddings, non-trivial biases and norm scales."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _synth(cfg=CFG, **kw):
    return Synthesizer(config=Config(model=cfg), device="cpu",
                       dtype=torch.float32, num_inference_steps=STEPS, **kw)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's live Synthesizer on JAX-filled weights, its batch-2 pcm16
    artifact, and the JAX package's codes for the artifact's x_T."""
    rng = np.random.default_rng(0)
    S, T, C = CFG.cmu_seq_len, CFG.sample_size, CFG.in_channels
    mparams = _fill(jax.eval_shape(
        JaxTTS(CFG).init, jax.random.PRNGKey(0), jnp.zeros((1, T, C)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, S), jnp.int32),
        jnp.ones((1, S), jnp.int32)), rng)
    synth = _synth(model_state=model_state_from_jax(mparams))
    path = str(tmp_path_factory.mktemp("aot") / "synth_b2.ptts")
    header = aot.export_synthesis(synth, len(TEXTS), path, pcm16=True)
    prog = aot.SynthesisProgram(path)

    jsynth = JaxSynthesizer(config=JaxConfig(model=CFG), model_params=mparams,
                            num_inference_steps=STEPS, dtype=jnp.float32)
    ids, mask = jsynth.tokenizer.encode_batch(TEXTS)
    denoise = jax.jit(jsynth._denoise_latents)
    jax_lat = {seed: np.asarray(denoise(
        mparams, initial_noise(seed, (len(TEXTS), T, C)).numpy(), ids, mask))
        for seed in CODE_SEEDS}
    return dict(synth=synth, path=path, header=header, prog=prog,
                eps=prog.call.programs, jax_lat=jax_lat)


def test_pcm16_round_trip_bit_equal(exported):
    h = exported["header"]
    assert h["batch_size"] == 2 and h["pcm16"] and not h["prompted"]
    assert h["device"] == "cpu" and h["timesteps"] == [500, 0]
    got, codes = exported["prog"].synthesize(TEXTS, seed=SEED,
                                             return_codes=True)
    want, want_codes = exported["synth"].synthesize(
        TEXTS, seed=SEED, pcm16=True, return_codes=True)
    assert got.dtype == np.int16 and got.shape == (2, 48 * 320)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codes, want_codes)


def test_codes_meet_the_jax_program(exported):
    """The artifact's codes against the JAX live program's on the same
    weights and x_T: at most a one-code flip, rarely, and only where JAX's
    latent lies within ``LATENT_TOL`` of a .5 rounding boundary."""
    diffs = []
    for seed, lat in exported["jax_lat"].items():
        _, codes = exported["prog"].synthesize(TEXTS, seed=seed,
                                               return_codes=True)
        want = np.asarray(jax_codes(jnp.asarray(lat)))
        assert codes.shape == want.shape == (2, 8, 48)
        diff = np.abs(codes.astype(np.int64) - want)
        scaled = (lat.transpose(0, 2, 1) + 1.0) * (1023.0 / 2.0)
        off = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5)
        assert (off[diff > 0] <= LATENT_TOL * 1023.0 / 2.0).all()
        diffs.append(diff)
    diff = np.stack(diffs)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_FLIP_SHARE


def test_one_step_program_of_one_unet_forward(exported):
    """The step program is one UNet forward plus one update, whatever the
    step count: each cross-attention site's transformer makes two
    attention calls, each resnet block one kernel call."""
    eps = exported["eps"]
    ops = collections.Counter(str(n.target) for n in eps["step"].graph.nodes
                              if n.op == "call_function")
    unet = exported["synth"].model.unet
    n_attn = 2 * sum(n for _, _, n in cross_attn_sites(CFG))
    n_res = sum(type(m).__name__ == "ResnetBlock1D" for m in unet.modules())
    assert ops["ptts.flash_attention.default"] == n_attn
    assert ops["ptts.fused_resnet_block.default"] == n_res
    assert ops["ptts.lstm_recurrence_t.default"] == 0
    fin = collections.Counter(str(n.target)
                              for n in eps["finish"].graph.nodes)
    assert fin["ptts.lstm_recurrence_t.default"] == 2   # the decoder's LSTM
    cond = collections.Counter(str(n.target)
                               for n in eps["condition"].graph.nodes)
    assert cond["ptts.flash_attention.default"] == CFG.text_encoder_layers


def test_weights_are_state_not_constants(exported):
    """No program bakes a tensor of more than ``MAX_CONSTANT`` elements in
    as a constant: the codec's, the UNet's and the packed kernel weights
    are the programs' parameters and buffers."""
    eps = exported["eps"]
    for name, ep in eps.items():
        consts = [s.target for s in ep.graph_signature.input_specs
                  if s.kind.name == "CONSTANT_TENSOR"]
        big = [c for c in consts if ep.constants[c].numel() > MAX_CONSTANT]
        assert not big, (name, big)
    assert "codec.codebooks" in eps["finish"].state_dict
    assert "codec.decoder.layer_1.l0_w_hh" in eps["finish"].state_dict
    buffers = eps["step"].graph_signature.buffers
    assert "unet.mid.resnet_0.kernel_w1" in buffers


def test_loader_imports_no_model_code(exported):
    """A fresh process loads and calls the artifact importing neither
    JAX nor the port's model, pipeline or config modules."""
    root = pathlib.Path(__file__).resolve().parents[1]
    script = (
        "import sys\n"
        "for m in ('jax', 'flax', 'prompt_tts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from prompt_tts_tpu_torch import aot\n"
        f"p = aot.SynthesisProgram({exported['path']!r})\n"
        f"wav = p.synthesize({TEXTS!r}, seed={SEED})\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'prompt_tts_tpu_torch.models', 'prompt_tts_tpu_torch.pipeline',"
        " 'prompt_tts_tpu_torch.config', 'prompt_tts_tpu_torch.codec'))]\n"
        "print(wav.dtype, wav.shape, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "int16 (2, 15360) []"


def test_batch_guard(exported):
    with pytest.raises(ValueError, match="batch-2"):
        exported["prog"].synthesize(["a"])


def test_bad_magic_rejected(tmp_path):
    path = tmp_path / "junk.ptts"
    path.write_bytes(b"NOTANART" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not a ptts torch AOT artifact"):
        aot.load_synthesis(str(path))
    # the JAX package's artifacts are refused by their magic too
    path.write_bytes(b"PTTSAOT1" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not a ptts torch AOT artifact"):
        aot.load_synthesis(str(path))


def _header_file(path, **header):
    hdr = json.dumps(header).encode()
    path.write_bytes(b"PTTSPT01" + struct.pack("<I", len(hdr)) + hdr)
    return str(path)


def test_wrong_version_rejected(tmp_path):
    path = _header_file(tmp_path / "old.ptts", version=0)
    with pytest.raises(ValueError, match="version 0"):
        aot.load_synthesis(path)


def test_wrong_device_rejected(tmp_path):
    # the header claims a device this process does not have
    path = _header_file(tmp_path / "wrongdev.ptts", version=1,
                        device="nonexistent_hw")
    with pytest.raises(ValueError, match="current backend"):
        aot.load_synthesis(path)
    if not torch.cuda.is_available():
        path = _header_file(tmp_path / "cuda.ptts", version=1,
                            device="cuda")
        with pytest.raises(ValueError, match="re-export with --device cpu"):
            aot.load_synthesis(path)


@pytest.mark.slow
def test_float32_and_batch_guard(tmp_path):
    synth = _synth()
    path = str(tmp_path / "synth_f32.ptts")
    aot.export_synthesis(synth, 1, path, pcm16=False)
    prog = aot.SynthesisProgram(path)
    got = prog.synthesize(["one"], seed=0)
    want = synth.synthesize(["one"], seed=0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="batch-1"):
        prog.synthesize(["a", "b"])


@pytest.mark.slow
def test_prompted_model(tmp_path):
    """DPM-Solver++ under guidance 3 on the prompt family: the prompt
    padded or cropped as the live Synthesizer does it."""
    import dataclasses
    cfg = dataclasses.replace(CFG, prompt_conditioning=True,
                              prompt_frames=24, prompt_encoder_layers=1,
                              prompt_tokens=8)
    synth = _synth(cfg, sampler="dpm", guidance_scale=3.0)
    path = str(tmp_path / "synth_prompted.ptts")
    header = aot.export_synthesis(synth, 1, path, pcm16=True)
    assert header["prompted"] and header["prompt_frames"] == 24
    prog = aot.SynthesisProgram(path)
    for frames in (24, 10):
        codes = np.full((1, 8, frames), 512, np.int32)
        lat = codes_to_latents(torch.from_numpy(codes)).numpy()
        got = prog.synthesize(["speak"], seed=1, prompt_latents=lat)
        want = synth.synthesize(["speak"], seed=1, pcm16=True,
                                prompt_codes=codes)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="prompt_latents"):
        prog.synthesize(["speak"])


@pytest.mark.slow
def test_cli_check(tmp_path):
    import dataclasses
    from prompt_tts_tpu_torch.cli import export_program
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(CFG)))
    out = str(tmp_path / "cli.ptts")
    export_program.main(["--out", out, "--batch", "1", "--steps", "2",
                         "--config_file", str(cfg_path), "--device", "cpu",
                         "--dtype", "f32", "--check"])
    assert aot.SynthesisProgram(out).batch_size == 1
