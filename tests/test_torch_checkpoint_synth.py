"""Train -> checkpoint -> synthesize in the PyTorch port, against JAX.

``cli.train --smoke --ema_decay 0.9 --ckpt_dir`` trains a tiny config of
each model family (two UNet levels, f32, on the CPU); the synthesis CLI
and ``cli._common.restore_model_state`` read that checkpoint back, its
parameters or their EMA.  The restored weights go to the JAX package too,
through ``convert.model_state_to_jax``: the latents the port samples from
them must match the JAX ``Synthesizer``'s device program on the same x_T,
text and prompt codes (the model-level 5e-4 contract, and the codes held
to ``tests/test_torch_pipeline.py``'s rule).  Then the CLI's refusals, the
converter's round trip, and the reference-repo checkpoints
(``--init_from_ref``, ``--ref_ckpt``) on the diffusers-named twin of
``tools/torch_twin.py``.
"""

import dataclasses
import os
import sys

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
from prompt_tts_tpu.models.convert import convert_reference_state_dict
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu_torch.cli import synthesize as synth_cli
from prompt_tts_tpu_torch.cli import train as train_cli
from prompt_tts_tpu_torch.cli._common import restore_model_state
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import (
    model_state_from_jax, model_state_to_jax,
)
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.convert import load_reference_state
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.pipeline import Synthesizer, latents_to_codes
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.loop import Trainer
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav

sys.path.insert(0, "tools")
from torch_twin import RefTTS  # noqa: E402

# latents: the model-level 5e-4 contract (f32 both sides, summation order
# differs) through 3 sampler steps, as tests/test_torch_prompt.py.
LATENT_TOL = 5e-4
# codes: a latent within 5e-4 can still round to the neighbouring code at
# a .5 boundary.  Every code that differs must be off by one, at a latent
# within LATENT_TOL of a rounding boundary; without guidance at most
# MAX_FLIP_SHARE of the codes may differ (tests/test_torch_pipeline.py),
# but at least one may: 0.1 % of the 768 codes here is less than one, and
# the params' single-speaker case has one, 0.001 of a code from the
# boundary.  Under guidance the null branch's text is all masked, where
# f32 scores at -1e4 keep ~1e-3 absolute (ROADMAP §3), and the scale 3
# amplifies the two sides' difference (measured on these weights: max
# 3.8e-4, mean 7.9e-6, 5 of 768 codes off by one, each within 0.05 of a
# code of the boundary; without guidance 7.5e-5 and none): there the
# share is not capped.
MAX_FLIP_SHARE = 1e-3
# the reference twin's outputs against JAX's converted tree
# (tests/test_reference_convert.py).
REF_TOL = 5e-4

WIDTHS = dict(block_out_channels=(32, 64), cross_attention_dim=64,
              down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
              up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=48, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0)
PROMPT = dict(prompt_conditioning=True, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
FAMILIES = {"single": {}, "prompt": PROMPT}
# (family, sampler, guidance scale) of the comparisons with JAX
SAMPLING = [("single", "ddim", 1.0), ("prompt", "dpm", 1.0),
            ("prompt", "dpm", 3.0)]
TRAIN = TrainConfig(batch_size=8, num_train_epochs=1, learning_rate=1e-3,
                    lr_warmup_steps=0, cond_dropout_prob=0.2)
TEXTS = ["hello world", "printing, in the only sense"]
STEPS = 3

REF_CFG = dict(cmu_vocab_len=160, cmu_seq_len=24, cross_attention_dim=32,
               attention_head_dim=16, text_encoder_layers=2,
               text_encoder_dropout=0.0, sample_size=32,
               block_out_channels=(16, 32, 32, 32), layers_per_block=1,
               unet_num_heads=4, norm_num_groups=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: the shapes are tiny,
    and OpenMP's spinning worker threads stall when the suite's parallel
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family):
    return ModelConfig(**WIDTHS, **FAMILIES[family])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Per family: a config file, and a checkpoint that ``cli.train
    --smoke --ema_decay 0.9`` wrote; a random codec state dict from
    ``cli.convert_codec``; a 22.05 kHz voice-prompt wav."""
    from prompt_tts_tpu_torch.cli import convert_codec
    root = tmp_path_factory.mktemp("ckpt_synth")
    out = {}
    for family in FAMILIES:
        d = root / family
        d.mkdir()
        cfg = str(d / "config.json")
        Config(model=_cfg(family), train=TRAIN).to_json(cfg)
        trainer = train_cli.main([
            "--smoke", "--config_file", cfg, "--device", "cpu",
            "--ema_decay", "0.9", "--ckpt_dir", str(d / "ck"),
            "--log_dir", str(d / "log")])
        assert trainer.global_step == 2
        out[family] = dict(config=cfg, ckpt=str(d / "ck"))
    out["codec"] = str(root / "codec.pt")
    convert_codec.main(["--random", "--out", out["codec"]])
    out["voice"] = str(root / "voice.wav")
    t = np.arange(8820) / 22050.0
    write_wav(out["voice"], (0.4 * np.sin(2 * np.pi * 170 * t)).astype(
        np.float32), 22050)
    return out


# --- restored weights against the JAX Synthesizer -----------------------


@pytest.fixture(scope="module")
def jax_side(run):
    """Per sampling case, a JAX Synthesizer (zero codec; only its denoiser
    runs; built on the restored parameters, so it draws no weights of its
    own) and its jitted ``_denoise_latents``.  Shared inputs: x_T and
    prompt codes."""
    codec = jax.tree.map(np.zeros_like, jax.eval_shape(
        lambda r, w: JaxCodec().init(r, w, 6.0), jax.random.PRNGKey(1),
        jnp.zeros((1, 3200))))
    cases = {}
    for family, sampler, scale in SAMPLING:
        cfg = Config.from_json(run[family]["config"])
        state, _ = restore_model_state(run[family]["ckpt"], cfg)
        jsynth = JaxSynthesizer(
            config=JaxConfig(model=JaxModelConfig(**WIDTHS,
                                                  **FAMILIES[family])),
            model_params=model_state_to_jax(state, cfg.model),
            codec_params=codec, num_inference_steps=STEPS, sampler=sampler,
            guidance_scale=scale, dtype=jnp.float32)
        cases[family, sampler, scale] = (jsynth,
                                         jax.jit(jsynth._denoise_latents))
    rng = np.random.default_rng(0)
    return dict(cases=cases,
                x_T=rng.standard_normal((len(TEXTS), 48, 8)).astype(
                    np.float32),
                codes=rng.integers(0, 1024, (len(TEXTS), 8, 30)))


@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("family,sampler,scale", SAMPLING)
def test_restored_latents_match_jax(run, jax_side, family, sampler, scale,
                                    ema):
    cfg = Config.from_json(run[family]["config"])
    state, step = restore_model_state(run[family]["ckpt"], cfg, ema=ema)
    assert step == 2
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in state.values())
    port = Synthesizer(config=cfg, device="cpu", dtype=torch.float32,
                       num_inference_steps=STEPS, sampler=sampler,
                       guidance_scale=scale, model_state=state)
    jsynth, denoise = jax_side["cases"][family, sampler, scale]
    ids, mask = jsynth.tokenizer.encode_batch(TEXTS)
    x_T, codes = jax_side["x_T"], jax_side["codes"]
    prompt_j = prompt_p = None
    if family == "prompt":
        prompt_j = jsynth._device_args(TEXTS, 0, prompt_codes=codes)[3]
        prompt_p = port.prompt_latents(prompt_codes=codes)
    want = np.asarray(denoise(model_state_to_jax(state, cfg.model), x_T,
                              ids, mask, prompt_j))
    got = port.denoise_latents(torch.from_numpy(x_T), torch.from_numpy(ids),
                               torch.from_numpy(mask), prompt_p)
    np.testing.assert_allclose(got.numpy(), want, atol=LATENT_TOL, rtol=0)
    diff = np.abs(latents_to_codes(got).numpy().astype(np.int64)
                  - latents_to_codes(torch.from_numpy(want.copy())).numpy())
    assert diff.max() <= 1
    c = (want.transpose(0, 2, 1) + 1.0) * (1023.0 / 2.0)
    to_boundary = np.abs(c - np.floor(c) - 0.5)
    assert np.all(to_boundary[diff > 0] <= LATENT_TOL * 1023.0 / 2.0)
    if scale == 1.0:
        assert (diff > 0).sum() <= max(1, MAX_FLIP_SHARE * diff.size)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ema_is_the_average_not_the_params(run, family):
    """The EMA read maps ``TrainState``'s per-parameter names onto the
    model's keys: every key, other values than the parameters."""
    cfg = Config.from_json(run[family]["config"])
    params, _ = restore_model_state(run[family]["ckpt"], cfg)
    avg, _ = restore_model_state(run[family]["ckpt"], cfg, ema=True)
    assert list(avg) == list(params)
    moved = [k for k in params if not torch.equal(params[k], avg[k])]
    assert len(moved) > len(params) // 2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cli_codes_equal_an_in_process_synthesizer(run, tmp_path, family):
    """``cli.synthesize --ckpt_dir --ema --codec_params`` gives the same
    codes and wavs as ``Synthesizer(model_state=..., codec_state=...)`` at
    the same seed (the prompt family with ``--text_file``, a resampled
    voice prompt, DPM and guidance 3; the single-speaker family with
    ``--trim``)."""
    cfg = Config.from_json(run[family]["config"])
    sampler, scale = SAMPLING[-1][1:] if family == "prompt" else ("ddim",
                                                                  1.0)
    argv = ["--out", str(tmp_path / "x.wav"), "--config_file",
            run[family]["config"], "--ckpt_dir", run[family]["ckpt"],
            "--ema", "--codec_params", run["codec"], "--steps", "2",
            "--sampler", sampler, "--guidance_scale", str(scale),
            "--device", "cpu", "--dtype", "f32", "--seed", "3"]
    prompt_wav = None
    if family == "prompt":
        (tmp_path / "texts.txt").write_text("\n".join(TEXTS) + "\n\n")
        argv += ["--text_file", str(tmp_path / "texts.txt"),
                 "--prompt_wav", run["voice"]]
        from prompt_tts_tpu_torch.utils.resample import resample
        audio, sr = read_wav(run["voice"])
        prompt_wav = np.tile(resample(audio, sr, 24000)[None, :, 0],
                             (len(TEXTS), 1))
    else:
        argv += sum((["--text", t] for t in TEXTS), []) + ["--trim"]
    paths, wavs, codes = synth_cli.main(argv)
    state, _ = restore_model_state(run[family]["ckpt"], cfg, ema=True)
    synth = Synthesizer(config=cfg, device="cpu", dtype=torch.float32,
                        num_inference_steps=2, sampler=sampler,
                        guidance_scale=scale, model_state=state,
                        codec_state=torch.load(run["codec"],
                                               weights_only=True))
    wavs_p, codes_p = synth.synthesize(TEXTS, seed=3, return_codes=True,
                                       prompt_wav=prompt_wav)
    np.testing.assert_array_equal(codes, codes_p)
    np.testing.assert_array_equal(wavs, wavs_p)
    assert len(paths) == len(TEXTS)
    for p, w in zip(paths, wavs):
        audio, sr = read_wav(p)
        assert sr == 24000 and 0 < len(audio) <= len(w)


def test_ema_of_a_checkpoint_without_one_exits_before_any_load(
        tmp_path, monkeypatch):
    import prompt_tts_tpu_torch.pipeline as pipeline
    cfg = Config(model=_cfg("single"), train=TRAIN)
    cfg.to_json(str(tmp_path / "c.json"))
    state = TrainState(TTSSingleSpeaker(cfg.model), TRAIN, 10)
    assert state.ema is None
    CheckpointManager(str(tmp_path / "ck")).save(state, 1)

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(pipeline, "Synthesizer", no_model)
    monkeypatch.setattr(torch.nn.Module, "load_state_dict", no_model)
    with pytest.raises(SystemExit, match=r"step 1\) has no ema_params "
                                         r"\(train with --ema_decay"):
        synth_cli.main(["--text", "hi", "--out", str(tmp_path / "x.wav"),
                        "--config_file", str(tmp_path / "c.json"),
                        "--ckpt_dir", str(tmp_path / "ck"), "--ema",
                        "--device", "cpu"])


def test_ema_without_ckpt_dir_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--ema requires --ckpt_dir"):
        synth_cli.main(["--text", "hi", "--out", str(tmp_path / "x.wav"),
                        "--ema", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--text / --text_file"):
        synth_cli.main(["--out", str(tmp_path / "x.wav"), "--device",
                        "cpu"])


@pytest.mark.parametrize("other,key", [
    (dict(WIDTHS, block_out_channels=(32, 32)), "size mismatch for unet"),
    (dict(WIDTHS, **PROMPT), "Missing key.*prompt_encoder")])
def test_a_config_that_does_not_fit_names_the_keys(run, tmp_path, other,
                                                   key):
    """The single-speaker checkpoint under other widths, or under the
    prompt family: the strict load names the keys."""
    path = str(tmp_path / "other.json")
    Config(model=ModelConfig(**other), train=TRAIN).to_json(path)
    with pytest.raises(RuntimeError, match=key):
        synth_cli.main(["--text", "hi", "--out", str(tmp_path / "x.wav"),
                        "--config_file", path, "--ckpt_dir",
                        run["single"]["ckpt"], "--device", "cpu"])


# --- the converters -----------------------------------------------------


def _fill(shapes, rng):
    def leaf(path, s):
        return rng.standard_normal(s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_state_to_jax_inverts_from_jax(family):
    """``model_state_to_jax(model_state_from_jax(tree))`` is ``tree``, leaf
    for leaf and bit for bit, and it loads back into the port strictly."""
    jcfg = JaxModelConfig(**WIDTHS, **FAMILIES[family])
    model = (JaxPrompt if family == "prompt" else JaxSingle)(jcfg)
    args = [jnp.zeros((1, 48, 8)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 32), jnp.int32), jnp.ones((1, 32), jnp.int32)]
    if family == "prompt":
        args.append(jnp.zeros((1, 24, 8)))
    tree = _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args),
                 np.random.default_rng(1))
    state = model_state_from_jax(tree)
    back = model_state_to_jax(state, _cfg(family))
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    with pytest.raises(ValueError, match="missing"):
        model_state_to_jax(state, _cfg("single" if family == "prompt"
                                       else "prompt"))


# --- reference-repo checkpoints -----------------------------------------


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A diffusers-named twin's ``state_dict`` saved as ``ckpt_3.pt``, and
    its config as the port reads it."""
    root = tmp_path_factory.mktemp("ref")
    torch.manual_seed(0)
    ref = RefTTS(JaxModelConfig(**REF_CFG)).eval()
    path = str(root / "ckpt_3.pt")
    torch.save(ref.state_dict(), path)
    cfg_path = str(root / "ref.json")
    Config(model=ModelConfig(**REF_CFG),
           train=dataclasses.replace(TRAIN, num_train_epochs=1)
           ).to_json(cfg_path)
    return dict(path=path, config=cfg_path, sd=ref.state_dict())


def test_reference_checkpoint_outputs_match_jax(ref_ckpt):
    """``load_reference_state`` in the port against the JAX package's
    ``convert_reference_state_dict`` tree: the same forward to 5e-4."""
    cfg = ModelConfig(**REF_CFG)
    port = TTSSingleSpeaker(cfg).eval()
    port.load_state_dict(load_reference_state(ref_ckpt["path"]),
                         strict=True)
    rng = np.random.default_rng(2)
    B, T, S = 2, cfg.sample_size, cfg.cmu_seq_len
    sample = rng.standard_normal((B, T, 8)).astype(np.float32)
    t = np.array([7, 450], np.int32)
    ids = rng.integers(0, 150, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, S // 2:] = 0
    want = jax.jit(JaxSingle(JaxModelConfig(**REF_CFG)).apply)(
        convert_reference_state_dict(ref_ckpt["sd"]), sample, t, ids, mask)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (sample, t, ids, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REF_TOL,
                               rtol=0)


def test_init_from_ref_adopts_the_weights(ref_ckpt, tmp_path):
    """``Trainer(init_state=...)`` starts from the converted weights, and
    ``cli.train --init_from_ref`` trains on from them."""
    cfg = Config.from_json(ref_ckpt["config"])
    init = load_reference_state(ref_ckpt["path"])
    ds = SyntheticDataset(n=8, frames=cfg.model.sample_size,
                          max_seq_length=cfg.model.cmu_seq_len)
    trainer = Trainer(cfg, ds, log_dir=str(tmp_path / "a"), device="cpu",
                      init_state=init)
    for n, p in trainer.model.state_dict().items():
        assert torch.equal(p, init[n]), n
    t2 = train_cli.main(["--smoke", "--config_file", ref_ckpt["config"],
                         "--init_from_ref", ref_ckpt["path"], "--device",
                         "cpu", "--log_dir", str(tmp_path / "b")])
    assert t2.global_step == 2
    assert not torch.equal(t2.model.unet.conv_in.conv.weight,
                           init["unet.conv_in.conv.weight"])


def test_init_from_ref_refuses_another_config(ref_ckpt, tmp_path):
    cfg = Config(model=ModelConfig(**dict(REF_CFG, block_out_channels=(
        16, 16, 32, 32))), train=TRAIN)
    ds = SyntheticDataset(n=8, frames=32, max_seq_length=24)
    with pytest.raises(ValueError, match=r"init_state does not match.*"
                                         r"shape-mismatch=\['unet"):
        Trainer(cfg, ds, log_dir=str(tmp_path), device="cpu",
                init_state=load_reference_state(ref_ckpt["path"]))


def test_init_from_ref_with_resume_is_refused():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(["--smoke", "--resume", "--init_from_ref", "x.pt",
                        "--device", "cpu"])


def test_synthesize_from_a_reference_checkpoint(ref_ckpt, tmp_path):
    """``cli.synthesize --ref_ckpt``: the codes of an in-process
    ``Synthesizer`` on the converted weights."""
    paths, wavs, codes = synth_cli.main([
        "--text", TEXTS[0], "--out", str(tmp_path / "x.wav"),
        "--config_file", ref_ckpt["config"], "--ref_ckpt", ref_ckpt["path"],
        "--steps", "2", "--device", "cpu", "--dtype", "f32"])
    synth = Synthesizer(config=Config.from_json(ref_ckpt["config"]),
                        device="cpu", dtype=torch.float32,
                        num_inference_steps=2,
                        model_state=load_reference_state(ref_ckpt["path"]))
    _, want = synth.synthesize(TEXTS[:1], seed=0, return_codes=True)
    np.testing.assert_array_equal(codes, want)
    assert os.path.exists(paths[0])
