"""The port's reference export (``models/export.py``,
``cli/export_checkpoint.py``) against ``prompt_tts_tpu/models/export.py``.

On the same weights (a JAX param tree, loaded into the port with
``convert.model_state_from_jax``) the port's export is the JAX export bit
for bit; export then ``models/convert.py`` is the identity on the port's
state dict; the synthesized ``inv_freq`` follows the reference formula;
the prompt encoder's leftovers raise; the CLI writes a ``ckpt_N.pt`` of a
checkpoint the port trained (parameters and EMA) that loads back bit for
bit, and refuses a prompt-conditioned config with the JAX message.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.models.export import (
    export_reference_state_dict as jax_export,
)
from prompt_tts_tpu_torch.cli import export_checkpoint as cli
from prompt_tts_tpu_torch.cli._common import restore_model_state
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.models.convert import (
    convert_reference_state_dict, load_reference_state,
)
from prompt_tts_tpu_torch.models.export import (
    _inv_freq, export_reference_state_dict, save_reference_checkpoint,
)
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.pipeline import random_init_

CFG = dict(cmu_vocab_len=160, cmu_seq_len=24, cross_attention_dim=32,
           attention_head_dim=16, text_encoder_layers=2,
           text_encoder_dropout=0.0, sample_size=32,
           block_out_channels=(16, 32, 32, 32), layers_per_block=1,
           unet_num_heads=4, norm_num_groups=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """A JAX ``TTSSingleSpeaker`` tree filled from a numpy seed."""
    cfg = JaxModelConfig(**CFG)
    ids = jnp.zeros((1, cfg.cmu_seq_len), jnp.int32)
    shapes = jax.eval_shape(
        JaxTTS(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.sample_size, cfg.in_channels)),
        jnp.zeros((1,), jnp.int32), ids, jnp.ones_like(ids))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_export_is_the_jax_export(jax_params):
    want = jax_export(jax_params, JaxModelConfig(**CFG))
    got = export_reference_state_dict(model_state_from_jax(jax_params),
                                      ModelConfig(**CFG))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_export_then_convert_is_the_identity(jax_params):
    state = model_state_from_jax(jax_params)
    back = model_state_from_jax(convert_reference_state_dict(
        export_reference_state_dict(state, ModelConfig(**CFG))))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_inv_freq_follows_the_reference_formula():
    for seq_len in (24, 25, 550):
        channels = int(np.ceil(seq_len / 2) * 2)
        want = 1.0 / (10000.0 ** (
            torch.arange(0, channels, 2).float() / channels))
        np.testing.assert_allclose(_inv_freq(seq_len), want.numpy(),
                                   rtol=1e-6)
        assert _inv_freq(seq_len).shape == (channels // 2,)


def test_synthesized_proj_out_is_zero(jax_params):
    sd = export_reference_state_dict(model_state_from_jax(jax_params),
                                     ModelConfig(**CFG))
    outs = [k for k in sd if ".proj_out." in k]
    assert outs and all(not np.any(sd[k]) for k in outs)
    w = [k for k in outs if k.endswith("weight")][0]
    proj_in = sd[w.replace("proj_out", "proj_in")]
    assert sd[w].shape == (proj_in.shape[1], proj_in.shape[0], 1)


def test_prompt_encoder_leftovers_raise():
    cfg = ModelConfig(**CFG, prompt_conditioning=True, prompt_frames=16,
                      prompt_encoder_layers=1, prompt_tokens=4)
    model = TTSPromptSpeaker(cfg)
    random_init_(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="prompt_encoder"):
        export_reference_state_dict(model.state_dict(), cfg)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint of two smoke steps of the port's trainer, with EMA."""
    from prompt_tts_tpu_torch.cli import train as train_cli
    root = tmp_path_factory.mktemp("export")
    cfg = str(root / "cfg.json")
    Config(model=ModelConfig(**CFG),
           train=TrainConfig(batch_size=8, num_train_epochs=1,
                             learning_rate=1e-3, lr_warmup_steps=0)
           ).to_json(cfg)
    train_cli.main(["--smoke", "--config_file", cfg, "--device", "cpu",
                    "--ema_decay", "0.9", "--ckpt_dir", str(root / "ck"),
                    "--log_dir", str(root / "log")])
    return dict(root=root, cfg=cfg, ckpt=str(root / "ck"))


@pytest.mark.parametrize("ema", [False, True])
def test_cli_round_trips_a_port_checkpoint(trained, ema):
    out = str(trained["root"] / f"ckpt_{int(ema)}.pt")
    n = cli.main(["--ckpt_dir", trained["ckpt"], "--out", out,
                  "--config_file", trained["cfg"]] + (["--ema"] * ema))
    saved = torch.load(out, map_location="cpu", weights_only=True)
    assert len(saved) == n > 100
    assert all(t.dtype == torch.float32 for t in saved.values())
    want, _ = restore_model_state(trained["ckpt"],
                                  Config.from_json(trained["cfg"]), ema=ema)
    got = load_reference_state(out)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_ema_and_params_differ(trained):
    cfg = Config.from_json(trained["cfg"])
    a, _ = restore_model_state(trained["ckpt"], cfg)
    b, _ = restore_model_state(trained["ckpt"], cfg, ema=True)
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_cli_refuses_a_prompted_config(tmp_path):
    cfg = Config(model=dataclasses.replace(ModelConfig(**CFG),
                                           prompt_conditioning=True))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    with pytest.raises(SystemExit, match="single-speaker only"):
        cli.main(["--ckpt_dir", str(tmp_path / "ckpt"), "--out",
                  str(tmp_path / "x.pt"), "--config_file", path])


def test_save_reference_checkpoint_counts_the_entries(jax_params, tmp_path):
    path = str(tmp_path / "ckpt_0.pt")
    state = model_state_from_jax(jax_params)
    n = save_reference_checkpoint(state, ModelConfig(**CFG), path)
    # every port tensor, the inv_freq buffer and each transformer's
    # proj_out weight and bias
    n_transformers = sum(k.endswith("proj_in.weight") for k in state)
    assert n == len(state) + 1 + 2 * n_transformers
