"""``cli.evaluate`` of the port against ``prompt_tts_tpu/cli/evaluate.py``.

A tiny code tar and, per family, a checkpoint that the port's
``cli.train --ema_decay`` wrote on it.  The CLI on the CPU: the JAX CLI's
JSON keys, two runs bit-equal, the EMA scored apart from the parameters,
``--streaming`` equal to the in-RAM read, ``--max_batches``, a timestep
grid outside [0, T) refused, and the prompt family's batches carrying
prompt crops.  Then the CLI's losses over one batch (``batch_losses``)
against JAX ``make_eval_step`` and ``make_eval_step_at`` on the same
weights, with JAX's noise and timesteps injected, to 1e-5.
"""

import io
import json
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.train.step import make_eval_step as jax_eval_step
from prompt_tts_tpu.train.step import make_eval_step_at as jax_eval_step_at
from prompt_tts_tpu_torch.cli import evaluate as cli
from prompt_tts_tpu_torch.cli import train as train_cli
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.train.step import eval_generator

# eps-MSE over outputs that agree to the model-level 5e-4 contract, f32
# both sides (the mean averages the differences down)
LOSS_TOL = 1e-5

WIDTHS = dict(block_out_channels=(32, 64), cross_attention_dim=64,
              down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
              up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=48, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0)
PROMPT = dict(prompt_conditioning=True, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
FAMILIES = {"single": {}, "prompt": PROMPT}
TEXTS = ["hello world", "printing, in the only sense", "one two three",
         "the quick brown fox", "a fifth", "six"]
GRID = [10, 500, 990]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A six-utterance tar of 48 frames, and per family a config and the
    checkpoint of one epoch of ``cli.train --ema_decay 0.5`` on it."""
    root = tmp_path_factory.mktemp("evaluate")
    tar = str(root / "codes.tar")
    rng = np.random.default_rng(0)
    with tarfile.open(tar, "w") as tf:
        for i, text in enumerate(TEXTS):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 1024, (8, 48)).astype(np.int64))
            _add(tf, f"u{i}.npy", buf.getvalue())
            _add(tf, f"u{i}.txt", text.encode())
            _add(tf, f"u{i}.len.txt", f"{30 + 3 * i}.0".encode())
    out = {"tar": tar}
    for family, extra in FAMILIES.items():
        cfg = str(root / f"{family}.json")
        Config(model=ModelConfig(**WIDTHS, **extra),
               train=TrainConfig(batch_size=2, num_train_epochs=1,
                                 learning_rate=1e-3, lr_warmup_steps=0)
               ).to_json(cfg)
        ckpt = str(root / f"{family}_ck")
        train_cli.main(["--data_file", tar, "--config_file", cfg,
                        "--max_seq_length", "32", "--ema_decay", "0.5",
                        "--ckpt_dir", ckpt, "--log_dir",
                        str(root / f"{family}_log"), "--device", "cpu"])
        out[family] = dict(config=cfg, ckpt=ckpt)
    return out


def _eval(run, family, capsys, *extra):
    cli.main(["--data_file", run["tar"], "--ckpt_dir", run[family]["ckpt"],
              "--config_file", run[family]["config"], "--device", "cpu",
              "--timesteps", ",".join(map(str, GRID))] + list(extra))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_is_deterministic_and_scores_the_ema_apart(run, capsys):
    raw = _eval(run, "single", capsys)
    assert set(raw) == {"eval_loss", "num_batches", "batch_size", "step",
                        "params", "timestep_profile"}
    assert raw["num_batches"] == 3 and raw["batch_size"] == 2
    assert raw["step"] == 3 and raw["params"] == "raw"
    assert list(raw["timestep_profile"]) == [str(t) for t in GRID]
    assert all(np.isfinite(v) for v in raw["timestep_profile"].values())
    assert _eval(run, "single", capsys) == raw
    assert _eval(run, "single", capsys, "--streaming") == raw
    ema = _eval(run, "single", capsys, "--ema")
    assert ema["params"] == "ema" and ema["eval_loss"] != raw["eval_loss"]
    two = _eval(run, "single", capsys, "--max_batches", "2", "--streaming")
    assert two["num_batches"] == 2


def test_cli_scores_the_prompt_familys_ema_apart(run, capsys):
    raw = _eval(run, "prompt", capsys, "--streaming")
    ema = _eval(run, "prompt", capsys, "--ema")
    assert raw["num_batches"] == ema["num_batches"] == 3
    assert ema["params"] == "ema" and ema["eval_loss"] != raw["eval_loss"]
    assert all(np.isfinite(v) for v in ema["timestep_profile"].values())


def test_cli_refuses_a_grid_outside_the_schedule(run, capsys):
    with pytest.raises(SystemExit, match=r"outside \[0, 1000\): \[1000\]"):
        cli.main(["--data_file", run["tar"], "--ckpt_dir",
                  run["single"]["ckpt"], "--config_file",
                  run["single"]["config"], "--device", "cpu",
                  "--timesteps", "5,1000"])


def test_empty_grid_and_the_prompt_crops(run, capsys, monkeypatch):
    """No grid, no profile; the prompt family's batches carry crops of
    its ``prompt_frames``."""
    seen = []
    real = cli.batch_losses

    def spy(model, schedule, batch, grid, *a, **kw):
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return real(model, schedule, batch, grid, *a, **kw)
    monkeypatch.setattr(cli, "batch_losses", spy)
    cli.main(["--data_file", run["tar"], "--ckpt_dir", run["prompt"]["ckpt"],
              "--config_file", run["prompt"]["config"], "--device", "cpu",
              "--timesteps", ""])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "timestep_profile" not in res
    assert len(seen) == 3
    assert all(s["prompt"] == (2, PROMPT["prompt_frames"], 8) for s in seen)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_losses_match_jax_eval_steps(family):
    extra = FAMILIES[family]
    rng = np.random.default_rng(3)
    B, S, T = 2, WIDTHS["cmu_seq_len"], WIDTHS["sample_size"]
    batch = {"codes": rng.uniform(-1, 1, (B, T, 8)).astype(np.float32),
             "text_ids": rng.integers(1, 149, (B, S)).astype(np.int32),
             "text_mask": np.ones((B, S), np.int32)}
    batch["text_mask"][1, 10:] = 0
    if extra:
        batch["prompt"] = rng.uniform(
            -1, 1, (B, extra["prompt_frames"], 8)).astype(np.float32)
    jmodel = (JaxPrompt if extra else JaxTTS)(
        JaxModelConfig(**WIDTHS, **extra))
    args = [jnp.asarray(batch[k]) for k in ("codes",)]
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), args[0],
        jnp.zeros((B,), jnp.int32), jnp.asarray(batch["text_ids"]),
        jnp.asarray(batch["text_mask"]),
        *([jnp.asarray(batch["prompt"])] if extra else []))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    key = jax.random.PRNGKey(9)
    js = jax_schedule()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ev = jax_eval_step(jmodel.apply, js)
    at = jax_eval_step_at(jmodel.apply, js)
    # one program: the eval step and the grid's steps (t traced, as the
    # JAX CLI runs them)
    want, want_at = jax.jit(lambda p, b, k: (ev(p, b, k), jax.lax.map(
        lambda t: at(p, b, k, t), jnp.asarray(GRID))))(params, jb, key)
    want, want_at = float(want), [float(w) for w in want_at]
    # the noise and timesteps each JAX step derives from its key
    rng_noise, rng_t = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        rng_noise, batch["codes"].shape)))
    ts = torch.from_numpy(np.array(jax.random.randint(
        rng_t, (B,), 0, 1000, dtype=jnp.int32))).long()
    grid_noise = torch.from_numpy(np.array(jax.random.normal(
        key, batch["codes"].shape)))

    model = (TTSPromptSpeaker if extra else TTSSingleSpeaker)(
        ModelConfig(**WIDTHS, **extra))
    model.load_state_dict(model_state_from_jax(params), strict=True)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    loss, got_at = cli.batch_losses(model, linear_schedule(), tb, GRID,
                                    noise=noise, timesteps=ts,
                                    grid_noise=grid_noise)
    assert abs(float(loss) - want) <= LOSS_TOL
    for t, g, w in zip(GRID, got_at, want_at):
        assert abs(float(g) - w) <= LOSS_TOL, t
    # the CLI's own draws: the grid reuses the batch's noise
    g = eval_generator(torch.device("cpu"), 0, 1)
    loss_a, at_a = cli.batch_losses(model, linear_schedule(), tb, GRID, g)
    g = eval_generator(torch.device("cpu"), 0, 1)
    loss_b, at_b = cli.batch_losses(model, linear_schedule(), tb, GRID, g)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(at_a, at_b))
