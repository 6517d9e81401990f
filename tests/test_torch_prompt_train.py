"""Training the prompt-conditioned family: the PyTorch port against JAX.

Tiny prompt config (``test_torch_prompt.py``'s widths on two UNet levels),
f32, dropout off.
The JAX param tree is filled from a numpy seed and loaded into the port
with ``model_state_from_jax``; batches come from the same seed.  The
prompt crops of both datasets must be the JAX package's bits.  One train
step is held to JAX ``make_train_step`` with ``cond_dropout_prob`` 0.5:
the JAX key is chosen so that its condition drop nulls one row and keeps
the other, and the noise, timesteps and drop it derives
(``prompt_tts_tpu/train/step.py:73-88``) are passed to the port's loss.
JAX's gradients are read from that step's first AdamW moment
(``mu = (1 - b1) * g``, with the clip undone by the step's gradient norm),
so one jitted program gives the loss, the gradients and the update.
Then the eval steps with the prompt, the ``Trainer``'s checkpoint and
resume on a prompt dataset, and the train CLI on a prompt config.
"""

import dataclasses
import io
import json
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.config import TrainConfig as JaxTrainConfig
from prompt_tts_tpu.data import dataset as jax_dataset
from prompt_tts_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from prompt_tts_tpu.data.dataset import _crop_prompts as jax_crop_prompts
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.train.state import create_train_state
from prompt_tts_tpu.train.step import make_eval_step as jax_make_eval_step
from prompt_tts_tpu.train.step import (
    make_eval_step_at as jax_make_eval_step_at,
)
from prompt_tts_tpu.train.step import make_train_step as jax_make_train_step
from prompt_tts_tpu.train.step import optax_global_norm
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import _find_adam, model_state_from_jax
from prompt_tts_tpu_torch.data.dataset import CodeDataset, SyntheticDataset
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.train.loop import Trainer
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.train.step import (
    make_eval_step, make_eval_step_at, make_loss_fn, make_train_step,
)

# loss: the MSE of outputs that agree to the model-level 5e-4 contract,
# f32 both sides.
LOSS_TOL = 1e-4
# gradients: f32 backward through the same model, sums in another order;
# relative L2 per parameter tensor, and the global norm.
GRAD_RTOL = 1e-4
# a gradient that is zero in exact arithmetic (a bias in front of a
# GroupNorm) is rounding noise on both sides: held below this share of the
# global norm instead.
ZERO_GRAD = 1e-6
# the parameters after one clip + AdamW update at lr 5e-5: an entry whose
# gradient is within rounding of 0 may move by up to lr either way on one
# side (Adam's first step is ~lr * sign(g)), so the parameters agree to
# 2 * lr = 1e-4; the update as a whole must agree in relative L2.
LR = 5e-5
PARAM_ATOL = 2 * LR
UPDATE_RTOL = 1e-2

# two UNet levels (one with cross-attention, and the mid block's): the
# prompt encoder, the joint drop and cross-attention over text + prompt
# tokens at half the JAX compile time of four levels
WIDTHS = dict(block_out_channels=(32, 64), cross_attention_dim=64,
              down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
              up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=48, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
JCFG = JaxModelConfig(prompt_conditioning=True, **WIDTHS)
CFG = ModelConfig(prompt_conditioning=True, **WIDTHS)
TRAIN = dict(learning_rate=LR, lr_warmup_steps=0, lr_scheduler="constant",
             weight_decay=0.1, batch_size=2, cond_dropout_prob=0.5)
B = 2


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
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name in ("bias", "queries") else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- prompt crops -------------------------------------------------------


def _code_tar(path, rng):
    """A code tar of 5 utterances, one shorter than prompt_frames."""
    lens = [48, 40, 30, 10, 48]   # frames; 10 < prompt_frames
    texts = ["hello world", "the only sense", "one two three", "a b",
             "printing"]
    with tarfile.open(path, "w") as tf:
        for i, (n, text) in enumerate(zip(lens, texts)):
            codes = rng.integers(0, 1024, (8, 48))
            codes[:, n:] = 0
            buf = io.BytesIO()
            np.save(buf, codes)
            for name, data in ((f"u{i}.npy", buf.getvalue()),
                               (f"u{i}.len.txt", f"{float(n)}".encode()),
                               (f"u{i}.txt", text.encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return lens


# The JAX package collates with its native C++ library when that is built:
# one FMA where numpy rounds twice, at most one f32 ulp of 1.0 apart
# (tests/test_torch_data.py); its numpy collate gives the same bits.
NATIVE_ATOL = 2.0 ** -23


def _same_batches(ours, theirs, atol=0.0):
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        assert set(a) == set(b)
        for k in a:
            if k in ("codes", "prompt") and atol:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
    return n


@pytest.mark.parametrize("native", [False, True])
def test_code_dataset_prompt_crops_are_jax_bits(tmp_path, native,
                                                monkeypatch):
    """Crops stay inside ``code_len`` where they fit (an utterance shorter
    than the crop starts at 0), with the JAX package's ``(seed, start)``
    crop stream: every crop is
    JAX ``_crop_prompts``'s bits on the same latents, and the batches are
    the JAX dataset's (within an ulp of its native collate)."""
    if native and jax_dataset.native.get_lib() is None:
        pytest.skip("the JAX package's native collate library is not built")
    if not native:
        monkeypatch.setattr(jax_dataset.native, "get_lib", lambda: None)
    lens = _code_tar(tmp_path / "codes.tar", np.random.default_rng(0))
    kw = dict(max_seq_length=32, prompt_frames=24)
    ours = CodeDataset(str(tmp_path / "codes.tar"), **kw)
    theirs = jax_dataset.CodeDataset(str(tmp_path / "codes.tar"), **kw)
    for seed in (0, 3):
        bk = dict(batch_size=2, shuffle=True, seed=seed, drop_last=False)
        assert _same_batches(ours.batches(**bk), theirs.batches(**bk),
                             NATIVE_ATOL if native else 0.0) == 3
        for start, b in zip((0, 2, 4), ours.batches(**bk)):
            np.testing.assert_array_equal(b["prompt"], jax_crop_prompts(
                b["codes"], b["code_len"], 24, seed=(seed, start)))
    short = next(ours.batches(5))
    i = lens.index(10)
    assert short["prompt"].shape == (5, 24, 8)
    np.testing.assert_array_equal(short["prompt"][i], short["codes"][i, :24])
    for j, n in enumerate(lens):   # inside the true span
        p = short["prompt"][j]
        starts = [s for s in range(48 - 24 + 1)
                  if np.array_equal(short["codes"][j, s:s + 24], p)]
        assert starts and min(starts) <= max(n - 24, 0)
    plain = CodeDataset(str(tmp_path / "codes.tar"), max_seq_length=32)
    assert "prompt" not in next(plain.batches(2))


@pytest.mark.parametrize("frames", [48, 16])
def test_synthetic_dataset_prompt_crops_are_jax_bits(frames):
    """Also utterances shorter than the crop: zero-padded (frames 16)."""
    kw = dict(n=8, frames=frames, max_seq_length=32, seed=1,
              prompt_frames=24)
    for seed in (0, 5):
        assert _same_batches(
            SyntheticDataset(**kw).batches(4, shuffle=True, seed=seed),
            JaxSynthetic(**kw).batches(4, shuffle=True, seed=seed)) == 2
    b = next(SyntheticDataset(**kw).batches(4))
    assert b["prompt"].shape == (4, 24, 8)
    n = min(frames, 24)
    np.testing.assert_array_equal(b["prompt"][:, n:], 0)
    if frames < 24:
        np.testing.assert_array_equal(b["prompt"][:, :n], b["codes"])


# --- one train step against JAX -----------------------------------------


def _batch(rng):
    S, T = CFG.cmu_seq_len, CFG.sample_size
    ids = rng.integers(1, 149, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 12:] = 0
    ids[1, 12:] = 0
    codes = rng.integers(0, 1024, (B, 8, T))
    lat = (codes.astype(np.float32) * (2 / 1023) - 1).transpose(0, 2, 1)
    lat = np.ascontiguousarray(lat)
    return {"codes": lat, "text_ids": ids, "text_mask": mask,
            "prompt": np.ascontiguousarray(lat[:, 5:5 + CFG.prompt_frames])}


def _jax_draws(key, codes, prob):
    """noise, timesteps and the condition drop as the JAX loss derives
    them from its key."""
    rng_noise, rng_t, _, rng_cfg = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes.shape, codes.dtype)
    t = jax.random.randint(rng_t, (codes.shape[0],), 0, 1000,
                           dtype=jnp.int32)
    drop = jax.random.bernoulli(rng_cfg, prob, (codes.shape[0], 1))
    return {"noise": torch.from_numpy(np.array(noise)),
            "timesteps": torch.from_numpy(np.array(t)),
            "drop": torch.from_numpy(np.array(drop))}


@pytest.fixture(scope="module")
def ref():
    """JAX params, a batch with a prompt, a key whose drop nulls row 0 and
    keeps row 1, and JAX ``make_train_step`` there: the loss, the
    gradients, the gradient norm and the updated parameters."""
    rng = np.random.default_rng(0)
    model = JaxPrompt(JCFG)
    batch = _batch(rng)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.asarray(batch["codes"]),
        jnp.zeros((B,), jnp.int32), jnp.asarray(batch["text_ids"]),
        jnp.asarray(batch["text_mask"]), jnp.asarray(batch["prompt"]))
    params = _fill(shapes, rng)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if _jax_draws(k, batch["codes"], 0.5)["drop"].ravel()
               .tolist() == [True, False])
    tcfg = JaxTrainConfig(**TRAIN)
    step = jax.jit(jax_make_train_step(model.apply, jax_schedule(),
                                       cond_dropout_prob=0.5))
    new_state, metrics = step(create_train_state(model, params, tcfg, 10),
                              batch, key)
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    # the first moment after one update is (1 - b1) times the clipped
    # gradient; clip_by_global_norm scaled it by max_norm / norm
    unclip = norm / tcfg.max_grad_norm if norm >= tcfg.max_grad_norm else 1.0
    mu = _find_adam(jax.tree.map(np.asarray, new_state.opt_state)).mu
    grads = jax.tree.map(lambda m: m / (1 - tcfg.adam_b1) * unclip, mu)
    return dict(model=model, params=params, batch=batch, key=key,
                loss=loss, grad_norm=norm, grads=grads,
                new_params=jax.tree.map(np.asarray, new_state.params))


def _port_state(params):
    model = TTSPromptSpeaker(CFG)
    model.load_state_dict(model_state_from_jax(params), strict=True)
    return TrainState(model, TrainConfig(**TRAIN), num_training_steps=10)


def test_one_train_step_matches_jax(ref):
    """Loss, every gradient (the prompt encoder's too) and the updated
    parameters of one step with the joint text + prompt drop."""
    batch = ref["batch"]
    inputs = _jax_draws(ref["key"], batch["codes"], 0.5)
    state = _port_state(ref["params"])
    old = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    loss_fn = make_loss_fn(state.model, linear_schedule(), 0.5)
    state.model.train()
    loss = loss_fn(_t(batch), **inputs)
    loss.backward()
    assert abs(loss.item() - ref["loss"]) <= LOSS_TOL
    jgrads = model_state_from_jax(ref["grads"])
    jnorm = ref["grad_norm"]
    assert jnorm > TRAIN["learning_rate"]   # clipping is exercised
    assert abs(float(optax_global_norm(ref["grads"])) - jnorm) <= 1e-6 * jnorm
    zero = {n for n, g in jgrads.items()
            if np.linalg.norm(g.numpy()) <= ZERO_GRAD * jnorm}
    assert len(zero) < len(jgrads) // 4
    prompt_names = [n for n in jgrads if n.startswith("prompt_encoder.")]
    assert len(prompt_names) > 20 and not zero & set(prompt_names)
    for n, p in state.model.named_parameters():
        if n in zero:
            assert float(p.grad.norm()) <= ZERO_GRAD * jnorm, n
        else:
            assert _rel(p.grad.numpy(), jgrads[n].numpy()) <= GRAD_RTOL, n
    state.optimizer.zero_grad(set_to_none=True)

    m = make_train_step(state, linear_schedule(), 0.5)(_t(batch), **inputs)
    assert abs(float(m["loss"]) - ref["loss"]) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) - jnorm) <= GRAD_RTOL * jnorm
    new_j = model_state_from_jax(ref["new_params"])
    for n, p in state.model.named_parameters():
        got, want = p.detach().numpy(), new_j[n].numpy()
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=n)
        if n not in zero:
            assert _rel(got - old[n].numpy(), want - old[n].numpy()) \
                <= UPDATE_RTOL, n


def test_joint_drop_nulls_text_and_prompt(ref):
    """A dropped row sees zero ids, an all-zero mask and zero prompt
    latents; a kept row sees its own."""
    state = _port_state(ref["params"])
    batch = _t(ref["batch"])
    inputs = _jax_draws(ref["key"], ref["batch"]["codes"], 0.5)
    keep = torch.tensor([0, 1], dtype=torch.int32)
    nulled = dict(batch, text_ids=batch["text_ids"] * keep[:, None],
                  text_mask=batch["text_mask"] * keep[:, None],
                  prompt=batch["prompt"] * keep[:, None, None])
    sched = linear_schedule()
    with torch.no_grad():
        got = make_loss_fn(state.model, sched, 0.5)(batch, **inputs)
        inputs.pop("drop")
        want = make_loss_fn(state.model, sched)(nulled, **inputs)
        whole = make_loss_fn(state.model, sched)(batch, **inputs)
    assert torch.equal(got, want) and not torch.equal(got, whole)


def test_eval_steps_with_the_prompt_match_jax(ref):
    model, batch, key = ref["model"], ref["batch"], jax.random.PRNGKey(5)
    sched = jax_schedule()

    @jax.jit
    def evals(params):
        return (jax_make_eval_step(model.apply, sched)(params, batch, key),
                jax_make_eval_step_at(model.apply, sched)(params, batch,
                                                          key, 300))

    want, want_at = map(float, evals(ref["params"]))
    rng_noise, rng_t = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        rng_noise, batch["codes"].shape)))
    t = torch.from_numpy(np.asarray(jax.random.randint(
        rng_t, (B,), 0, 1000, dtype=jnp.int32)))
    noise_at = torch.from_numpy(np.asarray(jax.random.normal(
        key, batch["codes"].shape)))
    port = _port_state(ref["params"]).model
    port_sched = linear_schedule()
    got = float(make_eval_step(port, port_sched)(_t(batch), noise=noise,
                                                 timesteps=t))
    got_at = float(make_eval_step_at(port, port_sched)(_t(batch), None, 300,
                                                       noise=noise_at))
    assert abs(got - want) <= LOSS_TOL
    assert abs(got_at - want_at) <= LOSS_TOL


# --- the Trainer and the CLI --------------------------------------------

SMOKE = Config(
    model=dataclasses.replace(CFG, text_encoder_dropout=0.1),
    train=TrainConfig(batch_size=8, num_train_epochs=2, learning_rate=1e-3,
                      lr_warmup_steps=0, ema_decay=0.5,
                      cond_dropout_prob=0.3))


def _losses(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}


def test_trainer_prompt_family_checkpoint_and_resume(tmp_path):
    """4 steps in one go against 2 steps, a checkpoint, a new Trainer
    restored from it and 2 more: the same losses, parameters and EMA
    (dropout and the condition drop on; the generators are checkpointed)."""
    ds = SyntheticDataset(n=16, frames=48, max_seq_length=32,
                          prompt_frames=CFG.prompt_frames)
    torch.manual_seed(0)
    whole = Trainer(SMOKE, ds, log_dir=str(tmp_path / "a"), device="cpu")
    assert isinstance(whole.model, TTSPromptSpeaker)
    batch = whole._to_device(next(ds.batches(8)))
    assert batch["prompt"].shape == (8, CFG.prompt_frames, 8)
    whole.train()
    torch.manual_seed(0)
    first = Trainer(SMOKE, ds, log_dir=str(tmp_path / "b"),
                    ckpt_dir=str(tmp_path / "ck"), device="cpu")
    first.train(epochs=1)
    assert first.ckpt.all_steps() == [2]
    second = Trainer(SMOKE, ds, log_dir=str(tmp_path / "c"),
                     ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert second.restore_latest() == 2
    second.train()
    want, got = _losses(tmp_path / "a"), _losses(tmp_path / "c")
    assert sorted(got) == [3, 4] and len(want) == 4
    assert all(np.isfinite(v) for v in want.values())
    assert [got[s] for s in (3, 4)] == [want[s] for s in (3, 4)]
    for p, q in zip(second.model.parameters(), whole.model.parameters()):
        assert torch.equal(p, q)
    assert all(torch.equal(a, b) for a, b in zip(second.state.ema,
                                                 whole.state.ema))
    assert second.evaluate() == whole.evaluate()


def test_trainer_prompt_family_needs_prompt_crops(tmp_path):
    ds = SyntheticDataset(n=8, frames=48, max_seq_length=32)
    with pytest.raises(ValueError, match="prompt_frames"):
        Trainer(SMOKE, ds, log_dir=str(tmp_path), device="cpu")


def test_cli_train_smoke_prompt_config_on_cpu(tmp_path):
    """``--smoke --config_file`` with a prompt config: the synthetic
    dataset makes prompt crops, bf16 keeps f32 parameters."""
    from prompt_tts_tpu_torch.cli.train import main
    cfg = tmp_path / "prompt.json"
    SMOKE.to_json(str(cfg))
    trainer = main(["--smoke", "--config_file", str(cfg), "--device", "cpu",
                    "--bf16", "--epochs", "1", "--log_dir",
                    str(tmp_path / "log"), "--ckpt_dir",
                    str(tmp_path / "ck")])
    assert isinstance(trainer.model, TTSPromptSpeaker)
    assert trainer.dataset.prompt_frames == CFG.prompt_frames
    assert trainer.global_step == 2
    losses = _losses(tmp_path / "log")
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert trainer.ckpt.latest_step() == 2
