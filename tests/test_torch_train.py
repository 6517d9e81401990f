"""The training slice: the PyTorch port against the JAX package, in f32.

Tiny config, dropout 0, the same parameters (a JAX param tree filled from
a numpy seed, loaded with ``model_state_from_jax``), the same batch, and
the same noise and timesteps (derived here from the JAX key exactly as
``prompt_tts_tpu/train/step.py:73-77`` derives them, and passed to the
port's loss).  The JAX side is ``jax.value_and_grad(make_loss_fn(...))``
and the optax chain of ``make_optimizer``; the port's side is its train
step, ``TrainState`` and AdamW.  Then the schedules, accumulation with EMA,
eval steps, dropout modes, the ``Trainer``'s resume and the train CLI.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.config import TrainConfig as JaxTrainConfig
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.train.lr import get_schedule as jax_get_schedule
from prompt_tts_tpu.train.state import make_optimizer as jax_make_optimizer
from prompt_tts_tpu.train.step import make_eval_step as jax_make_eval_step
from prompt_tts_tpu.train.step import make_loss_fn as jax_make_loss_fn
from prompt_tts_tpu.train.step import optax_global_norm
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import (
    _find_adam, model_state_from_jax, opt_state_from_jax,
)
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.lr import get_schedule
from prompt_tts_tpu_torch.train.loop import Trainer
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.train.step import (
    make_eval_step, make_eval_step_at, make_loss_fn, make_train_step,
)

# loss: the mean of (pred - noise)^2 over outputs that agree to the
# model-level 5e-4 contract; f32 both sides.
LOSS_TOL = 1e-4
# gradients: f32 backward through the same model, summation order differs;
# relative L2 per parameter tensor, and the global norm.
GRAD_RTOL = 1e-4
# moments after one update: mu = (1-b1) g and nu = (1-b2) g^2, so they
# carry the gradients' relative error (twice for nu).
MOMENT_RTOL = 2e-4
# parameters after one AdamW update at lr 1e-3: the first Adam step is
# ~lr * sign(g), so an entry whose gradient is within rounding of 0 may
# move by up to lr either way; the whole update must agree in relative L2.
PARAM_ATOL = 2e-3
UPDATE_RTOL = 1e-2
# a gradient that is zero in exact arithmetic (the bias of a conv or of the
# time projection right in front of a GroupNorm, which removes any
# per-channel constant) is rounding noise, ~1e-8 on both sides: such a
# tensor is held to this bound, relative to the global norm, instead of a
# relative error; Adam's update of it is noise too, so only PARAM_ATOL
# holds its parameters.
ZERO_GRAD = 1e-6

CFG = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
           attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
           sample_size=48, layers_per_block=1, unet_num_heads=4,
           text_encoder_dropout=0.0)
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
             weight_decay=0.1, batch_size=2)
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
        return 0.1 * x if name == "bias" else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(rng):
    S, T = CFG["cmu_seq_len"], CFG["sample_size"]
    ids = rng.integers(1, 149, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, 20:] = 0
    ids[0, 20:] = 0
    codes = rng.integers(0, 1024, (B, 8, T))
    codes = (codes.astype(np.float32) * (2 / 1023) - 1).transpose(0, 2, 1)
    return {"codes": np.ascontiguousarray(codes), "text_ids": ids,
            "text_mask": mask}


def _inputs(key, codes):
    """noise and timesteps as the JAX loss derives them from its key."""
    rng_noise, rng_t, _, _ = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes.shape, codes.dtype)
    t = jax.random.randint(rng_t, (codes.shape[0],), 0, 1000,
                           dtype=jnp.int32)
    return {"noise": torch.from_numpy(np.array(noise)),
            "timesteps": torch.from_numpy(np.array(t))}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _zero_grads(grads, gnorm):
    """Names of the tensors whose gradient is rounding noise."""
    return {n for n, g in grads.items()
            if np.linalg.norm(g.numpy()) <= ZERO_GRAD * gnorm}


@pytest.fixture(scope="module")
def ref():
    """JAX params, two batches with keys, and their loss and grads from one
    jitted value_and_grad."""
    rng = np.random.default_rng(0)
    cfg = JaxModelConfig(**CFG)
    model = JaxTTS(cfg)
    batches = [_batch(rng), _batch(rng)]
    b0 = batches[0]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(b0["codes"]),
                            jnp.zeros((B,), jnp.int32),
                            jnp.asarray(b0["text_ids"]),
                            jnp.asarray(b0["text_mask"]))
    params = _fill(shapes, rng)
    vg = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(model.apply, jax_schedule())))
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    out = [vg(params, b, k) for b, k in zip(batches, keys)]
    return dict(model=model, params=params, batches=batches, keys=keys,
                losses=[float(l) for l, _ in out],
                grads=[jax.tree.map(np.asarray, g) for _, g in out])


def _port_state(params, **train):
    model = TTSSingleSpeaker(ModelConfig(**CFG))
    model.load_state_dict(model_state_from_jax(params), strict=True)
    return TrainState(model, TrainConfig(**{**TRAIN, **train}),
                      num_training_steps=10)


_UPDATES = {}


def _jax_update(params, grads_list, opt_state=None, **train):
    """The optax chain of ``make_optimizer`` over ``grads_list``, from
    ``opt_state`` or a fresh state.  One jitted update per configuration,
    reused (eager optax over the tree's leaves is slow)."""
    key = tuple(sorted(train.items()))
    if key not in _UPDATES:
        tx = jax_make_optimizer(JaxTrainConfig(**{**TRAIN, **train}), 10)

        @jax.jit
        def update(params, g, opt_state):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state
        _UPDATES[key] = tx, update
    tx, update = _UPDATES[key]
    if opt_state is None:
        opt_state = tx.init(params)
    for g in grads_list:
        params, opt_state = update(params, g, opt_state)
    return params, opt_state


@pytest.fixture(scope="module")
def one_update(ref):
    """JAX params and optax state after one update on the first batch."""
    return _jax_update(ref["params"], [ref["grads"][0]])


def test_one_train_step_matches_jax(ref, one_update):
    state = _port_state(ref["params"])
    step = make_train_step(state, linear_schedule())
    old = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batch = ref["batches"][0]
    loss_fn = make_loss_fn(state.model, linear_schedule())
    inputs = _inputs(ref["keys"][0], batch["codes"])
    # the loss and every gradient before the update
    state.model.train()
    loss = loss_fn(_t(batch), **inputs)
    loss.backward()
    assert abs(loss.item() - ref["losses"][0]) <= LOSS_TOL
    jgrads = model_state_from_jax(ref["grads"][0])
    jnorm = float(optax_global_norm(ref["grads"][0]))
    zero = _zero_grads(jgrads, jnorm)
    assert len(zero) < len(jgrads) // 4
    worst = max(_rel(p.grad.numpy(), jgrads[n].numpy())
                for n, p in state.model.named_parameters() if n not in zero)
    assert worst <= GRAD_RTOL, worst
    for n, p in state.model.named_parameters():
        if n in zero:
            assert float(p.grad.norm()) <= ZERO_GRAD * jnorm, n
    state.optimizer.zero_grad(set_to_none=True)

    m = step(_t(batch), **inputs)
    assert jnorm > TRAIN["learning_rate"]   # clipping is exercised
    assert abs(float(m["loss"]) - ref["losses"][0]) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) - jnorm) <= GRAD_RTOL * jnorm

    new_j, opt_j = one_update
    new_j = model_state_from_jax(new_j)
    adam = _find_adam(opt_j)
    mu, nu = model_state_from_jax(adam.mu), model_state_from_jax(adam.nu)
    assert state.update_count == int(adam.count) == 1
    for n, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        got, want = p.detach().numpy(), new_j[n].numpy()
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=n)
        if n in zero:
            continue
        assert _rel(st["exp_avg"].numpy(), mu[n].numpy()) <= MOMENT_RTOL, n
        assert _rel(st["exp_avg_sq"].numpy(), nu[n].numpy()) <= \
            2 * MOMENT_RTOL, n
        assert _rel(got - old[n].numpy(), want - old[n].numpy()) \
            <= UPDATE_RTOL, n


def test_accumulation_and_ema_match_multisteps(ref):
    """Two micro-steps of ``gradient_accumulation_steps=2``: the first
    moves nothing, the second applies clip+AdamW to the mean gradient
    (optax.MultiSteps) and moves the EMA (JAX step.py's boundary lerp)."""
    acc = dict(gradient_accumulation_steps=2, ema_decay=0.9)
    state = _port_state(ref["params"], **acc)
    step = make_train_step(state, linear_schedule())
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    norms = []
    for i, batch in enumerate(ref["batches"]):
        m = step(_t(batch), **_inputs(ref["keys"][i], batch["codes"]))
        norms.append(float(m["grad_norm"]))
        assert abs(float(m["loss"]) - ref["losses"][i]) <= LOSS_TOL
        if i == 0:
            assert state.mini_step == 1 and state.update_count == 0
            for n, p in state.model.named_parameters():
                assert torch.equal(p, start[n])
    for g, got in zip(ref["grads"], norms):
        want = float(optax_global_norm(g))
        assert abs(got - want) <= GRAD_RTOL * want
    assert state.mini_step == 0 and state.update_count == 1

    # MultiSteps over the raveled tree: the chain is elementwise but for
    # the global norm, and the tiny model has no time_proj.weight for the
    # decay mask to spare, so the flat vector takes the same update and
    # compiles in a fraction of the time
    flat, unravel = ravel_pytree(ref["params"])
    assert not any("time_proj" in jax.tree_util.keystr(path) for path, _ in
                   jax.tree_util.tree_leaves_with_path(ref["params"]))
    new_j, opt_j = _jax_update(
        flat, [ravel_pytree(g)[0] for g in ref["grads"]], **acc)
    assert int(opt_j.gradient_step) == 1 and int(opt_j.mini_step) == 0
    ema_j = flat * 0.9 + new_j * 0.1
    new_j, ema_j = (model_state_from_jax(unravel(x)) for x in (new_j, ema_j))
    mu = model_state_from_jax(unravel(_find_adam(opt_j).mu))
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *ref["grads"])
    zero = _zero_grads(model_state_from_jax(mean),
                       float(optax_global_norm(mean)))
    for (n, p), e in zip(state.model.named_parameters(), state.ema):
        np.testing.assert_allclose(p.detach().numpy(), new_j[n].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)
        np.testing.assert_allclose(e.numpy(), ema_j[n].numpy(),
                                   atol=0.1 * PARAM_ATOL, rtol=0, err_msg=n)
        if n not in zero:
            assert _rel(state.optimizer.state[p]["exp_avg"].numpy(),
                        mu[n].numpy()) <= MOMENT_RTOL, n


def test_opt_state_from_jax_resumes_the_moments(ref, one_update):
    """A JAX train state's moments and count, carried into the port, give
    the same second update as optax."""
    p1, opt_j = one_update
    state = _port_state(p1)
    opt_state_from_jax(jax.tree.map(np.asarray, opt_j), state)
    assert state.update_count == 1
    g2 = model_state_from_jax(ref["grads"][1])
    for n, p in state.model.named_parameters():
        p.grad = g2[n].clone()
    state.apply_gradients()
    want, _ = _jax_update(p1, [ref["grads"][1]], opt_j)
    want = model_state_from_jax(want)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
@pytest.mark.parametrize("warm", [0, 10])
def test_lr_schedules_match(name, warm):
    kw = dict(learning_rate=3e-4, num_warmup_steps=warm,
              num_training_steps=100)
    ours, theirs = get_schedule(name, **kw), jax_get_schedule(name, **kw)
    for step in (0, 1, warm, 55, 100, 120):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")
    if warm == 0 and name == "constant_with_warmup":
        assert ours(0) == 3e-4   # the first update is not a no-op


def test_eval_steps_match_jax_deterministic(ref):
    """Eval mode turns dropout off: with the text encoder's 0.1 dropout
    the port's eval loss equals JAX's ``deterministic=True`` eval step,
    while train mode draws a fresh mask each call."""
    cfg = {**CFG, "text_encoder_dropout": 0.1}
    jmodel = JaxTTS(JaxModelConfig(**cfg))
    batch, key = ref["batches"][0], jax.random.PRNGKey(5)
    want = float(jax.jit(jax_make_eval_step(jmodel.apply, jax_schedule()))(
        ref["params"], batch, key))
    rng_noise, rng_t = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        rng_noise, batch["codes"].shape)))
    t = torch.from_numpy(np.asarray(jax.random.randint(
        rng_t, (B,), 0, 1000, dtype=jnp.int32)))
    model = TTSSingleSpeaker(ModelConfig(**cfg))
    model.load_state_dict(model_state_from_jax(ref["params"]), strict=True)
    sched = linear_schedule()
    got = float(make_eval_step(model, sched)(_t(batch), noise=noise,
                                             timesteps=t))
    assert abs(got - want) <= LOSS_TOL
    at = make_eval_step_at(model, sched)(_t(batch), None, 500, noise=noise)
    full = make_eval_step(model, sched)(
        _t(batch), noise=noise, timesteps=torch.full((B,), 500))
    assert torch.equal(at, full)

    loss_fn = make_loss_fn(model, sched)
    inputs = dict(noise=noise, timesteps=t)
    model.train()
    with torch.no_grad():
        a, b = (float(loss_fn(_t(batch), **inputs)) for _ in range(2))
    model.eval()
    with torch.no_grad():
        c, d = (float(loss_fn(_t(batch), **inputs)) for _ in range(2))
    assert a != b and a != c and c == d
    assert abs(c - want) <= LOSS_TOL


def test_cond_dropout_nulls_the_text(ref):
    """A dropped sample sees zero ids and an all-zero mask."""
    model = TTSSingleSpeaker(ModelConfig(**CFG))
    model.load_state_dict(model_state_from_jax(ref["params"]), strict=True)
    batch = _t(ref["batches"][0])
    inputs = _inputs(ref["keys"][0], ref["batches"][0]["codes"])
    sched = linear_schedule()
    drop = torch.tensor([[True], [False]])
    with torch.no_grad():
        got = make_loss_fn(model, sched, 0.5)(batch, drop=drop, **inputs)
        nulled = dict(batch, text_ids=batch["text_ids"] * torch.tensor(
            [[0], [1]], dtype=torch.int32), text_mask=batch["text_mask"]
            * torch.tensor([[0], [1]], dtype=torch.int32))
        want = make_loss_fn(model, sched)(nulled, **inputs)
    assert torch.equal(got, want)


SMOKE = Config(
    model=ModelConfig(block_out_channels=(32, 64, 64, 64),
                      cross_attention_dim=64, attention_head_dim=32,
                      text_encoder_layers=1, cmu_seq_len=32, sample_size=48,
                      layers_per_block=1, unet_num_heads=4),
    train=TrainConfig(batch_size=8, num_train_epochs=2, learning_rate=1e-3,
                      lr_warmup_steps=0, ema_decay=0.5))


def _losses(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}


def test_trainer_resume_continues_the_run(tmp_path):
    """Train 4 steps in one go; then 2 steps, a checkpoint, a new Trainer
    restored from it and 2 more: the resumed steps give the same losses
    (dropout on; the generators are part of the checkpoint)."""
    ds = SyntheticDataset(n=16, frames=48, max_seq_length=32)
    torch.manual_seed(0)
    whole = Trainer(SMOKE, ds, log_dir=str(tmp_path / "a"), device="cpu")
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


def test_checkpoints_are_pruned(tmp_path):
    model = TTSSingleSpeaker(SMOKE.model)
    state = TrainState(model, SMOKE.train, 10)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(state, s)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore(state)[0] == 3


def test_cli_train_smoke_on_cpu(tmp_path):
    from prompt_tts_tpu_torch.cli.train import main
    trainer = main(["--smoke", "--device", "cpu", "--log_dir",
                    str(tmp_path / "log"), "--ckpt_dir",
                    str(tmp_path / "ck"), "--ema_decay", "0.99"])
    assert trainer.global_step == 2 and trainer.device.type == "cpu"
    assert trainer.config.train.ema_decay == 0.99
    losses = _losses(tmp_path / "log")
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 2
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_bf16_training_keeps_f32_parameters(tmp_path):
    """``--bf16`` computes in bf16 over f32 parameters and moments."""
    ds = SyntheticDataset(n=8, frames=48, max_seq_length=32)
    cfg = dataclasses.replace(SMOKE, train=dataclasses.replace(
        SMOKE.train, num_train_epochs=1))
    trainer = Trainer(cfg, ds, log_dir=str(tmp_path), device="cpu",
                      dtype=torch.bfloat16)
    loss = trainer.train()
    assert np.isfinite(loss)
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32
        st = trainer.state.optimizer.state[p]
        assert st["exp_avg"].dtype == torch.float32
