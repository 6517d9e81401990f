"""Data parallelism: the port's trainer over two gloo ranks on the CPU.

The port of ``tests/test_multihost.py`` for ``prompt_tts_tpu_torch``.  Two
worker processes join a process group (from the ``PTTS_*`` variables, as
the JAX package reads them; the CLI pair from torchrun's) and run the
tiny configs of ``test_torch_train.py`` / ``test_torch_prompt.py`` under
``DistributedDataParallel``; this process holds their results to the
port's one-process trainer on the global batch and to the JAX package's
step on a 2-device mesh.  The JAX side's draws (noise, timesteps, the
condition drop, derived from its key as ``prompt_tts_tpu/train/step.py``
derives them) are passed to the port's ranks for the global batch, and
each rank keeps its rows.

Tolerances: 2 ranks against one process, the same arithmetic on the same
rows in another order: loss 1e-6, and the gradient's relative gap
(‖g₂ − g₁‖ / ‖g₁‖ over every parameter) 1e-6.  Against JAX: loss 1e-5
(f32 both sides, the models' outputs agree to 5e-4 and the squares'
mean averages the gaps), parameters after the update as
``test_torch_train.py`` holds them (``PARAM_ATOL``; the update of each
tensor whose gradient is not rounding noise to ``UPDATE_RTOL``).
"""

import json
import os
import random
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.config import TrainConfig as JaxTrainConfig
from prompt_tts_tpu.data import SyntheticDataset as JaxSynthetic
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxSingle
from prompt_tts_tpu.parallel.mesh import make_mesh
from prompt_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from prompt_tts_tpu.train import (
    create_train_state, jit_train_step, make_train_step,
)
from prompt_tts_tpu.train.step import make_loss_fn as jax_make_loss_fn
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.loop import Trainer

RANKS_LOSS_TOL = 1e-6
RANKS_GRAD_RTOL = 1e-6
JAX_LOSS_TOL = 1e-5
PARAM_ATOL = 2e-3
UPDATE_RTOL = 1e-2
ZERO_GRAD = 1e-6

# two UNet levels, one with cross-attention, and the mid block's: the
# smallest config with every kind of block (half the JAX compile of four)
WIDTHS = dict(block_out_channels=(32, 64), cross_attention_dim=64,
              down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
              up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
              sample_size=48, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0)
PROMPT = dict(WIDTHS, prompt_conditioning=True, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
             weight_decay=0.1, batch_size=4, num_train_epochs=1)
B, CFG_DROP = 4, 0.1
DATA = dict(n=4, frames=48, max_seq_length=32)

# the ranks' program; its arguments come in ``spec.pt``, its results go to
# ``rank<r>.pt``.  It must load no module of JAX.
_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from prompt_tts_tpu_torch import parallel
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.train.loop import Trainer
from prompt_tts_tpu_torch.train.step import drawing_from

out = sys.argv[1]
spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
dev = parallel.init_distributed("cpu")
r = parallel.data_rank()
res = {"rank": r, "size": parallel.data_size()}
x = torch.tensor([r + 1.0])
torch.distributed.all_reduce(x)
res["all_reduce"] = x.item()


def config(model, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**spec["train"], **train}))


def trainer(name, cfg, ds, **kw):
    return Trainer(cfg, ds, log_dir=os.path.join(out, f"{name}{r}"),
                   device=dev, **kw)


def snapshot(tr, into):
    # the gradients apply_gradients receives, after DDP's all-reduce
    apply = tr.state.apply_gradients

    def wrapped():
        into.append(torch.cat([p.grad.flatten() for p in tr.state.params]))
        return apply()
    tr.state.apply_gradients = wrapped


flag = config(spec["flag"])
ds = SyntheticDataset(**spec["data"])
for mode in ("replicated", "per_process"):
    per = mode == "per_process"
    tr = trainer(mode, flag, ds, init_state=spec["flag_state"],
                 per_process_data=per)
    grads = []
    snapshot(tr, grads)
    batch = next(ds.batches(spec["train"]["batch_size"],
                            process_shard=(r, 2) if per else None))
    m = tr.train_step(batch, **spec["flag_inputs"])
    res[mode] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "grad": grads[0], "rows": len(batch["codes"]),
                 "params": tr.model.state_dict()}

pds = SyntheticDataset(**spec["data"],
                       prompt_frames=spec["prompt"]["prompt_frames"])
tr = trainer("prompt",
             config(spec["prompt"], cond_dropout_prob=spec["cfg_drop"]),
             pds, init_state=spec["prompt_state"], per_process_data=True)
batch = next(pds.batches(spec["train"]["batch_size"], process_shard=(r, 2)))
m = tr.train_step(batch, **spec["prompt_inputs"])
res["prompt"] = {"crops": batch["prompt"], "loss": float(m["loss"])}

acc_ds = SyntheticDataset(**dict(spec["data"], n=8))
tr = trainer("acc", config(spec["flag"], gradient_accumulation_steps=2),
             acc_ds, init_state=spec["flag_state"])
grads, losses = [], []
snapshot(tr, grads)
for batch in acc_ds.batches(spec["train"]["batch_size"]):
    losses.append(float(tr.train_step(batch)["loss"]))
res["accumulation"] = {"losses": losses, "grads": grads,
                       "update_count": tr.state.update_count}

with drawing_from(tr.dropout_generator, tr.device):
    res["dropout_mask"] = torch.nn.functional.dropout(
        torch.ones(4096), 0.1, training=True) != 0

res["evaluate"] = {
    m: trainer("eval", flag, acc_ds, per_process_data=m == "per_process"
               ).evaluate() for m in ("replicated", "per_process")}

# a run with the text encoder's dropout and an EMA, whole and broken at a
# checkpoint; only rank 0 may write a file
if r != 0:
    from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager

    def refuse(*a, **k):
        raise AssertionError("rank 1 wrote a checkpoint")
    CheckpointManager._write = refuse
drop = config(dict(spec["flag"], text_encoder_dropout=0.1),
              num_train_epochs=2, ema_decay=0.5)
ck = os.path.join(out, "ck")
trainer("whole", drop, acc_ds).train()
trainer("first", drop, acc_ds, ckpt_dir=ck).train(epochs=1)
second = trainer("second", drop, acc_ds, ckpt_dir=ck)
res["restored_step"] = second.restore_latest()
second.train()
res["jax_free"] = sorted({m.split(".")[0] for m in sys.modules} & {
    "jax", "flax", "optax", "prompt_tts_tpu"})
parallel.barrier()
torch.distributed.destroy_process_group()
torch.save(res, os.path.join(out, f"rank{r}.pt"))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    """A port that binds now, drawn below Linux's ephemeral range (32768
    up): a port the kernel hands out (``bind`` to 0) can be taken by an
    outgoing connection of another rank before its server binds it."""
    while True:
        port = random.SystemRandom().randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _start_pair(argv, out, torchrun: bool):
    """Two ranks of ``argv``, rendezvous from the ``PTTS_*`` variables or
    torchrun's; returns the processes."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": (os.environ.get("PYTHONPATH", "") + ":" + repo)
           .lstrip(":")}
    procs = []
    for r in range(2):
        if torchrun:
            rank_env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "RANK": str(r), "LOCAL_RANK": str(r),
                        "WORLD_SIZE": "2"}
        else:
            rank_env = {"PTTS_COORDINATOR": f"127.0.0.1:{port}",
                        "PTTS_NUM_PROCESSES": "2",
                        "PTTS_PROCESS_ID": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env={**env, **rank_env}, cwd=out,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} failed:\n{text[-3000:]}"
              for r, (p, text) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return outs


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


def _jax_params(model, batch, rng):
    args = [jnp.asarray(batch["codes"]), jnp.zeros((B,), jnp.int32),
            jnp.asarray(batch["text_ids"]), jnp.asarray(batch["text_mask"])]
    if "prompt" in batch:
        args.append(jnp.asarray(batch["prompt"]))
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args),
                 rng)


def _draws(key, codes):
    """The noise, timesteps and condition drop JAX's loss derives from
    ``key`` for the global batch ``codes``, as torch tensors."""
    rng_noise, rng_t, _, rng_cfg = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes.shape, codes.dtype)
    t = jax.random.randint(rng_t, (codes.shape[0],), 0, 1000,
                           dtype=jnp.int32)
    drop = jax.random.bernoulli(rng_cfg, CFG_DROP, (codes.shape[0], 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("noise", noise), ("timesteps", t), ("drop", drop))}


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _grad_snapshot(tr, into):
    apply = tr.state.apply_gradients

    def wrapped():
        into.append(torch.cat([p.grad.flatten() for p in tr.state.params]))
        return apply()
    tr.state.apply_gradients = wrapped


def _config(model, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**TRAIN, **train}))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start both pairs, compute the references meanwhile, and return the
    ranks' results beside them."""
    out = tmp_path_factory.mktemp("ranks")
    cli_out = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    ds = JaxSynthetic(**DATA)
    batch = next(ds.batches(B))
    pds = JaxSynthetic(**DATA, prompt_frames=PROMPT["prompt_frames"])
    shards = [next(pds.batches(B, process_shard=(r, 2))) for r in (0, 1)]
    pbatch = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    flag_model, prompt_model = (JaxSingle(JaxModelConfig(**WIDTHS)),
                                JaxPrompt(JaxModelConfig(**PROMPT)))
    flag_params = _jax_params(flag_model, batch, rng)
    prompt_params = _jax_params(prompt_model, pbatch, rng)
    key, pkey = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    flag_inputs = _draws(key, batch["codes"])
    del flag_inputs["drop"]
    spec = dict(flag=WIDTHS, prompt=PROMPT, train=TRAIN, data=DATA,
                cfg_drop=CFG_DROP,
                flag_state=model_state_from_jax(flag_params),
                prompt_state=model_state_from_jax(prompt_params),
                flag_inputs=flag_inputs,
                prompt_inputs=_draws(pkey, pbatch["codes"]))
    torch.save(spec, out / "spec.pt")
    (out / "worker.py").write_text(_WORKER)
    ranks = _start_pair([str(out / "worker.py"), str(out)], out, False)
    cli = _start_pair(
        ["-m", "prompt_tts_tpu_torch.cli.train", "--smoke", "--multihost",
         "--per_process_data", "--device", "cpu", "--log_dir",
         str(cli_out / "log"), "--ckpt_dir", str(cli_out / "ck")],
        cli_out, True)
    try:
        ref = {"spec": spec, "cli_out": cli_out, "out": out}
        # JAX: the flagship's step on a 2-device mesh, the prompt family's
        # loss on the ranks' rows there
        # (the two compiles overlap: XLA releases the interpreter lock)
        mesh = make_mesh(devices=jax.devices()[:2])
        loss_fn = jax.jit(jax_make_loss_fn(prompt_model.apply,
                                           jax_schedule(),
                                           cond_dropout_prob=CFG_DROP))
        with ThreadPoolExecutor(1) as pool:
            prompt_loss = pool.submit(lambda: float(loss_fn(
                prompt_params, jax_shard_batch(pbatch, mesh), pkey)))
            state = create_train_state(flag_model, flag_params,
                                       JaxTrainConfig(**TRAIN), 10)
            step = jit_train_step(make_train_step(flag_model.apply,
                                                  jax_schedule()), mesh)
            new, m = step(state, jax_shard_batch(batch, mesh), key)
            ref["jax_loss"] = float(m["loss"])
            ref["jax_prompt_loss"] = prompt_loss.result()
        ref["jax_params"] = model_state_from_jax(
            jax.tree.map(np.asarray, new.params))
        ref["jax_crops"] = [s["prompt"] for s in shards]
        # the port in one process on the global batch
        port_ds = SyntheticDataset(**DATA)
        tr = Trainer(_config(WIDTHS), port_ds, log_dir=str(out / "one"),
                     device="cpu", init_state=spec["flag_state"])
        grads = []
        _grad_snapshot(tr, grads)
        m = tr.train_step(next(port_ds.batches(B)), **flag_inputs)
        ref["one"] = {"loss": float(m["loss"]), "grad": grads[0],
                      "grad_norm": float(m["grad_norm"])}
        acc_ds = SyntheticDataset(**dict(DATA, n=8))
        tr = Trainer(_config(WIDTHS, gradient_accumulation_steps=2), acc_ds,
                     log_dir=str(out / "one_acc"), device="cpu",
                     init_state=spec["flag_state"])
        grads = []
        _grad_snapshot(tr, grads)
        ref["one_acc"] = {"losses": [float(tr.train_step(b)["loss"])
                                     for b in acc_ds.batches(B)],
                          "grads": grads}
        ref["one_eval"] = Trainer(_config(WIDTHS), acc_ds,
                                  log_dir=str(out / "one_eval"),
                                  device="cpu").evaluate()
        _finish(ranks)
        ref["ranks"] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                        for r in range(2)]
        _finish(cli)
    finally:
        for p in ranks + cli:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ref


def test_ranks_start_from_the_ptts_variables(run):
    """Both ranks joined one group of 2 from ``PTTS_*``, and an
    all-reduce crossed them."""
    for r, res in enumerate(run["ranks"]):
        assert (res["rank"], res["size"], res["all_reduce"]) == (r, 2, 3.0)


def test_ranks_load_no_jax(run):
    """The ranks imported ``parallel`` and ``train.loop`` and trained, and
    no module of jax, flax, optax or the JAX package was loaded."""
    for res in run["ranks"]:
        assert res["jax_free"] == [], res["jax_free"]


def test_only_rank_0_writes_metrics_and_checkpoints(run):
    out = run["out"]
    for name in ("replicated", "whole", "first", "second", "eval"):
        assert (out / f"{name}0" / "metrics.jsonl").exists(), name
        assert not (out / f"{name}1" / "metrics.jsonl").exists(), name
    # rank 1's checkpoint writer raised if called; the checkpoints are whole
    assert CheckpointManager(str(out / "ck")).all_steps() == [2, 4]


@pytest.mark.parametrize("mode", ["replicated", "per_process"])
def test_two_rank_step_is_the_one_process_step(run, mode):
    """The flagship's step over 2 ranks, each holding 2 of 4 rows: the
    losses agree across ranks and with one process on the 4 rows (1e-6),
    and so does the all-reduced gradient (relative gap 1e-6)."""
    a, b = (res[mode] for res in run["ranks"])
    assert a["rows"] == b["rows"] == (B if mode == "replicated" else B // 2)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert torch.equal(a["grad"], b["grad"])
    one = run["one"]
    assert abs(a["loss"] - one["loss"]) <= RANKS_LOSS_TOL
    assert abs(a["grad_norm"] - one["grad_norm"]) <= \
        RANKS_GRAD_RTOL * one["grad_norm"]
    assert _rel(a["grad"], one["grad"]) <= RANKS_GRAD_RTOL
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


def test_per_process_data_gives_the_replicated_step(run):
    for res in run["ranks"]:
        a, b = res["replicated"], res["per_process"]
        assert abs(a["loss"] - b["loss"]) <= RANKS_LOSS_TOL
        assert _rel(b["grad"], a["grad"]) <= RANKS_GRAD_RTOL


@pytest.mark.parametrize("mode", ["replicated", "per_process"])
def test_two_rank_step_is_jax_mesh_step(run, mode):
    """Against JAX's step on a 2-device mesh with its draws injected: the
    loss to 1e-5, the parameters after the update as
    ``test_torch_train.py`` holds them."""
    res = run["ranks"][0][mode]
    assert abs(res["loss"] - run["jax_loss"]) <= JAX_LOSS_TOL
    state = run["spec"]["flag_state"]
    one = run["one"]["grad"]
    gnorm = float(torch.linalg.vector_norm(one))
    names = [n for n, _ in TTSSingleSpeaker(
        ModelConfig(**WIDTHS), device="meta").named_parameters()]
    grads = torch.split(one, [state[n].numel() for n in names])
    zero = {n for n, g in zip(names, grads)
            if float(torch.linalg.vector_norm(g)) <= ZERO_GRAD * gnorm}
    assert 0 < len(zero) < len(names) // 4
    for k, old in state.items():
        got, want = res["params"][k], run["jax_params"][k]
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        if k not in zero:
            assert _rel(got - old, want - old) <= UPDATE_RTOL, k


def test_prompt_family_per_process_is_jax(run):
    """Under ``per_process_data`` each rank's prompt crops are JAX's
    ``(seed, start, rank)`` crops, and the 2-rank loss is JAX's 2-device
    loss on those rows, condition drop included (1e-5)."""
    for r, res in enumerate(run["ranks"]):
        np.testing.assert_array_equal(res["prompt"]["crops"],
                                      run["jax_crops"][r])
    a, b = (res["prompt"]["loss"] for res in run["ranks"])
    assert a == b
    assert abs(a - run["jax_prompt_loss"]) <= JAX_LOSS_TOL


def test_accumulation_over_ranks_is_one_process(run):
    """``gradient_accumulation_steps=2``: every micro-step's gradient is
    all-reduced before it is folded into the mean, so the two micro-steps'
    losses and gradients equal one process's (1e-6), and one update ran."""
    one = run["one_acc"]
    for res in run["ranks"]:
        acc = res["accumulation"]
        assert acc["update_count"] == 1
        for got, want in zip(acc["losses"], one["losses"]):
            assert abs(got - want) <= RANKS_LOSS_TOL
        assert len(acc["grads"]) == len(one["grads"]) == 2
        for got, want in zip(acc["grads"], one["grads"]):
            assert _rel(got, want) <= RANKS_GRAD_RTOL


def test_ranks_draw_different_dropout_masks(run):
    a, b = (res["dropout_mask"] for res in run["ranks"])
    assert not torch.equal(a, b)
    assert 0.85 < float(a.float().mean()) < 0.95


def test_resume_on_two_ranks_is_bit_equal(run):
    """Broken at step 2 and resumed (each rank's dropout stream restored),
    the run logs the unbroken run's losses bit for bit."""
    out = run["out"]
    assert all(res["restored_step"] == 2 for res in run["ranks"])
    whole, second = _losses(out / "whole0"), _losses(out / "second0")
    assert sorted(whole) == [1, 2, 3, 4] and sorted(second) == [3, 4]
    assert all(np.isfinite(v) for v in whole.values())
    assert second[4] == whole[4] and second[3] == whole[3]


def test_two_rank_checkpoint_loads_in_one_process(run):
    ckpt = CheckpointManager(str(run["out"] / "ck"))
    sd, step = ckpt.read_model_state()
    assert step == 4
    model = TTSSingleSpeaker(ModelConfig(**WIDTHS))
    model.load_state_dict(sd, strict=True)
    ema, _ = ckpt.read_model_state(ema=True)
    assert any(not torch.equal(ema[k], sd[k]) for k in sd)
    cfg = _config(dict(WIDTHS, text_encoder_dropout=0.1),
                  num_train_epochs=2, ema_decay=0.5)
    tr = Trainer(cfg, SyntheticDataset(**dict(DATA, n=8)),
                 log_dir=str(run["out"] / "one_resume"),
                 ckpt_dir=str(run["out"] / "ck"), device="cpu")
    assert tr.restore_latest() == 4
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("mode", ["replicated", "per_process"])
def test_evaluate_over_ranks_is_one_process(run, mode):
    for res in run["ranks"]:
        assert abs(res["evaluate"][mode] - run["one_eval"]) <= \
            RANKS_LOSS_TOL


def test_cli_train_multihost_per_process_data(run):
    """``cli.train --smoke --multihost --per_process_data --device cpu``,
    two ranks from torchrun's variables: both exit 0; rank 0 logged
    finite losses and wrote the checkpoint."""
    losses = _losses(run["cli_out"] / "log")
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert CheckpointManager(str(run["cli_out"] / "ck")).latest_step() == 2
