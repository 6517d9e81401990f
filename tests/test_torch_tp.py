"""Tensor parallelism: the port's Megatron rules over gloo ranks on the CPU.

The port of ``tests/test_tp.py`` for ``prompt_tts_tpu_torch``.  Worker
processes join process groups (the ``PTTS_*`` variables, as
``tests/test_torch_parallel.py`` starts them) and run ``test_tp.py``'s
``TINY`` widths sharded over a model axis of 2: one world of 2 ranks
(tp2) and one of 4 (dp2 x tp2), each started once for the module; the
CLIs run as three more pairs (torchrun's variables; ``cli.serve --tp 2``
answers over HTTP on localhost).  This process holds
their results to the port in one process and to the JAX package's
unsharded programs (compiling a sharded JAX program costs minutes, and
``test_tp.py`` holds sharded JAX to unsharded JAX).

Tolerances: a sharded step against one process, the same arithmetic with
every row-parallel reduction split in two: loss 1e-6, the gradient's
relative gap (‖g₂ − g₁‖ / ‖g₁‖ over every parameter) 1e-5.  Against JAX's
unsharded step: loss 1e-5, parameters after the update as
``test_torch_parallel.py`` holds them (``PARAM_ATOL``; the update of each
tensor whose gradient is not rounding noise to ``UPDATE_RTOL``).
Synthesis: latents 2e-4 (JAX's own TP tolerance, ``tests/test_tp.py``)
against the port in one process and against JAX ``_denoise_latents``,
and codes agreeing in more than 99 % of places.
"""

import functools
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import Config as JaxConfig
from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.config import TrainConfig as JaxTrainConfig
from prompt_tts_tpu.data import SyntheticDataset as JaxSynthetic
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSPromptSpeaker as JaxPrompt
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxSingle
from prompt_tts_tpu.parallel.mesh import MODEL_AXIS, make_mesh
from prompt_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from prompt_tts_tpu.parallel.tp import tp_shardings_one
from prompt_tts_tpu.pipeline import Synthesizer as JaxSynthesizer
from prompt_tts_tpu.train import (
    create_train_state, jit_train_step, make_train_step,
)
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.parallel.tp import (
    TP_RULES, gather_state, shard_dim, shard_state, shard_train_state,
)
from prompt_tts_tpu_torch.pipeline import Synthesizer, random_init_
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.loop import Trainer

RANKS_LOSS_TOL = 1e-6
RANKS_GRAD_RTOL = 1e-5
JAX_LOSS_TOL = 1e-5
PARAM_ATOL = 2e-3
UPDATE_RTOL = 1e-2
ZERO_GRAD = 1e-6
LATENT_TOL = 2e-4
CODE_AGREE = 0.99
SERVE_ARGV = ["--device", "cpu", "--steps", "2", "--dtype", "f32",
              "--max_batch", "1"]

# tests/test_tp.py's TINY, with the text encoder's dropout off so that the
# parity steps draw nothing
TINY = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
            attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
            sample_size=48, layers_per_block=1, unet_num_heads=4,
            text_encoder_dropout=0.0)
# the prompt family at the same widths (test_torch_parallel.py's prompt
# settings), trained with the condition drop and sampled under guidance
PROMPT = dict(TINY, prompt_conditioning=True, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
CFG_DROP, GUIDANCE = 0.1, 2.0
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
             weight_decay=0.1, batch_size=4, num_train_epochs=1)
B = 4
DATA = dict(n=4, frames=48, max_seq_length=32)
TEXTS = ["hello world", "a test"]
STEPS = 4
# cli.serve --tp 2: one request, then a wave of 4 (text, seed)
SERVE_REQUESTS = [("hello world", 3)] + [(f"wave number {i}", 10 + i)
                                         for i in range(4)]

# the ranks' program; its arguments come in ``spec.pt``, its results go to
# ``rank<r>.pt``.  It must load no module of JAX.
_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from prompt_tts_tpu_torch import aot, parallel
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.pipeline import Synthesizer
from prompt_tts_tpu_torch.train.loop import Trainer
from prompt_tts_tpu_torch.train.step import drawing_from

# the mesh is laid out by init_distributed ("init") or by the first
# Trainer ("trainer")
out, n_model, mesh_by = sys.argv[1], int(sys.argv[2]), sys.argv[3]
spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
dev = parallel.init_distributed(
    "cpu", n_model=n_model if mesh_by == "init" else 1)
w = parallel.world_rank()
res = {}


def config(model, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**spec["train"], **train}))


def trainer(name, cfg, ds, **kw):
    return Trainer(cfg, ds, log_dir=os.path.join(out, f"{name}{w}"),
                   device=dev, **kw)


def local(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


ds = SyntheticDataset(**spec["data"])
tr = trainer("step", config(spec["tiny"]), ds, init_state=spec["state"],
             n_model=n_model if mesh_by == "trainer" else None)
res.update(world=w, data=(parallel.data_rank(), parallel.data_size()),
           model=(parallel.model_rank(), parallel.model_size()))
grads = []
apply = tr.state.apply_gradients


def snapshot():
    grads.append({n: p.grad.clone() for n, p in
                  zip(tr.state.names, tr.state.params)})
    return apply()


tr.state.apply_gradients = snapshot
m = tr.train_step(next(ds.batches(spec["train"]["batch_size"])),
                  **spec["inputs"])
res["step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "grad": grads[0], "params": local(tr),
               "sharded": [n for n, p in tr.model.named_parameters()
                           if hasattr(p, "tp_dim")]}

# the prompt family's step (the condition drop, the prompt encoder's
# attentions sharded)
pds = SyntheticDataset(**spec["data"],
                       prompt_frames=spec["prompt"]["prompt_frames"])
tr = trainer("prompt", config(spec["prompt"], cond_dropout_prob=spec["cfg_drop"]),
             pds, init_state=spec["prompt_state"])
grads = []
apply = tr.state.apply_gradients
tr.state.apply_gradients = snapshot
m = tr.train_step(next(pds.batches(spec["train"]["batch_size"])),
                  **spec["prompt_inputs"])
res["prompt_step"] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "grad": grads[0]}

with drawing_from(tr.dropout_generator, tr.device):
    res["dropout_mask"] = torch.nn.functional.dropout(
        torch.ones(4096), 0.1, training=True) != 0

# the text encoder's and the UNet's dropout on: two steps keep the ranks'
# replicated parameters equal, with and without remat
two = SyntheticDataset(**dict(spec["data"], n=8))
drop = config(dict(spec["tiny"], text_encoder_dropout=0.1, dropout=0.1))
for remat in (False, True):
    tr = trainer(f"dropout_{remat}", drop, two, init_state=spec["state"],
                 remat=remat)
    tr.train()
    res[f"dropout_params_remat_{remat}"] = local(tr)
res["dropout_params"] = res.pop("dropout_params_remat_False")

# the one-process checkpoint restored here
tr = trainer("restore_one", config(spec["tiny"]), ds,
             ckpt_dir=spec["one_ckpt"])
res["restored_one"] = {"step": tr.restore_latest(),
                       "state": tr.state.state_dict()}

if parallel.data_size() == 1:
    # a checkpoint written here, then restored here
    ck = os.path.join(out, "ck")
    tr = trainer("save", config(spec["tiny"], ema_decay=0.5), two,
                 init_state=spec["state"], ckpt_dir=ck)
    tr.train()
    res["saved"] = {"step": tr.global_step, "state": tr.state.state_dict()}
    again = trainer("again", config(spec["tiny"], ema_decay=0.5), two,
                    ckpt_dir=ck)
    res["restored"] = {"step": again.restore_latest(),
                       "state": again.state.state_dict()}

    synth = Synthesizer(config=Config(model=ModelConfig(**spec["tiny"])),
                        device=dev, dtype=torch.float32,
                        num_inference_steps=spec["steps"],
                        model_state=spec["state"])
    res["tp"] = synth.tp
    res["latents"] = synth.denoise_latents(*spec["synth_inputs"])
    res["codes"] = synth.synthesize(spec["texts"], x_T=spec["synth_inputs"][0],
                                    return_codes=True)[1]
    # the prompt family under guidance; then the same denoise led by rank 0,
    # which sends the prompt latents and its settings to a follower set
    # to other ones
    psynth = Synthesizer(config=Config(model=ModelConfig(**spec["prompt"])),
                         device=dev, dtype=torch.float32,
                         num_inference_steps=spec["steps"],
                         model_state=spec["prompt_state"],
                         guidance_scale=spec["guidance"])
    res["prompt_latents"] = psynth.denoise_latents(*spec["prompt_synth"])
    if parallel.model_rank() == 0:
        psynth.lead()
        res["prompt_led"] = psynth.denoise_latents(*spec["prompt_synth"])
        psynth.release()
    else:
        psynth.guidance_scale, psynth.num_inference_steps = 1.0, 1
        res["prompt_followed"] = (psynth.follow(), psynth.guidance_scale,
                                  psynth.num_inference_steps)
    try:
        aot.export_synthesis(synth, 1, os.path.join(out, "never.ptts"))
        res["export"] = "exported"
    except ValueError as e:
        res["export"] = str(e)
res["jax_free"] = sorted({m.split(".")[0] for m in sys.modules} & {
    "jax", "flax", "optax", "prompt_tts_tpu"})
parallel.barrier()
torch.distributed.destroy_process_group()
torch.save(res, os.path.join(out, f"rank{w}.pt"))
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


def _start(argv, out, n, torchrun=False):
    """``n`` ranks of ``argv``, rendezvous from the ``PTTS_*`` variables or
    torchrun's; returns the processes."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": (os.environ.get("PYTHONPATH", "") + ":" + repo)
           .lstrip(":")}
    procs = []
    for r in range(n):
        if torchrun:
            rank_env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "RANK": str(r), "LOCAL_RANK": str(r),
                        "WORLD_SIZE": str(n)}
        else:
            rank_env = {"PTTS_COORDINATOR": f"127.0.0.1:{port}",
                        "PTTS_NUM_PROCESSES": str(n),
                        "PTTS_PROCESS_ID": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env={**env, **rank_env}, cwd=out,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=300):
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


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(prompt=False):
    """The JAX TINY model's parameter shapes, the flagship's or the prompt
    family's (traced once a module)."""
    model = (JaxPrompt(JaxModelConfig(**PROMPT)) if prompt
             else JaxSingle(JaxModelConfig(**TINY)))
    extra = (jnp.zeros((1, PROMPT["prompt_frames"], 8)),) if prompt else ()
    return jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 48, 8)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), jnp.int32), *extra)


def _draws(key, codes):
    """The noise and timesteps JAX's loss derives from ``key`` for the
    global batch ``codes``, as torch tensors."""
    rng_noise, rng_t, _, _ = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes.shape, codes.dtype)
    t = jax.random.randint(rng_t, (codes.shape[0],), 0, 1000,
                           dtype=jnp.int32)
    return {"noise": torch.from_numpy(np.array(noise)),
            "timesteps": torch.from_numpy(np.array(t))}


def _config(model=TINY, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**TRAIN, **train}))


def _shapes(prompt=False):
    cls, widths = ((TTSPromptSpeaker, PROMPT) if prompt
                   else (TTSSingleSpeaker, TINY))
    return {k: tuple(v.shape) for k, v in cls(
        ModelConfig(**widths), device="meta").state_dict().items()}


def _gathered(ranks, key, sub=None):
    """The whole state of a model group's ``ranks``' results ``key``."""
    parts = [r[key] if sub is None else r[key][sub] for r in ranks]
    return gather_state(parts, _shapes())


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _flat(d, names):
    return torch.cat([d[n].flatten() for n in names])


def _codes_of(latents):
    return np.clip(np.round((latents + 1.0) * (1023.0 / 2.0)), 0,
                   1023).astype(np.int32).transpose(0, 2, 1)


def _read_wav(path):
    with wave.open(str(path)) as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/synthesize", body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _served(port, procs):
    """Once rank 0 answers: one request, then a wave of 4 at once; then
    SIGTERM to rank 0.  Returns {(text, seed): (status, body)}."""
    deadline = time.monotonic() + 240
    while True:
        assert all(p.poll() is None for p in procs), "a serve rank exited"
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                break
        except OSError:
            pass
        assert time.monotonic() < deadline, "the tp2 server never answered"
        time.sleep(0.2)
    out = {SERVE_REQUESTS[0]: _post(port, dict(zip(("text", "seed"),
                                                   SERVE_REQUESTS[0])))}
    with ThreadPoolExecutor(4) as pool:
        wave_ = {r: pool.submit(_post, port, {"text": r[0], "seed": r[1]})
                 for r in SERVE_REQUESTS[1:]}
        out.update({r: f.result() for r, f in wave_.items()})
    procs[0].send_signal(signal.SIGTERM)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start both worlds and both CLI pairs, compute the references
    meanwhile, and return the ranks' results beside them."""
    out = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    batch = next(JaxSynthetic(**DATA).batches(B))
    jmodel = JaxSingle(JaxModelConfig(**TINY))
    params = _fill(_jax_param_shapes(), rng)
    state = model_state_from_jax(params)
    key = jax.random.PRNGKey(7)
    inputs = _draws(key, batch["codes"])
    x_T = rng.standard_normal((len(TEXTS), TINY["sample_size"], 8)).astype(
        np.float32)
    port_synth = Synthesizer(config=Config(model=ModelConfig(**TINY)),
                             device="cpu", dtype=torch.float32,
                             num_inference_steps=STEPS, model_state=state)
    ids, mask = port_synth.tokenizer.encode_batch(TEXTS)
    synth_inputs = tuple(torch.from_numpy(np.asarray(a))
                         for a in (x_T, ids, mask))
    # a one-process checkpoint for the ranks to restore
    one_ckpt = out / "one_ckpt"
    Trainer(_config(), SyntheticDataset(**DATA), log_dir=str(out / "one_ck"),
            device="cpu", init_state=state,
            ckpt_dir=str(one_ckpt)).train()
    # the prompt family: seeded weights, the step's draws, and a guided
    # synthesis's inputs
    prompt_state = random_init_(TTSPromptSpeaker(ModelConfig(**PROMPT)),
                                torch.Generator().manual_seed(3)).state_dict()
    codes_shape = (B, DATA["frames"], 8)
    prompt_inputs = {
        "noise": torch.from_numpy(rng.standard_normal(codes_shape).astype(
            np.float32)),
        "timesteps": torch.from_numpy(rng.integers(0, 1000, B).astype(
            np.int32)),
        "drop": torch.tensor([[True], [False], [False], [True]])}
    prompt_synth = synth_inputs + (torch.from_numpy(rng.uniform(
        -1.0, 1.0, (len(TEXTS), PROMPT["prompt_frames"], 8)).astype(
            np.float32)),)
    spec = dict(tiny=TINY, train=TRAIN, data=DATA, state=state,
                inputs=inputs, steps=STEPS, texts=TEXTS,
                synth_inputs=synth_inputs, one_ckpt=str(one_ckpt),
                prompt=PROMPT, prompt_state=prompt_state, cfg_drop=CFG_DROP,
                prompt_inputs=prompt_inputs, prompt_synth=prompt_synth,
                guidance=GUIDANCE)
    worlds = {}
    for name, n, mesh_by in (("tp2", 2, "init"), ("dp2tp2", 4, "trainer")):
        (out / name).mkdir()
        torch.save(spec, out / name / "spec.pt")
        (out / name / "worker.py").write_text(_WORKER)
        worlds[name] = _start([str(out / name / "worker.py"),
                               str(out / name), "2", mesh_by], out / name, n)
    cli_out = out / "cli"
    cli_out.mkdir()
    cfg_path = str(cli_out / "tiny.json")
    _config().to_json(cfg_path)
    synth_argv = ["--config_file", cfg_path, "--device", "cpu", "--steps",
                  "2", "--dtype", "f32", "--text", TEXTS[0], "--text",
                  TEXTS[1]]
    clis = {
        "train": _start(["-m", "prompt_tts_tpu_torch.cli.train", "--smoke",
                         "--multihost", "--tp", "2", "--device", "cpu",
                         "--log_dir", str(cli_out / "log"), "--ckpt_dir",
                         str(cli_out / "ck")], cli_out, 2, torchrun=True),
        "synthesize": _start(["-m", "prompt_tts_tpu_torch.cli.synthesize",
                              "--multihost", "--tp", "2", "--out",
                              str(cli_out / "tp.wav")] + synth_argv,
                             cli_out, 2, torchrun=True),
    }
    serve_port = _free_port()
    clis["serve"] = _start(
        ["-m", "prompt_tts_tpu_torch.cli.serve", "--multihost", "--tp", "2",
         "--port", str(serve_port)] + SERVE_ARGV + ["--config_file",
                                                    cfg_path],
        cli_out, 2, torchrun=True)
    procs = [p for ps in list(worlds.values()) + list(clis.values())
             for p in ps]
    try:
        ref = {"spec": spec, "out": out, "cli_out": cli_out}
        # JAX: the unsharded step, and the unsharded synthesis's latents
        # (the two compiles overlap: XLA releases the interpreter lock)
        jsynth = JaxSynthesizer(config=JaxConfig(model=JaxModelConfig(**TINY)),
                                model_params=params, codec_params={},
                                num_inference_steps=STEPS,
                                dtype=jnp.float32)
        denoise = jax.jit(jsynth._denoise_latents)
        with ThreadPoolExecutor(1) as pool:
            lat = pool.submit(lambda: np.asarray(denoise(
                params, jnp.asarray(x_T), jnp.asarray(ids),
                jnp.asarray(mask))))
            mesh = make_mesh(devices=jax.devices()[:1])
            jstate = create_train_state(jmodel, params,
                                        JaxTrainConfig(**TRAIN), 10)
            step = jit_train_step(make_train_step(jmodel.apply,
                                                  jax_schedule()), mesh)
            new, m = step(jstate, jax_shard_batch(batch, mesh), key)
            ref["jax_loss"] = float(m["loss"])
            ref["jax_latents"] = lat.result()
        ref["jax_params"] = model_state_from_jax(
            jax.tree.map(np.asarray, new.params))
        # the port in one process
        ds = SyntheticDataset(**DATA)
        tr = Trainer(_config(), ds, log_dir=str(out / "one"), device="cpu",
                     init_state=state)
        grads = []
        apply = tr.state.apply_gradients

        def snapshot():
            grads.append({n: p.grad.clone() for n, p in
                          zip(tr.state.names, tr.state.params)})
            return apply()
        tr.state.apply_gradients = snapshot
        m = tr.train_step(next(ds.batches(B)), **inputs)
        ref["one"] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "grad": grads[0],
                      "names": tr.state.names}
        pds = SyntheticDataset(**DATA, prompt_frames=PROMPT["prompt_frames"])
        tr = Trainer(_config(PROMPT, cond_dropout_prob=CFG_DROP), pds,
                     log_dir=str(out / "one_prompt"), device="cpu",
                     init_state=prompt_state)
        grads = []
        apply = tr.state.apply_gradients
        tr.state.apply_gradients = snapshot
        m = tr.train_step(next(pds.batches(B)), **prompt_inputs)
        ref["one_prompt"] = {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "grad": grads[0], "names": tr.state.names}
        ref["one_prompt_latents"] = Synthesizer(
            config=Config(model=ModelConfig(**PROMPT)), device="cpu",
            dtype=torch.float32, num_inference_steps=STEPS,
            model_state=prompt_state, guidance_scale=GUIDANCE,
        ).denoise_latents(*prompt_synth)
        ref["one_latents"] = port_synth.denoise_latents(*synth_inputs)
        ref["one_codes"] = port_synth.synthesize(
            TEXTS, x_T=synth_inputs[0], return_codes=True)[1]
        from prompt_tts_tpu_torch.cli.synthesize import main as synthesize
        ref["one_cli"] = synthesize(["--out", str(cli_out / "one.wav")]
                                    + synth_argv)
        ref["served"] = _served(serve_port, clis["serve"])
        # the one-process server's program: a request alone is its batch
        from prompt_tts_tpu_torch.cli.serve import _synthesizer, parse_args
        one = _synthesizer(parse_args(SERVE_ARGV + ["--config_file",
                                                    cfg_path]), "cpu")
        ref["served_one"] = {r: one.synthesize([r[0]], seed=r[1],
                                               pcm16=True)[0]
                             for r in SERVE_REQUESTS}
        for name, ps in worlds.items():
            _finish(ps)
            ref[name] = [torch.load(out / name / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(len(ps))]
        ref["cli_logs"] = {name: _finish(ps) for name, ps in clis.items()}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ref


# -- the rules (no ranks) ------------------------------------------------------

def _jax_specs(n_model, prompt=False):
    """JAX's spec of each TINY parameter (of the flagship or the prompt
    family) on a mesh with ``n_model`` model devices, by the port's
    state-dict name, and the leaf's shape."""
    params = _jax_param_shapes(prompt)
    mesh = make_mesh(n_model=n_model)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] == "params":
            keys = keys[1:]
        *mods, last = keys
        name = ".".join(mods + ["weight" if last in (
            "kernel", "scale", "embedding") else last])
        out[name] = (tuple(tp_shardings_one(path, leaf, mesh).spec),
                     leaf.shape)
    return out


def _hold_rules(n_model, prompt):
    """The port's rules against JAX's on the TINY model of one family (see
    the tests below)."""
    jax_specs = _jax_specs(n_model, prompt)
    shapes = _shapes(prompt)
    assert set(jax_specs) == set(shapes)
    n_sharded = 0
    for name, shape in shapes.items():
        spec, jshape = jax_specs[name]
        got = shard_dim(name, shape, n_model)
        if name.endswith(".bias"):
            weight = name[:-len("bias")] + "weight"
            assert got == (None if shard_dim(weight, shapes[weight], n_model)
                           != 0 else 0), name
            continue
        axes = [i for i, a in enumerate(spec) if a == MODEL_AXIS]
        if not axes:
            assert got is None, name
            continue
        # JAX kernels: [in, out] -> torch [out, in]; [k, in, out] ->
        # [out, in, k]; embeddings as they are
        jdim = axes[0]
        if len(jshape) == 2 and not name.endswith("word_embedding.weight"):
            want = 1 - jdim
        elif len(jshape) == 3:
            want = 2 - jdim
        else:
            want = jdim
        assert got == want, (name, spec, got)
        n_sharded += 1
    assert n_sharded > 0
    pool = [n for n in shapes if ".pool." in n
            and shard_dim(n, shapes[n], n_model) is not None]
    assert len(pool) == (4 if prompt else 0), pool
    # each JAX pattern has its counterpart
    assert len(TP_RULES) == 9


@pytest.mark.parametrize("n_model", [2, 8])
def test_rules_shard_what_jax_shards(n_model):
    """Every weight the port shards is one JAX shards over the same dim of
    the same tensor (its kernel layout mapped to torch's), and the reverse;
    the biases the port slices are those of its column-parallel layers;
    at 8 ranks the dims that do not divide stay whole on both sides."""
    _hold_rules(n_model, prompt=False)


@pytest.mark.parametrize("n_model", [2, 8])
def test_prompt_rules_shard_what_jax_shards(n_model):
    """The same for the prompt family, whose encoder adds self-attention
    blocks and the ``pool`` attention that JAX's rules name apart."""
    _hold_rules(n_model, prompt=True)


def test_indivisible_dims_replicate():
    """As ``test_tp.py``'s case: a q kernel of 5 outputs over 8 ranks
    stays whole; so does the GEGLU projection whose halves do not divide,
    and a name no rule names."""
    assert shard_dim("attn1.to_q.weight", (5, 3), 8) is None
    assert shard_dim("attn1.to_q.weight", (8, 3), 8) == 0
    assert shard_dim("block_0.ff.proj.weight", (12, 3), 4) is None
    assert shard_dim("block_0.ff.proj.weight", (16, 3), 4) == 0
    assert shard_dim("unet.conv_in.conv.weight", (32, 8, 3), 2) is None


def test_geglu_layout_round_trip():
    """``gather_state(shard_state(s)) == s`` bit for bit, and rank r's
    GEGLU projection is ``[value_r | gate_r]``."""
    model = TTSSingleSpeaker(ModelConfig(**TINY))
    sd = model.state_dict()
    shards = [shard_state(sd, r, 2) for r in range(2)]
    back = gather_state(shards, _shapes())
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    name = "unet.mid.attn_0.block_0.ff.proj.weight"
    value, gate = sd[name].chunk(2)
    w = value.shape[0] // 2
    for r in range(2):
        assert torch.equal(shards[r][name], torch.cat(
            [value[r * w:(r + 1) * w], gate[r * w:(r + 1) * w]]))


# -- the ranks ---------------------------------------------------------------

def test_ranks_lay_out_data_major(run):
    """World rank w sits at data row w // 2, model column w % 2, laid out
    by ``init_distributed(n_model=2)`` (tp2) or by ``Trainer(n_model=2)``
    (dp2 x tp2)."""
    for name, n in (("tp2", 2), ("dp2tp2", 4)):
        for w, res in enumerate(run[name]):
            assert res["world"] == w
            assert res["model"] == (w % 2, 2)
            assert res["data"] == (w // 2, n // 2)


def test_ranks_load_no_jax(run):
    for name in ("tp2", "dp2tp2"):
        for res in run[name]:
            assert res["jax_free"] == [], res["jax_free"]


@pytest.mark.parametrize("world", ["tp2", "dp2tp2"])
def test_sharded_step_is_the_one_process_step(run, world):
    """The flagship family's step over a model axis of 2 (and a data axis
    of 2): the loss within 1e-6 of one process on the same 4 rows, the
    gathered gradient within a relative 1e-5, the same on every rank; the
    ruled tensors are sharded."""
    ranks = run[world]
    one = run["one"]
    names = one["names"]
    for res in ranks:
        assert abs(res["step"]["loss"] - one["loss"]) <= RANKS_LOSS_TOL
        assert abs(res["step"]["grad_norm"] - one["grad_norm"]) <= \
            RANKS_GRAD_RTOL * one["grad_norm"]
        assert len(res["step"]["sharded"]) > 0
    for row in range(0, len(ranks), 2):
        group = ranks[row:row + 2]
        grad = gather_state([r["step"]["grad"] for r in group], _shapes())
        assert _rel(_flat(grad, names), _flat(one["grad"], names)) <= \
            RANKS_GRAD_RTOL
    # the data rows of a dp2 x tp2 step hold the same parameters
    for a, b in zip(ranks[:2], ranks[2:]):
        for k, v in a["step"]["params"].items():
            assert torch.equal(v, b["step"]["params"][k]), k


@pytest.mark.parametrize("world", ["tp2", "dp2tp2"])
def test_sharded_step_is_jax_unsharded_step(run, world):
    """Against JAX's unsharded step with its draws injected: the loss to
    1e-5, the gathered parameters after the update as
    ``test_torch_parallel.py`` holds them."""
    ranks = run[world]
    assert abs(ranks[0]["step"]["loss"] - run["jax_loss"]) <= JAX_LOSS_TOL
    params = _gathered(ranks[:2], "step", "params")
    state = run["spec"]["state"]
    one = run["one"]["grad"]
    gnorm = float(torch.linalg.vector_norm(_flat(one, list(one))))
    zero = {n for n, g in one.items()
            if float(torch.linalg.vector_norm(g)) <= ZERO_GRAD * gnorm}
    assert 0 < len(zero) < len(one) // 4
    for k, old in state.items():
        got, want = params[k], run["jax_params"][k]
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        if k in one and k not in zero:
            assert _rel(got - old, want - old) <= UPDATE_RTOL, k


def test_sharded_synthesis_latents(run):
    """``Synthesizer`` over a model group of 2, f32, 4 DDIM steps: the
    latents within 2e-4 of the port in one process and of JAX's
    ``_denoise_latents`` on the same weights and x_T; the codes agree in
    more than 99 % of places with both; the ranks' results are equal."""
    a, b = run["tp2"]
    assert a["tp"] == b["tp"] == 2
    assert torch.equal(a["latents"], b["latents"])
    np.testing.assert_array_equal(a["codes"], b["codes"])
    lat = a["latents"].numpy()
    np.testing.assert_allclose(lat, run["one_latents"].numpy(),
                               atol=LATENT_TOL, rtol=0)
    np.testing.assert_allclose(lat, run["jax_latents"], atol=LATENT_TOL,
                               rtol=0)
    assert float((a["codes"] == run["one_codes"]).mean()) > CODE_AGREE
    assert float((_codes_of(lat) == _codes_of(run["jax_latents"])).mean()
                 ) > CODE_AGREE


@pytest.mark.parametrize("world", ["tp2", "dp2tp2"])
def test_sharded_prompt_step_is_the_one_process_step(run, world):
    """The prompt family's step (the condition drop on two of the 4 rows)
    over a model axis of 2 (and a data axis of 2): the loss and the
    gradient norm as the flagship's are held, the gathered gradient within
    a relative 1e-5 of one process's, the prompt encoder's attentions and
    ``pool`` among the sharded tensors."""
    ranks = run[world]
    one = run["one_prompt"]
    names = one["names"]
    shapes = _shapes(prompt=True)
    for res in ranks:
        assert abs(res["prompt_step"]["loss"] - one["loss"]) <= \
            RANKS_LOSS_TOL
        assert abs(res["prompt_step"]["grad_norm"] - one["grad_norm"]) <= \
            RANKS_GRAD_RTOL * one["grad_norm"]
    for row in range(0, len(ranks), 2):
        parts = [r["prompt_step"]["grad"] for r in ranks[row:row + 2]]
        for name in ("prompt_encoder.pool.to_q.weight",
                     "prompt_encoder.block_0.attn1.to_out.weight"):
            assert parts[0][name].numel() * 2 == one["grad"][name].numel()
        grad = gather_state(parts, shapes)
        assert _rel(_flat(grad, names), _flat(one["grad"], names)) <= \
            RANKS_GRAD_RTOL


def test_sharded_prompt_synthesis_latents(run):
    """The prompt family's ``Synthesizer`` over a model group of 2 under
    guidance (scale 2, the null branch doubling the batch), f32, 4 DDIM
    steps: the latents within 2e-4 of the port in one process, equal on
    both ranks; the same denoise led by rank 0 (``lead``, as ``cli.serve``
    runs it) gives rank 0 the same bits, its follower having run one
    denoise on the prompt latents and settings rank 0 sent."""
    a, b = run["tp2"]
    assert torch.equal(a["prompt_latents"], b["prompt_latents"])
    np.testing.assert_allclose(a["prompt_latents"].numpy(),
                               run["one_prompt_latents"].numpy(),
                               atol=LATENT_TOL, rtol=0)
    assert torch.equal(a["prompt_led"], a["prompt_latents"])
    assert b["prompt_followed"] == (1, GUIDANCE, STEPS)


def test_tp2_checkpoint_restores_bit_equal(run):
    """A checkpoint written by 2 model ranks restores on them bit for bit
    (parameters, AdamW moments, EMA), and loads in one process as the
    whole (one-rank) layout: the gathered state of the ranks."""
    ranks = run["tp2"]
    for res in ranks:
        assert res["restored"]["step"] == res["saved"]["step"] == 2
        saved, restored = res["saved"]["state"], res["restored"]["state"]
        for part in ("model", "ema"):
            for k, v in saved[part].items():
                assert torch.equal(restored[part][k], v), (part, k)
        for idx, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(restored["optimizer"]["state"][idx][k],
                                   v), (idx, k)
    ckpt = CheckpointManager(str(run["out"] / "tp2" / "ck"))
    sd, step = ckpt.read_model_state()
    assert step == 2
    model = TTSSingleSpeaker(ModelConfig(**TINY))
    model.load_state_dict(sd, strict=True)
    whole = gather_state([r["saved"]["state"]["model"] for r in ranks],
                         _shapes())
    for k, v in whole.items():
        assert torch.equal(sd[k], v), k
    tr = Trainer(_config(ema_decay=0.5), SyntheticDataset(**DATA),
                 log_dir=str(run["out"] / "one_restore"), device="cpu",
                 ckpt_dir=str(run["out"] / "tp2" / "ck"))
    assert tr.restore_latest() == 2
    one = tr.state.state_dict()
    for r, res in enumerate(ranks):
        mine = shard_train_state(one, tr.state.names, r, 2)
        for idx, st in mine["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(res["saved"]["state"]["optimizer"]
                                   ["state"][idx][k], v), (idx, k)
        for k, v in mine["ema"].items():
            assert torch.equal(res["saved"]["state"]["ema"][k], v), k


@pytest.mark.parametrize("world", ["tp2", "dp2tp2"])
def test_one_process_checkpoint_restores_sharded(run, world):
    """A checkpoint one process wrote restores on 2 model ranks (and on
    dp2 x tp2) as its slices, bit for bit."""
    tr = Trainer(_config(), SyntheticDataset(**DATA),
                 log_dir=str(run["out"] / "one_again"), device="cpu",
                 ckpt_dir=run["spec"]["one_ckpt"])
    step = tr.restore_latest()
    one = tr.state.state_dict()
    for res in run[world]:
        r = res["model"][0]
        assert res["restored_one"]["step"] == step == 1
        mine = shard_train_state(one, tr.state.names, r, 2)
        got = res["restored_one"]["state"]
        for k, v in mine["model"].items():
            assert torch.equal(got["model"][k], v), k
        for idx, st in mine["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["state"][idx][k], v)


def test_model_group_draws_one_dropout_mask(run):
    """The ranks of one model group draw equal masks (the stream is the
    data rank's), different data ranks different ones; after two steps
    with the text encoder's and the UNet's dropout on, the ranks of a
    group hold the same replicated parameters."""
    d = run["dp2tp2"]
    assert torch.equal(d[0]["dropout_mask"], d[1]["dropout_mask"])
    assert torch.equal(d[2]["dropout_mask"], d[3]["dropout_mask"])
    assert not torch.equal(d[0]["dropout_mask"], d[2]["dropout_mask"])
    a, b = run["tp2"]
    assert torch.equal(a["dropout_mask"], b["dropout_mask"])
    assert torch.equal(a["dropout_mask"], d[0]["dropout_mask"])
    shapes = _shapes()
    replicated = [k for k in shapes if shard_dim(k, shapes[k], 2) is None]
    assert len(replicated) > 0
    for k in replicated:
        assert torch.equal(a["dropout_params"][k], b["dropout_params"][k]), k
    sharded = [k for k in shapes if shard_dim(k, shapes[k], 2) is not None]
    assert any(not torch.equal(a["dropout_params"][k],
                               b["dropout_params"][k]) for k in sharded)


def test_remat_under_tp_is_bit_equal(run):
    """The same two steps with dropout under ``remat`` (the blocks'
    recompute redraws the masks and reruns the collectives) give the
    plain steps' parameters bit for bit on every rank."""
    for res in run["tp2"]:
        plain, remat = res["dropout_params"], res["dropout_params_remat_True"]
        for k, v in plain.items():
            assert torch.equal(remat[k], v), k


def test_export_refuses_sharded_synthesizer(run):
    for res in run["tp2"]:
        assert res["export"].startswith("cannot export a "
                                        "model-group-sharded Synthesizer")


def test_cli_train_tp2(run):
    """``cli.train --smoke --multihost --tp 2 --device cpu``, two ranks from
    torchrun's variables: both exit 0; rank 0 logged finite losses and
    wrote a checkpoint that loads in one process."""
    log_path = run["cli_out"] / "log" / "metrics.jsonl"
    with open(log_path) as f:
        rows = [json.loads(line) for line in f]
    losses = {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    sd, step = CheckpointManager(str(run["cli_out"] / "ck")
                                 ).read_model_state()
    assert step == 2
    smoke = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
                 attention_head_dim=32, text_encoder_layers=1,
                 cmu_seq_len=32, sample_size=48, layers_per_block=1,
                 unet_num_heads=4)
    TTSSingleSpeaker(ModelConfig(**smoke)).load_state_dict(sd, strict=True)


def test_cli_serve_tp2(run):
    """``cli.serve --multihost --tp 2`` (f32, 2 DDIM steps, batch 1): rank
    0 answered one request and a wave of 4, each the one-process program's
    PCM within one step; SIGTERM drained rank 0, which released rank 1
    after the warmup's 2 denoises and the 5 requests'; both exited 0."""
    for r in SERVE_REQUESTS:
        status, body = run["served"][r]
        assert status == 200, (r, body[:200])
        assert body[:4] == b"RIFF"
        got = np.frombuffer(body[44:], "<i2").astype(np.int32)
        want = run["served_one"][r].astype(np.int32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, r
    lead, follow = run["cli_logs"]["serve"]
    assert "drained; exiting" in lead
    assert "rank 0 shut down after 7 denoises" in follow


def test_cli_synthesize_tp2(run):
    """``cli.synthesize --multihost --tp 2`` (random seeded weights, f32,
    2 DDIM steps, two texts): rank 0 wrote one wav a text, each the one-
    process CLI's PCM within one step, and both ranks logged the
    synthesis."""
    _, wavs, codes = run["one_cli"]
    for i, wav in enumerate(wavs):
        got = _read_wav(run["cli_out"] / f"tp_{i}.wav")
        want = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(
            np.int32)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    logs = run["cli_logs"]["synthesize"]
    assert all("synthesized 2 utterance(s)" in log for log in logs)
