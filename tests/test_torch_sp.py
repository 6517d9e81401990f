"""Sequence parallelism: the port's seq-sharded UNet over gloo ranks on the
CPU.

The port of ``tests/test_sp.py`` (and of the ladder check of
``tests/test_multichip_geometry.py``) for ``prompt_tts_tpu_torch``.
Worker processes join process groups (the ``PTTS_*`` variables, as
``tests/test_torch_tp.py`` starts them): one world of 2 ranks (sp2) and
one of 4, laid out as sp 4, as dp2 x sp2 and as tp2 x sp2 in turn; the
CLIs run as three more pairs (torchrun's variables; ``cli.serve --sp 2``
answers over HTTP on localhost).  This process holds their results to the
port in one process and to the JAX package's one-device programs on the
same weights and draws.

Configurations: ``test_sp.py``'s two-level ``MCFG`` (32 frames: levels of
32 and 16, which divide 2 and 4) with the text encoder's dropout off; its
fallback case (``sample_size`` 50 at sp 4: no level divides, so every
rank runs the whole model); and the flagship's ladder 900/450/225/113 at
thin channels (``test_multichip_geometry.py``'s ``GEOM``), whose 225 and
113 do not divide 2; and, at thin channels, two ladders where a whole
level is followed by a sharded one, whose downsampler runs whole and
slices its output: ``sample_size`` 1100 at sp 2 (1100/550/275/138) and
60 at sp 4 (60/30/15/8); and the average pool and the conv-transpose
upsample at 56 frames, sp 4 (56/28/14/7).

Tolerances (``test_sp.py``'s): the forward 2e-5 absolute against JAX and
against one process; a step's loss 1e-4 and gradient norm 1e-3 relative;
the gradients compared as ``test_sp.py`` compares them, through the SGD
update they make at the step's learning rate (1e-3): rtol 2e-3, atol 5e-8.
Synthesis latents 2e-4 (JAX's TP and SP bound) against one process.
"""

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

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxSingle
from prompt_tts_tpu.train.step import make_loss_fn as jax_make_loss_fn
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.parallel.sp import SeqGroup
from prompt_tts_tpu_torch.parallel.tp import (
    TPGroup, gather_state, sharded_dropout,
)
from prompt_tts_tpu_torch.pipeline import Synthesizer, random_init_
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.loop import Trainer

FWD_ATOL = 2e-5
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
UPDATE_RTOL, UPDATE_ATOL = 2e-3, 5e-8
LATENT_TOL = 2e-4
SERVE_ARGV = ["--device", "cpu", "--steps", "2", "--dtype", "f32",
              "--max_batch", "1"]

MCFG = dict(block_out_channels=(32, 64), cross_attention_dim=64,
            attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
            sample_size=32, layers_per_block=1, unet_num_heads=4,
            down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
            up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
            text_encoder_dropout=0.0)
FALLBACK = dict(MCFG, cmu_seq_len=30, sample_size=50)
LADDER = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
              attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=550,
              sample_size=900, layers_per_block=1, unet_num_heads=4,
              text_encoder_dropout=0.0)
# a whole level before a sharded one, at sp 2 and at sp 4; and the
# average pool and the conv-transpose upsample crossing between a sharded
# level and a whole one (56/28/14/7 at sp 4)
THIN = dict(LADDER, block_out_channels=(32, 32, 32, 32), cmu_seq_len=32)
EDGES = {"sp2": dict(THIN, sample_size=1100),
         "sp4": dict(THIN, sample_size=60),
         "sp4_variants": dict(THIN, sample_size=56, downsample_avg_pool=True,
                              upsample_conv_transpose=True)}
EDGE_PLANS = {"sp2": [True, True, False, True],
              "sp4": [True, False, False, True],
              "sp4_variants": [True, True, False, False]}
# the sharded levels with self-attention (every level has some)
EDGE_TQS = {"sp2": [138, 550, 1100], "sp4": [8, 60],
            "sp4_variants": [28, 56]}
PROMPT = dict(MCFG, prompt_conditioning=True, prompt_frames=24,
              prompt_encoder_layers=1, prompt_tokens=8)
GUIDANCE = 2.0
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
             batch_size=4, num_train_epochs=1)
B = 4
DATA = dict(n=8, frames=32, max_seq_length=32)
TIMESTEPS = [0, 250, 500, 999]
TEXTS = ["hello world", "a test"]
STEPS = 4
SERVE_REQUESTS = [("hello world", 3), ("wave one", 10), ("wave two", 11)]

# the ranks' program; its arguments come in ``spec.pt``, its results go to
# ``rank<r>.pt``.  It must load no module of JAX.
_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from prompt_tts_tpu_torch import aot, parallel
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.parallel import sp
from prompt_tts_tpu_torch.pipeline import Synthesizer, random_init_
from prompt_tts_tpu_torch.train.loop import Trainer

out, world = sys.argv[1], sys.argv[2]
spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
dev = parallel.init_distributed("cpu", n_seq=2 if world == "sp2" else 1)
w = parallel.world_rank()
res = {}


def config(model, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**spec["train"], **train}))


def place():
    return {"world": w, "data": (parallel.data_rank(), parallel.data_size()),
            "model": (parallel.model_rank(), parallel.model_size()),
            "seq": (parallel.seq_rank(), parallel.seq_size())}


def forward(model, cfg, batch, t):
    sp.reset_ring_traces()
    model.eval()
    with torch.no_grad():
        o = model(torch.from_numpy(batch["codes"]), t,
                  torch.from_numpy(batch["text_ids"]),
                  torch.from_numpy(batch["text_mask"]))
    return o, sp.ring_trace_tqs()


def edge(e):
    model = TTSSingleSpeaker(ModelConfig(**e["model"]))
    model.load_state_dict(e["state"])
    sp.shard_seq_(model, sp.mesh_seq())
    o, tqs = forward(model, None, e["batch"], e["t"])
    return {"forward": o, "tqs": tqs,
            "plan": model.unet.arm_seq(e["model"]["sample_size"])}


def case(name, **mesh):
    ds = SyntheticDataset(**spec["data"])
    batch = next(ds.batches(spec["train"]["batch_size"]))
    tr = Trainer(config(spec["mcfg"]), ds, log_dir=os.path.join(
                 out, f"{name}{w}"), device=dev, init_state=spec["state"],
                 **mesh)
    rows = parallel.shard_batch(batch)
    n = len(rows["codes"])
    t = spec["t"][parallel.data_rank() * n:(parallel.data_rank() + 1) * n]
    o, tqs = forward(tr.model, None, rows, t)
    grads = []
    apply = tr.state.apply_gradients

    def snapshot():
        grads.append({k: p.grad.clone() for k, p in
                      zip(tr.state.names, tr.state.params)})
        return apply()
    tr.state.apply_gradients = snapshot
    sp.reset_ring_traces()
    m = tr.train_step(batch, **spec["inputs"])
    res[name] = {"place": place(), "forward": o, "forward_tqs": tqs,
                 "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "grad": grads[0], "step_tqs": sp.ring_trace_tqs()}


if world == "sp2":
    case("sp2")
    # the flagship's ladder at thin channels
    model = random_init_(TTSSingleSpeaker(ModelConfig(**spec["ladder"])),
                         torch.Generator().manual_seed(4))
    sp.shard_seq_(model, sp.mesh_seq())
    o, tqs = forward(model, None, spec["ladder_batch"], spec["ladder_t"])
    res["ladder"] = {"forward": o, "tqs": tqs,
                     "plan": model.unet.arm_seq(spec["ladder"]["sample_size"])}
    res["edge"] = {"sp2": edge(spec["edges"]["sp2"])}
    # synthesis: the flagship, and the prompt family under guidance
    synth = Synthesizer(config=Config(model=ModelConfig(**spec["mcfg"])),
                        device=dev, dtype=torch.float32,
                        num_inference_steps=spec["steps"],
                        model_state=spec["state"])
    res["sp"] = synth.sp
    res["latents"] = synth.denoise_latents(*spec["synth_inputs"])
    try:
        aot.export_synthesis(synth, 1, os.path.join(out, "never.ptts"))
        res["export"] = "exported"
    except ValueError as e:
        res["export"] = str(e)
    psynth = Synthesizer(config=Config(model=ModelConfig(**spec["prompt"])),
                         device=dev, dtype=torch.float32,
                         num_inference_steps=spec["steps"],
                         model_state=spec["prompt_state"],
                         guidance_scale=spec["guidance"])
    res["prompt_latents"] = psynth.denoise_latents(*spec["prompt_synth"])
    # a checkpoint written by the seq group
    ck = os.path.join(out, "ck")
    tr = Trainer(config(spec["mcfg"], ema_decay=0.5),
                 SyntheticDataset(**spec["data"]),
                 log_dir=os.path.join(out, f"save{w}"), device=dev,
                 init_state=spec["state"], ckpt_dir=ck)
    tr.train()
    res["saved"] = {"step": tr.global_step, "state": tr.state.state_dict()}
else:
    # sp 4: the fallback lengths (no level divides 4), then MCFG
    parallel.set_mesh(1, 4)
    model = random_init_(TTSSingleSpeaker(ModelConfig(**spec["fallback"])),
                         torch.Generator().manual_seed(6))
    sp.shard_seq_(model, sp.mesh_seq())
    o, tqs = forward(model, None, spec["fallback_batch"], spec["t"])
    res["fallback"] = {"place": place(), "forward": o, "tqs": tqs}
    res["edge"] = {k: edge(e) for k, e in spec["edges"].items()
                   if k.startswith("sp4")}
    case("sp4")
    case("dp2sp2", n_model=1, n_seq=2)
    case("tp2sp2", n_model=2, n_seq=2)
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
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONFAULTHANDLER": "1",
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
    """Wait for ``procs``; past ``timeout`` stop them all, each dumping
    its threads' stacks first (``faulthandler`` on SIGABRT).  Fails naming
    each rank that did not exit 0, with the end of its output."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.send_signal(signal.SIGABRT)
                break
    finally:
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    # the output of the ranks not read before a timeout
    outs += [p.communicate()[0] for p in procs[len(outs):]]
    failed = [f"rank {r} failed ({p.returncode}):\n{text[-3000:]}"
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


def _draws(key, codes):
    """The noise and timesteps JAX's loss derives from ``key`` for the
    global batch ``codes``, as torch tensors."""
    rng_noise, rng_t, _, _ = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes.shape, codes.dtype)
    t = jax.random.randint(rng_t, (codes.shape[0],), 0, 1000,
                           dtype=jnp.int32)
    return {"noise": torch.from_numpy(np.array(noise)),
            "timesteps": torch.from_numpy(np.array(t))}


def _config(model=MCFG, **train):
    return Config(model=ModelConfig(**model),
                  train=TrainConfig(**{**TRAIN, **train}))


def _shapes():
    return {k: tuple(v.shape) for k, v in TTSSingleSpeaker(
        ModelConfig(**MCFG), device="meta").state_dict().items()}


def _batch(cfg, n):
    ds = SyntheticDataset(n=n, frames=cfg["sample_size"],
                          max_seq_length=cfg["cmu_seq_len"])
    return next(ds.batches(n))


def _edge(cfg, rng):
    """JAX's weights for ``cfg`` drawn from ``rng``, a batch of 1 and its
    timestep: the ranks' inputs for one edge case."""
    jmodel = JaxSingle(JaxModelConfig(**cfg))
    T, S = cfg["sample_size"], cfg["cmu_seq_len"]
    params = _fill(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, T, 8)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, S), jnp.int32),
        jnp.ones((1, S), jnp.int32)), rng)
    return jmodel, params, dict(model=cfg, state=model_state_from_jax(
        params), batch=_batch(cfg, 1), t=torch.tensor([500]))


def _one_forward(model, batch, t):
    model.eval()
    with torch.no_grad():
        return model(*(torch.from_numpy(batch[k]) if k != "t" else t
                       for k in ("codes", "t", "text_ids", "text_mask")))


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
    """Once rank 0 answers: one request, then the rest at once; then
    SIGTERM to rank 0.  Returns {(text, seed): (status, body)}."""
    deadline = time.monotonic() + 240
    while True:
        dead = [p for p in procs if p.poll() is not None]
        assert not dead, ("a serve rank exited:\n"
                          + dead[0].communicate()[0][-3000:])
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                break
        except OSError:
            pass
        assert time.monotonic() < deadline, "the sp2 server never answered"
        time.sleep(0.2)
    out = {SERVE_REQUESTS[0]: _post(port, dict(zip(("text", "seed"),
                                                   SERVE_REQUESTS[0])))}
    with ThreadPoolExecutor(len(SERVE_REQUESTS) - 1) as pool:
        wave_ = {r: pool.submit(_post, port, {"text": r[0], "seed": r[1]})
                 for r in SERVE_REQUESTS[1:]}
        out.update({r: f.result() for r, f in wave_.items()})
    procs[0].send_signal(signal.SIGTERM)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start both worlds and the CLI pairs, compute the references
    meanwhile, and return the ranks' results beside them."""
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    batch = next(SyntheticDataset(**DATA).batches(B))
    jmodel = JaxSingle(JaxModelConfig(**MCFG))
    params = _fill(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 8)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), jnp.int32)), rng)
    state = model_state_from_jax(params)
    key = jax.random.PRNGKey(7)
    inputs = _draws(key, batch["codes"])
    t = torch.tensor(TIMESTEPS)
    x_T = torch.from_numpy(rng.standard_normal(
        (len(TEXTS), MCFG["sample_size"], 8)).astype(np.float32))
    one_synth = Synthesizer(config=Config(model=ModelConfig(**MCFG)),
                            device="cpu", dtype=torch.float32,
                            num_inference_steps=STEPS, model_state=state)
    ids, mask = one_synth.tokenizer.encode_batch(TEXTS)
    synth_inputs = (x_T, torch.from_numpy(ids), torch.from_numpy(mask))
    prompt_state = random_init_(TTSPromptSpeaker(ModelConfig(**PROMPT)),
                                torch.Generator().manual_seed(3)).state_dict()
    prompt_synth = synth_inputs + (torch.from_numpy(rng.uniform(
        -1.0, 1.0, (len(TEXTS), PROMPT["prompt_frames"], 8)).astype(
            np.float32)),)
    edge_rng = np.random.default_rng(1)
    edges = {k: _edge(cfg, edge_rng) for k, cfg in EDGES.items()}
    spec = dict(mcfg=MCFG, train=TRAIN, data=DATA, state=state, t=t,
                inputs=inputs, ladder=LADDER, ladder_batch=_batch(LADDER, 1),
                ladder_t=torch.tensor([500]), fallback=FALLBACK,
                fallback_batch=_batch(FALLBACK, B), steps=STEPS,
                synth_inputs=synth_inputs, prompt=PROMPT,
                prompt_state=prompt_state, prompt_synth=prompt_synth,
                guidance=GUIDANCE,
                edges={k: e[2] for k, e in edges.items()})
    worlds = {}
    for name, n in (("sp2", 2), ("w4", 4)):
        (out / name).mkdir()
        torch.save(spec, out / name / "spec.pt")
        (out / name / "worker.py").write_text(_WORKER)
        worlds[name] = _start([str(out / name / "worker.py"),
                               str(out / name), name], out / name, n)
    cli_out = out / "cli"
    cli_out.mkdir()
    cfg_path = str(cli_out / "tiny.json")
    _config().to_json(cfg_path)
    synth_argv = ["--config_file", cfg_path, "--device", "cpu", "--steps",
                  "2", "--dtype", "f32", "--text", TEXTS[0], "--text",
                  TEXTS[1]]
    clis = {
        "train": _start(["-m", "prompt_tts_tpu_torch.cli.train", "--smoke",
                         "--multihost", "--sp", "2", "--device", "cpu",
                         "--log_dir", str(cli_out / "log"), "--ckpt_dir",
                         str(cli_out / "ck")], cli_out, 2, torchrun=True),
        "synthesize": _start(["-m", "prompt_tts_tpu_torch.cli.synthesize",
                              "--multihost", "--sp", "2", "--out",
                              str(cli_out / "sp.wav")] + synth_argv,
                             cli_out, 2, torchrun=True),
    }
    serve_port = _free_port()
    clis["serve"] = _start(
        ["-m", "prompt_tts_tpu_torch.cli.serve", "--multihost", "--sp", "2",
         "--backend", "gloo", "--port", str(serve_port)] + SERVE_ARGV
        + ["--config_file", cfg_path], cli_out, 2, torchrun=True)
    procs = [p for ps in list(worlds.values()) + list(clis.values())
             for p in ps]
    try:
        ref = {"spec": spec, "out": out, "cli_out": cli_out}
        # JAX: the one-device forward and the loss's value and gradients
        # (the two compiles overlap: XLA releases the interpreter lock)
        jbatch = {k: jnp.asarray(batch[k])
                  for k in ("codes", "text_ids", "text_mask")}
        loss_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(
            jmodel.apply, jax_schedule())))
        def jax_forward(model, params, batch):
            return np.asarray(jax.jit(model.apply)(
                params, *(jnp.asarray(batch[k])
                          for k in ("codes", "t", "text_ids", "text_mask"))))

        with ThreadPoolExecutor(1) as pool:
            fwd = pool.submit(jax_forward, jmodel, params,
                              dict(jbatch, t=jnp.asarray(TIMESTEPS)))
            edge_fwd = {k: pool.submit(jax_forward, m, p, dict(
                e["batch"], t=jnp.asarray(e["t"].numpy())))
                for k, (m, p, e) in edges.items()}
            jloss, jgrads = loss_fn(params, jbatch, key)
            ref["jax_forward"] = fwd.result()
            ref["jax_edge"] = {k: f.result() for k, f in edge_fwd.items()}
        ref["jax_loss"] = float(jloss)
        ref["jax_grad"] = model_state_from_jax(
            jax.tree.map(np.asarray, jgrads))
        # the port in one process
        ds = SyntheticDataset(**DATA)
        tr = Trainer(_config(), ds, log_dir=str(out / "one"), device="cpu",
                     init_state=state)
        ref["one_forward"] = _one_forward(tr.model, batch, t)
        grads = []
        apply = tr.state.apply_gradients

        def snapshot():
            grads.append({n: p.grad.clone() for n, p in
                          zip(tr.state.names, tr.state.params)})
            return apply()
        tr.state.apply_gradients = snapshot
        m = tr.train_step(next(ds.batches(B)), **inputs)
        ref["one"] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "grad": grads[0]}
        ladder = random_init_(TTSSingleSpeaker(ModelConfig(**LADDER)),
                              torch.Generator().manual_seed(4))
        ref["one_ladder"] = _one_forward(ladder, spec["ladder_batch"],
                                         spec["ladder_t"])
        ref["one_edge"] = {}
        for k, (_, _, e) in edges.items():
            one = TTSSingleSpeaker(ModelConfig(**e["model"]))
            one.load_state_dict(e["state"])
            ref["one_edge"][k] = _one_forward(one, e["batch"], e["t"])
        fallback = random_init_(TTSSingleSpeaker(ModelConfig(**FALLBACK)),
                                torch.Generator().manual_seed(6))
        ref["one_fallback"] = _one_forward(fallback, spec["fallback_batch"],
                                           t)
        ref["one_latents"] = one_synth.denoise_latents(*synth_inputs)
        ref["one_prompt_latents"] = Synthesizer(
            config=Config(model=ModelConfig(**PROMPT)), device="cpu",
            dtype=torch.float32, num_inference_steps=STEPS,
            model_state=prompt_state, guidance_scale=GUIDANCE,
        ).denoise_latents(*prompt_synth)
        from prompt_tts_tpu_torch.cli.synthesize import main as synthesize
        ref["one_cli"] = synthesize(["--out", str(cli_out / "one.wav")]
                                    + synth_argv)
        ref["served"] = _served(serve_port, clis["serve"])
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


def _ranks(run, world):
    """The ranks' results of one world's case."""
    if world == "sp2":
        return [r["sp2"] for r in run["sp2"]]
    return [r[world] for r in run["w4"]]


def _joined_forward(ranks):
    """The whole batch's forward: each data row's output (equal on the
    ranks of the row), in data order."""
    rows = {}
    for r in ranks:
        d = r["place"]["data"][0]
        if d in rows:
            assert torch.equal(rows[d], r["forward"])
        rows[d] = r["forward"]
    return torch.cat([rows[d] for d in sorted(rows)]).numpy()


def _whole_grad(ranks):
    """The whole gradient of the first data row's ranks (a tp2 group's
    slices joined)."""
    row = [r for r in ranks if r["place"]["data"][0] == 0
           and r["place"]["seq"][0] == 0]
    row.sort(key=lambda r: r["place"]["model"][0])
    if len(row) == 1:
        return row[0]["grad"]
    return gather_state([r["grad"] for r in row], _shapes())


WORLDS = ["sp2", "sp4", "dp2sp2", "tp2sp2"]
PLACES = {"sp2": (1, 1, 2), "sp4": (1, 1, 4), "dp2sp2": (2, 1, 2),
          "tp2sp2": (1, 2, 2)}


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_lay_out(run, world):
    """World rank w sits at data w // (tp sp), model (w // sp) % tp, seq
    w % sp, and no rank loaded JAX."""
    D, M, S = PLACES[world]
    for w, res in enumerate(_ranks(run, world)):
        assert res["place"] == {"world": w, "data": (w // (M * S), D),
                                "model": ((w // S) % M, M),
                                "seq": (w % S, S)}
    for name in ("sp2", "w4"):
        for res in run[name]:
            assert res["jax_free"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_jax_and_one_process(run, world):
    """The seq-sharded forward (both levels on the ring at 32 and 16 frames)
    within 2e-5 of JAX's one-device forward and of the port's one
    process."""
    ranks = _ranks(run, world)
    out = _joined_forward(ranks)
    np.testing.assert_allclose(out, run["jax_forward"], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(out, run["one_forward"].numpy(),
                               atol=FWD_ATOL, rtol=0)
    for r in ranks:
        assert r["forward_tqs"] == [16, 32]


@pytest.mark.parametrize("world", WORLDS)
def test_step_matches_jax_and_one_process(run, world):
    """One train step on JAX's draws: the loss within 1e-4 and the gradient
    norm within 1e-3 (relative) of the port's one process and of JAX's
    one-device loss; every gradient, through the SGD update it makes at lr
    1e-3, within rtol 2e-3 / atol 5e-8 of both; the ring rang in the step
    (its backward on the merged lse)."""
    ranks = _ranks(run, world)
    one = run["one"]
    jax_norm = float(np.sqrt(sum(float((g.double() ** 2).sum())
                                 for g in run["jax_grad"].values())))
    for r in ranks:
        assert r["loss"] == pytest.approx(one["loss"], rel=LOSS_RTOL)
        assert r["loss"] == pytest.approx(run["jax_loss"], rel=LOSS_RTOL)
        assert r["grad_norm"] == pytest.approx(one["grad_norm"],
                                               rel=GRAD_NORM_RTOL)
        assert r["grad_norm"] == pytest.approx(jax_norm, rel=GRAD_NORM_RTOL)
        assert r["step_tqs"] == [16, 32]
    grad = _whole_grad(ranks)
    lr = TRAIN["learning_rate"]
    for name, want in (("one", one["grad"]), ("jax", run["jax_grad"])):
        assert set(want) >= set(grad)
        for k, g in grad.items():
            np.testing.assert_allclose(
                lr * g.numpy(), lr * want[k].numpy(), rtol=UPDATE_RTOL,
                atol=UPDATE_ATOL, err_msg=f"{name} {k}")


def test_indivisible_lengths_fall_back(run):
    """``sample_size`` 50 at sp 4: no level (50, 25) divides, so nothing
    rings and every rank runs the whole model, as one process does, bit for
    bit."""
    for r in run["w4"]:
        res = r["fallback"]
        assert res["place"]["seq"] == (r["sp4"]["place"]["seq"][0], 4)
        assert res["tqs"] == []
        assert torch.equal(res["forward"], run["one_fallback"])


def test_ladder_rings_at_900_and_450_only(run):
    """The flagship's 900/450/225/113 ladder at thin channels, sp 2: the
    levels of 900 and 450 run sharded and ring, 225 and 113 run whole
    (JAX's fallback at odd lengths), and the forward is one process's
    within 2e-5."""
    for r in run["sp2"]:
        res = r["ladder"]
        assert res["plan"] == [True, True, False, False]
        assert res["tqs"] == [450, 900]
        np.testing.assert_allclose(res["forward"].numpy(),
                                   run["one_ladder"].numpy(), atol=FWD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", list(EDGES))
def test_whole_level_before_sharded_one(run, case):
    """A whole level followed by a sharded one (1100/550/275/138 at sp 2,
    60/30/15/8 at sp 4): the downsampler into the sharded level runs its
    convolution on the whole level and slices its output, and the
    upsampler out of it gathers; with the average pool and the
    conv-transpose upsample (56/28/14/7 at sp 4), the pool of an odd
    slice gathers and the transpose out of a whole level slices.  The
    forward within 2e-5 of JAX's one-device forward and of the port's one
    process."""
    ranks = run["sp2"] if case == "sp2" else run["w4"]
    for r in ranks:
        res = r["edge"][case]
        assert res["plan"] == EDGE_PLANS[case]
        assert res["tqs"] == EDGE_TQS[case]
        np.testing.assert_allclose(res["forward"].numpy(),
                                   run["one_edge"][case].numpy(),
                                   atol=FWD_ATOL, rtol=0)
        np.testing.assert_allclose(res["forward"].numpy(),
                                   run["jax_edge"][case], atol=FWD_ATOL,
                                   rtol=0)


def test_sp2_synthesis_latents(run):
    """``Synthesizer`` over a seq group of 2, f32, 4 DDIM steps: the
    flagship's latents, and the prompt family's under guidance (scale 2,
    the null branch doubling the batch), within 2e-4 of one process's;
    equal on both ranks."""
    a, b = run["sp2"]
    assert a["sp"] == b["sp"] == 2
    for key, one in (("latents", "one_latents"),
                     ("prompt_latents", "one_prompt_latents")):
        assert torch.equal(a[key], b[key])
        np.testing.assert_allclose(a[key].numpy(), run[one].numpy(),
                                   atol=LATENT_TOL, rtol=0)


def test_sp2_checkpoint_restores_bit_equal(run):
    """A checkpoint written by a seq group of 2 (2 steps, EMA) holds the
    one-rank layout: it restores in one process bit for bit (parameters,
    AdamW moments, EMA), and its model state loads strictly."""
    a, b = run["sp2"]
    saved = a["saved"]["state"]
    assert a["saved"]["step"] == b["saved"]["step"] == 2
    ck = str(run["out"] / "sp2" / "ck")
    sd, step = CheckpointManager(ck).read_model_state()
    assert step == 2
    TTSSingleSpeaker(ModelConfig(**MCFG)).load_state_dict(sd, strict=True)
    tr = Trainer(_config(ema_decay=0.5), SyntheticDataset(**DATA),
                 log_dir=str(run["out"] / "one_restore"), device="cpu",
                 ckpt_dir=ck)
    assert tr.restore_latest() == 2
    one = tr.state.state_dict()
    for part in ("model", "ema"):
        for k, v in saved[part].items():
            assert torch.equal(one[part][k], v), (part, k)
            assert torch.equal(b["saved"]["state"][part][k], v), (part, k)
    for idx, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(one["optimizer"]["state"][idx][k], v)


def test_export_refuses_sp_synthesizer(run):
    for res in run["sp2"]:
        assert res["export"].startswith("cannot export a "
                                        "seq-group-sharded Synthesizer")


def test_sharded_dropout_keeps_slices_of_one_mask():
    """Each rank of a seq group (and of a model group) keeps its slice of
    the one mask drawn for the whole layer from the same generator state:
    time slice by seq rank, channel slice by model rank."""
    h = torch.ones(2, 6, 8)
    whole = torch.empty(2, 12, 16, dtype=torch.bool).bernoulli_(
        0.9, generator=torch.Generator().manual_seed(0))
    for s in range(2):
        for m in range(2):
            torch.manual_seed(0)
            got = sharded_dropout(h, 0.1, tp=TPGroup(None, m, 2),
                                  seq=SeqGroup(None, s, 2, (0, 1)))
            assert torch.equal(got != 0,
                               whole[:, s * 6:(s + 1) * 6, m * 8:(m + 1) * 8])
            assert torch.allclose(got[got != 0], torch.tensor(1 / 0.9))


def test_cli_train_sp2(run):
    """``cli.train --smoke --multihost --sp 2 --device cpu``: both ranks exit
    0; rank 0 logged finite losses and wrote a checkpoint that loads in one
    process."""
    with open(run["cli_out"] / "log" / "metrics.jsonl") as f:
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


def test_cli_synthesize_sp2(run):
    """``cli.synthesize --multihost --sp 2`` (random seeded weights, f32,
    2 DDIM steps, two texts): rank 0 wrote one wav a text, each the one-
    process CLI's PCM within one step; both ranks logged the synthesis."""
    _, wavs, _ = run["one_cli"]
    for i, wav in enumerate(wavs):
        got = _read_wav(run["cli_out"] / f"sp_{i}.wav")
        want = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(
            np.int32)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    logs = run["cli_logs"]["synthesize"]
    assert all("synthesized 2 utterance(s)" in log for log in logs)


def test_cli_serve_sp2(run):
    """``cli.serve --multihost --sp 2 --backend gloo`` (f32, 2 DDIM steps,
    batch 1): rank 0 answered one request and two at once, each the
    one-process program's PCM within one step; SIGTERM drained rank 0,
    which released rank 1 after the warmup's 2 denoises and the 3
    requests'; both exited 0."""
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
    assert f"rank 0 shut down after {2 + len(SERVE_REQUESTS)} denoises" in \
        follow
