"""Loss-curve parity: the port's ``Trainer`` against the JAX trainer.

Both trainers run side by side on the CPU, in f32, for ``--steps``
optimizer updates of a tiny config (dropout off): the same initial weights
(a JAX param tree drawn from a numpy seed, carried into the port by
``convert.model_state_from_jax``),
the same batches (drawn from a numpy seed), and the same noise and
timesteps (the JAX step derives them from its key; the port is handed
what that key gives, as ``tests/test_torch_train.py`` does).  The JAX side
is ``create_train_state`` + a jitted ``make_train_step`` (the optax chain of
``make_optimizer``, ``MultiSteps`` under ``--accum``, the EMA at the
update boundary); the port's is ``train.loop.Trainer.train_step``.

Reported, as one JSON line: the largest relative loss gap over the
micro-steps, and the relative L2 of the final parameters (of the EMA too
with ``--ema``), port against JAX.

Each path gets its own copy of the initial weights (a deep copy of the
numpy tree, never a shared buffer), and the shared tree is checked to be
unchanged after both ran.  ``--save`` writes this run (the step count, both
loss curves and the port's final parameters by name) to an ``.npz``;
``--ref`` compares this run against such a file, after checking that its
step count and every parameter's name and shape match this run's, and
raises a ``ValueError`` naming the mismatch otherwise.

    python tools/torch_loss_parity.py --steps 5 [--accum 2] [--ema 0.9] \\
        [--save run.npz | --ref run.npz]
"""

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# a tiny config, dropout off: a 2-level UNet with a cross-attention block
# each way, which keeps JAX's compile of the step short
CFG = dict(block_out_channels=(32, 64), cross_attention_dim=64,
           attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
           sample_size=24, layers_per_block=1, unet_num_heads=4,
           down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
           up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"),
           text_encoder_dropout=0.0)
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
             weight_decay=0.1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5,
                   help="Optimizer updates (each of --accum micro-steps).")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient_accumulation_steps on both sides.")
    p.add_argument("--ema", type=float, default=0.0,
                   help="ema_decay on both sides (0: no EMA).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", type=str, default=None,
                   help="Write this run to an .npz for a later --ref.")
    p.add_argument("--ref", type=str, default=None,
                   help="An .npz from --save to compare this run against.")
    return p.parse_args(argv)


def make_batches(n, batch, seed):
    """``n`` batches as the datasets yield them: codes in [-1, 1] ``[B, T,
    8]``, padded ids and their mask ``[B, S]``."""
    rng = np.random.default_rng(seed)
    S, T = CFG["cmu_seq_len"], CFG["sample_size"]
    out = []
    for _ in range(n):
        lens = rng.integers(4, S + 1, size=batch)
        mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
        ids = rng.integers(1, 149, (batch, S)).astype(np.int32) * mask
        codes = rng.integers(0, 1024, (batch, T, 8)).astype(np.float32)
        out.append({"codes": codes * (2 / 1023) - 1, "text_ids": ids,
                    "text_mask": mask})
    return out


def init_params(shapes, rng):
    """The initial JAX param tree of ``shapes``, numpy arrays drawn from
    ``rng``: lecun-scaled kernels, unit-normal embeddings, and non-trivial
    biases and norm scales (flax's init would make them 0 and 1)."""
    import jax

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _train_config(cls, args):
    return cls(batch_size=args.batch, gradient_accumulation_steps=args.accum,
               ema_decay=args.ema, seed=args.seed, **TRAIN)


def run_jax(params0, batches, keys, args):
    """The JAX trainer: losses a micro-step, final params (and EMA) as
    numpy trees."""
    import jax
    import jax.numpy as jnp

    from prompt_tts_tpu.config import ModelConfig, TrainConfig
    from prompt_tts_tpu.diffusion.schedule import linear_schedule
    from prompt_tts_tpu.models import TTSSingleSpeaker
    from prompt_tts_tpu.train.state import create_train_state
    from prompt_tts_tpu.train.step import make_train_step

    model = TTSSingleSpeaker(ModelConfig(**CFG))
    params = jax.tree.map(jnp.array, params0)       # this path's own copy
    state = create_train_state(model, params, _train_config(TrainConfig,
                                                            args),
                               args.steps)
    step = jax.jit(make_train_step(model.apply, linear_schedule(),
                                   ema_decay=args.ema))
    losses = []
    for batch, key in zip(batches, keys):
        state, m = step(state, batch, key)
        losses.append(float(m["loss"]))
    to_np = lambda t: jax.tree.map(np.array, t)     # noqa: E731
    return (np.asarray(losses), to_np(state.params),
            None if state.ema_params is None else to_np(state.ema_params))


def port_inputs(key, codes_shape):
    """The noise and timesteps the JAX loss derives from ``key``
    (``prompt_tts_tpu/train/step.py:73-77``), as torch tensors."""
    import jax
    import jax.numpy as jnp
    import torch
    rng_noise, rng_t, _, _ = jax.random.split(key, 4)
    noise = jax.random.normal(rng_noise, codes_shape, jnp.float32)
    t = jax.random.randint(rng_t, (codes_shape[0],), 0, 1000,
                           dtype=jnp.int32)
    return {"noise": torch.from_numpy(np.array(noise)),
            "timesteps": torch.from_numpy(np.array(t))}


def run_port(params0, batches, keys, args, log_dir):
    """The port's ``Trainer`` on the CPU: losses a micro-step, the final
    parameters (and EMA) by state-dict name."""
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    from prompt_tts_tpu_torch.convert import model_state_from_jax
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.train.loop import Trainer

    cfg = Config(model=ModelConfig(**CFG),
                 train=_train_config(TrainConfig, args))
    # this path's own copy: from_numpy shares the array it is given
    init = model_state_from_jax(copy.deepcopy(params0))
    data = SyntheticDataset(args.batch * args.steps,
                            frames=CFG["sample_size"],
                            max_seq_length=CFG["cmu_seq_len"])
    trainer = Trainer(cfg, data, log_dir, device="cpu", init_state=init)
    losses = []
    for batch, key in zip(batches, keys):
        m = trainer.train_step(batch, **port_inputs(key,
                                                    batch["codes"].shape))
        losses.append(float(m["loss"]))
    st = trainer.state
    params = {n: p.detach().numpy().copy()
              for n, p in zip(st.names, st.params)}
    ema = None if st.ema is None else {
        n: e.numpy().copy() for n, e in zip(st.names, st.ema)}
    return np.asarray(losses), params, ema


def rel_l2(got, want):
    """Relative L2 over every tensor of two ``{name: array}`` maps."""
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return float(np.sqrt(num / den))


def loss_gap(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def check_ref(ref, steps, shapes):
    """Raise ``ValueError`` naming the mismatch unless ``ref`` (a loaded
    ``--save`` file) has this run's step count and parameters' names and
    shapes (``{name: shape}``)."""
    if "steps" not in ref.files:
        raise ValueError(f"--ref holds no step count (keys {ref.files[:5]}):"
                         " not a --save file of this harness")
    if int(ref["steps"]) != steps:
        raise ValueError(f"--ref has {int(ref['steps'])} micro-steps, this "
                         f"run {steps}: rerun with the same --steps/--accum")
    names = {k[len("param/"):] for k in ref.files if k.startswith("param/")}
    missing, extra = sorted(set(shapes) - names), sorted(names - set(shapes))
    if missing or extra:
        raise ValueError(f"--ref parameters differ from this run's: missing "
                         f"{missing[:5]}, extra {extra[:5]} (another "
                         "config?)")
    wrong = [f"{k} {ref['param/' + k].shape} != {v}"
             for k, v in sorted(shapes.items())
             if ref["param/" + k].shape != tuple(v)]
    if wrong:
        raise ValueError(f"--ref parameter shapes differ: {wrong[:5]}")


def port_param_shapes():
    """``{name: shape}`` of the port's trained parameters at ``CFG``."""
    from prompt_tts_tpu_torch.config import ModelConfig
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    model = TTSSingleSpeaker(ModelConfig(**CFG), device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()
            if p.requires_grad}


def run(args, log_dir):
    """Both trainers; the result dict (also what ``main`` prints).  A
    ``--ref`` is checked against this run's step count and parameters
    before anything runs."""
    import jax

    from prompt_tts_tpu.config import ModelConfig
    from prompt_tts_tpu.models import TTSSingleSpeaker
    from prompt_tts_tpu_torch.convert import model_state_from_jax

    n = args.steps * args.accum
    ref = None
    if args.ref:
        ref = np.load(args.ref)
        check_ref(ref, n, port_param_shapes())
    batches = make_batches(n, args.batch, args.seed)
    keys = [jax.random.fold_in(jax.random.PRNGKey(args.seed), i)
            for i in range(n)]
    b0 = batches[0]
    model = TTSSingleSpeaker(ModelConfig(**CFG))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(args.seed),
                            b0["codes"], np.zeros(args.batch, np.int32),
                            b0["text_ids"], b0["text_mask"])
    params0 = init_params(shapes, np.random.default_rng(args.seed))
    pristine = copy.deepcopy(params0)

    jl, jp, je = run_jax(params0, batches, keys, args)
    pl, pp, pe = run_port(params0, batches, keys, args, log_dir)
    untouched = all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params0), jax.tree.leaves(pristine)))
    if not untouched:
        raise AssertionError("a path wrote into the shared initial weights")
    jp = {k: v.numpy() for k, v in model_state_from_jax(jp).items()}
    result = {"steps": n, "accum": args.accum, "ema": args.ema,
              "losses_port": pl.tolist(), "losses_jax": jl.tolist(),
              "max_rel_loss_gap": loss_gap(pl, jl),
              "param_rel_l2": rel_l2(pp, jp),
              "param_max_abs": max(float(np.abs(pp[k] - jp[k]).max())
                                   for k in jp)}
    if args.ema:
        je = {k: v.numpy() for k, v in model_state_from_jax(je).items()}
        result["ema_rel_l2"] = rel_l2(pe, je)
    if args.save:
        np.savez(args.save, steps=n, losses_port=pl, losses_jax=jl,
                 **{f"param/{k}": v for k, v in pp.items()})
    if ref is not None:
        result["ref_max_rel_loss_gap"] = loss_gap(pl, ref["losses_port"])
        result["ref_param_rel_l2"] = rel_l2(
            pp, {k: ref["param/" + k] for k in pp})
    return result


def main(argv=None):
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    args = parse_args(argv)
    with tempfile.TemporaryDirectory() as log_dir:
        result = run(args, log_dir)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
