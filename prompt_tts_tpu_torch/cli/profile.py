"""Pipeline profiler: ``python -m prompt_tts_tpu_torch.cli.profile``.

The port of ``prompt_tts_tpu/cli/profile.py``.  For each stage it reports
the operations of one call, its peak device memory and, with ``--time``,
its time and its share of the card's peak rate:

* **FLOPs** -- ``torch.utils.flop_counter.FlopCounterMode`` counts the
  products PyTorch dispatches (matmuls, convolutions, their backward);
  the hand-written kernels are ``ctypes`` launches it cannot see, so each
  launch adds its operations by the formula in ``ops/cuda/opcount.py``.
  On a CPU tensor the kernels' plain versions run as PyTorch ops and are
  counted directly: one stage's count is the same on both devices.
* **Time** (``--time``) -- on the card, CUDA events around ``--chain``
  warm calls, the median of five such runs; on the CPU, wall time the
  same way.  ``pct_peak`` divides the achieved rate by ``--peak_tflops``
  (the H100 SXM's dense bf16 peak by default).
* **Peak memory** -- ``torch.cuda.max_memory_allocated`` over one warm call
  after a reset (not measured on the CPU).

Stages: ``cond`` (text encoder, and the prompt encoder for the prompt
family), ``denoise`` (one UNet eps step, as the sampler runs it: the
cross-attention k/v made once beforehand; x steps a synthesis), ``decode``
(the EnCodec decode), ``train`` (one train step: forward, backward,
clip and AdamW, bf16 over f32 parameters) and ``synth`` (the whole
device program: conditioning, the sampler's steps, rounding, decode).
The denoiser computes in bf16, the codec in f32, as ``Synthesizer`` runs
them.  Prints a human table, then one JSON line last.

  python -m prompt_tts_tpu_torch.cli.profile --stages cond,denoise,decode,\\
train,synth --time
"""

import argparse
import json
import logging
import statistics
import time

log = logging.getLogger(__name__)

STAGES = ("cond", "denoise", "decode", "train", "synth")
DEFAULT_STAGES = "cond,denoise,decode,train"
# NVIDIA's H100 SXM data sheet: dense bf16 on the tensor cores, at 700 W
H100_BF16_TFLOPS = 989.0
TIMED_RUNS = 5


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Profile pipeline stages (FLOPs, peak memory and, "
                    "with --time, time and share of peak).")
    p.add_argument("--stages", type=str, default=DEFAULT_STAGES,
                   help=f"Comma list of {','.join(STAGES)} (default "
                        f"{DEFAULT_STAGES}).")
    p.add_argument("--batch_size", type=int, default=8,
                   help="Synthesis-side batch (denoise/decode/synth/cond).")
    p.add_argument("--train_batch_size", type=int, default=None,
                   help="Train-step batch (defaults to config).")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="Profile a port checkpoint's params (optional: "
                        "the counts and times depend on the shapes, not "
                        "the values).")
    p.add_argument("--time", action="store_true",
                   help="Measure each stage's time (CUDA events on the "
                        "card, wall time on the CPU).")
    p.add_argument("--chain", type=int, default=20,
                   help="Calls a timed run (--time).")
    p.add_argument("--peak_tflops", type=float, default=H100_BF16_TFLOPS,
                   help="Peak rate for pct_peak (--time); H100 SXM dense "
                        "bf16 = 989, f32 = 67.")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def count_flops(fn) -> int:
    """The operations of one call of ``fn``: what FlopCounterMode sees plus
    the hand-written kernels' launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from prompt_tts_tpu_torch.ops.cuda.opcount import KernelOps
    with FlopCounterMode(display=False) as flops, KernelOps() as kernels:
        fn()
    return flops.get_total_flops() + kernels.total


def time_ms(fn, device, chain: int) -> float:
    """Median over :data:`TIMED_RUNS` runs of ``chain`` warm calls, ms a
    call: CUDA events on the card, wall time on the CPU."""
    import torch
    fn()
    times = []
    for _ in range(TIMED_RUNS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(chain):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / chain)
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / chain)
    return statistics.median(times)


def peak_mib(fn, device):
    """Peak device memory (MiB) over one call; None off the card."""
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**20


def stage_calls(synth, stages, B: int, train_batch: int):
    """``{stage: fn}``: a no-argument call of each stage on fixed inputs."""
    import torch

    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import set_compute_dtype_
    from prompt_tts_tpu_torch.models.unet1d import cross_attention_kv
    from prompt_tts_tpu_torch.pipeline import latents_to_codes, random_init_
    from prompt_tts_tpu_torch.train.state import TrainState
    from prompt_tts_tpu_torch.train.step import make_train_step

    cfg, dev = synth.config, synth.device
    mcfg = cfg.model
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    x = randn(B, mcfg.sample_size, mcfg.in_channels)
    t = torch.full((B,), 500, dtype=torch.long, device=dev)
    ids = torch.zeros((B, mcfg.cmu_seq_len), dtype=torch.long, device=dev)
    mask = torch.ones_like(ids)
    prompt = (randn(B, mcfg.prompt_frames, mcfg.in_channels)
              if synth.prompted else None)
    codes = torch.zeros((B, mcfg.in_channels, mcfg.sample_size),
                        dtype=torch.long, device=dev)
    model = synth.model
    with torch.no_grad():
        ctx, spk = synth._condition(ids, mask, prompt)
        # the sampler's step: the cross-attention k/v made once a synthesis
        kv = cross_attention_kv(model.unet, ctx)

    @torch.no_grad()
    def cond():
        return synth._condition(ids, mask, prompt)

    @torch.no_grad()
    def denoise():
        if synth.prompted:
            return model.denoise(x, t, ctx, spk, cross_kv=kv)
        return model.denoise(x, t, ctx, cross_kv=kv)

    def decode():
        return synth.codec_runner.decode(codes)

    def whole():
        latents = synth.denoise_latents(x, ids, mask, prompt)
        return synth.codec_runner.decode(latents_to_codes(latents))

    calls = {"cond": cond, "denoise": denoise, "decode": decode,
             "synth": whole}
    calls = {k: v for k, v in calls.items() if k in stages}
    if "train" in stages:
        # the inference model holds bf16 weights: train a fresh f32 model
        # of the config (seeded weights: the counts and times depend on
        # the shapes), computing in bf16
        train_model = type(model)(mcfg, device=dev)
        random_init_(train_model, torch.Generator().manual_seed(0))
        set_compute_dtype_(train_model, torch.bfloat16)
        state = TrainState(train_model, cfg.train, 1)
        step = make_train_step(state, linear_schedule(
            cfg.train.num_train_timesteps, device=dev),
            cond_dropout_prob=cfg.train.cond_dropout_prob)
        batch = {"codes": randn(train_batch, mcfg.sample_size,
                                mcfg.in_channels).clamp(-1, 1),
                 "text_ids": torch.zeros((train_batch, mcfg.cmu_seq_len),
                                         dtype=torch.long, device=dev),
                 "text_mask": torch.ones((train_batch, mcfg.cmu_seq_len),
                                         dtype=torch.long, device=dev)}
        if synth.prompted:
            batch["prompt"] = randn(train_batch, mcfg.prompt_frames,
                                    mcfg.in_channels)
        gen = torch.Generator(dev).manual_seed(1)
        calls["train"] = lambda: step(batch, gen)
    return calls


def main(argv=None):
    """Profile; returns the JSON result it prints last."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    bad = set(stages) - set(STAGES)
    if bad:
        raise SystemExit(f"unknown stages {sorted(bad)}; "
                         f"choose from {sorted(STAGES)}")
    cfg = Config.from_json(args.config_file) if args.config_file else Config()
    model_state = None
    if args.ckpt_dir:
        from prompt_tts_tpu_torch.cli._common import restore_model_state
        model_state, _ = restore_model_state(args.ckpt_dir, cfg)
    synth = Synthesizer(config=cfg, device=args.device,
                        model_state=model_state,
                        num_inference_steps=args.num_inference_steps,
                        sampler=args.sampler)
    device = synth.device
    calls = stage_calls(synth, stages,
                        args.batch_size,
                        args.train_batch_size or cfg.train.batch_size)

    results = {}
    for name in STAGES:
        if name not in calls:
            continue
        fn = calls[name]
        log.info("counting %s ...", name)
        row = {"gflop": count_flops(fn) / 1e9,
               "peak_mib": peak_mib(fn, device)}
        if args.time:
            log.info("timing %s (%d calls a run) ...", name, args.chain)
            ms = time_ms(fn, device, args.chain)
            row["ms"] = ms
            row["pct_peak"] = (100.0 * row["gflop"] / ms
                               / args.peak_tflops)   # GFLOP/ms = TFLOP/s
        results[name] = row

    cols = ("gflop", "peak_mib", "ms", "pct_peak")
    width = max([len(n) for n in results] + [5])
    print(f"{'stage':>{width}} | " + " | ".join(f"{c:>12}" for c in cols))
    for name, row in results.items():
        cells = [f"{row[c]:>12.4g}" if row.get(c) is not None
                 else f"{'-':>12}" for c in cols]
        print(f"{name:>{width}} | " + " | ".join(cells))
    print(f"denoise runs once per sampler step (x{args.num_inference_steps} "
          "per synthesis); cond/decode run once")
    out = {"backend": device.type,
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "batch_size": args.batch_size, "stages": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
