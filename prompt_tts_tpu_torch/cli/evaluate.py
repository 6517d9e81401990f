"""Checkpoint evaluation: ``python -m prompt_tts_tpu_torch.cli.evaluate``.

The port of ``prompt_tts_tpu/cli/evaluate.py``.  It scores a checkpoint the
port's trainer wrote on a held-out corpus:

* ``eval_loss`` -- the deterministic eps-MSE (dropout off) over the
  dataset with a fixed noise and timestep stream for each batch index: a
  generator seeded from ``(seed, i)`` (``train/step.py:eval_generator``,
  as ``Trainer.evaluate``), so numbers compare across checkpoints and
  runs.
* ``timestep_profile`` -- the same loss with every example noised to each
  timestep of a fixed grid (the batch's noise again): low t tracks fine
  detail, high t coarse structure.

The model runs in f32 (TF32 off) on ``--device`` (``cuda`` unless the
caller asks for ``cpu``): the attention and resnet kernels' f32 paths on
the card.  The prompt family's batches carry prompt crops of
``prompt_frames``.  Prints a human summary, then one JSON line last.

  python -m prompt_tts_tpu_torch.cli.evaluate --data_file held_out.tar \\
      --ckpt_dir ckpt [--ema] [--config_file cfg.json] [--max_batches 8]
"""

import argparse
import json
import logging

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained checkpoint.")
    p.add_argument("--data_file", required=True,
                   help="Held-out corpus tar (same format as train).")
    p.add_argument("--ckpt_dir", required=True,
                   help="Trained model checkpoint dir (the port's).")
    p.add_argument("--ema", action="store_true",
                   help="Evaluate the EMA params.")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=None,
                   help="Defaults to the config's train batch size.")
    p.add_argument("--max_seq_length", type=int, default=None,
                   help="Text id length (defaults to the config's "
                        "cmu_seq_len; they must match the model).")
    p.add_argument("--streaming", action="store_true",
                   help="Lazy tar reads (corpora beyond RAM).")
    p.add_argument("--max_batches", type=int, default=0,
                   help="Evaluate at most N batches (0 = all).")
    p.add_argument("--timesteps", type=str, default="50,250,500,750,950",
                   help="Comma-separated timestep grid for the profile "
                        "(empty string disables it).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def batch_losses(model, schedule, batch, grid, generator=None, noise=None,
                 timesteps=None, grid_noise=None):
    """``(eval loss, [loss at t for t in grid])`` of one device batch, as
    device scalars.  The noise, then the timesteps, come from
    ``generator`` unless given; the grid reuses the noise unless
    ``grid_noise`` is given."""
    from prompt_tts_tpu_torch.train.step import (
        _draw, make_eval_step, make_eval_step_at,
    )
    noise, timesteps = _draw(batch["codes"], schedule.num_train_timesteps,
                             generator, noise, timesteps)
    loss = make_eval_step(model, schedule)(batch, noise=noise,
                                           timesteps=timesteps)
    at = make_eval_step_at(model, schedule)
    gn = noise if grid_noise is None else grid_noise
    return loss, [at(batch, None, t, noise=gn) for t in grid]


def main(argv=None):
    """Evaluate; returns the result dict it prints."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import numpy as np
    import torch

    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import cast_compute_
    from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.pipeline import full_f32
    from prompt_tts_tpu_torch.train.step import eval_generator

    cfg = Config.from_json(args.config_file) if args.config_file else Config()
    grid = [int(t) for t in args.timesteps.split(",") if t.strip()]
    bad = [t for t in grid if not 0 <= t < cfg.train.num_train_timesteps]
    if bad:
        raise SystemExit(f"--timesteps outside [0, "
                         f"{cfg.train.num_train_timesteps}): {bad}")
    state, step = restore_model_state(args.ckpt_dir, cfg, ema=args.ema)

    # prompted configs: batches must carry a speaker-prompt crop
    pf = (cfg.model.prompt_frames
          if cfg.model.prompt_conditioning else None)
    seq_len = args.max_seq_length or cfg.model.cmu_seq_len
    if args.streaming:
        from prompt_tts_tpu_torch.data.streaming import StreamingCodeDataset
        dataset = StreamingCodeDataset(args.data_file,
                                       max_seq_length=seq_len,
                                       prompt_frames=pf)
    else:
        from prompt_tts_tpu_torch.data.dataset import CodeDataset
        dataset = CodeDataset(args.data_file, max_seq_length=seq_len,
                              prompt_frames=pf)

    device = torch.device(args.device)
    model_cls = (TTSPromptSpeaker if cfg.model.prompt_conditioning
                 else TTSSingleSpeaker)
    model = model_cls(cfg.model, device=device)
    model.load_state_dict(state, strict=True)
    del state
    # f32 weights, the resnet kernel's packed once
    cast_compute_(model.eval(), torch.float32)
    schedule = linear_schedule(cfg.train.num_train_timesteps, device=device)

    batch_size = args.batch_size or cfg.train.batch_size
    keys = ("codes", "text_ids", "text_mask", "prompt")
    total, n = 0.0, 0
    prof = [0.0] * len(grid)
    batches = dataset.batches(batch_size)
    try:
        with full_f32():
            for i, batch in enumerate(batches):
                if args.max_batches and i >= args.max_batches:
                    break
                dev_batch = {k: torch.from_numpy(np.asarray(batch[k])).to(
                    device) for k in keys if k in batch}
                loss, at = batch_losses(
                    model, schedule, dev_batch, grid,
                    eval_generator(device, args.seed, i))
                total += float(loss)
                for j, v in enumerate(at):
                    prof[j] += float(v)
                n += 1
    finally:
        batches.close()     # a streaming dataset's reader thread stops
    if n == 0:
        raise SystemExit(
            f"dataset yielded no batches at batch_size={batch_size}")

    result = {
        "eval_loss": total / n,
        "num_batches": n,
        "batch_size": batch_size,
        "step": step,
        "params": "ema" if args.ema else "raw",
    }
    if grid:
        result["timestep_profile"] = {
            str(t): prof[j] / n for j, t in enumerate(grid)}
    log.info("eval loss %.6f over %d batches (checkpoint step %d%s)",
             result["eval_loss"], n, step, ", EMA" if args.ema else "")
    for j, t in enumerate(grid):
        log.info("  t=%4d  loss %.6f", t, prof[j] / n)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
