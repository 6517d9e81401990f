"""Export a port checkpoint to the reference's torch format:
``python -m prompt_tts_tpu_torch.cli.export_checkpoint``.

The port of ``prompt_tts_tpu/cli/export_checkpoint.py``, the inverse of
``synthesize --ref_ckpt`` / ``train --init_from_ref``: reads the latest
checkpoint the port's trainer wrote in ``--ckpt_dir`` (its parameters, or
with ``--ema`` their EMA) and writes a ``ckpt_N.pt`` that the original
repo's ``TTSSingleSpeaker`` loads with a strict ``load_state_dict``
(reference train.py:139-144 save format).  Only the single-speaker family
exports: the reference has no prompt conditioning to receive the prompt
encoder's parameters.

This is host work with no device compute, as the JAX CLI's is: the
checkpoint is read with ``map_location="cpu"`` and there is no
``--device`` flag.

  python -m prompt_tts_tpu_torch.cli.export_checkpoint --ckpt_dir ckpt \\
      --out ckpt_99.pt [--ema] [--config_file cfg.json]
"""

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export a port checkpoint as a reference torch "
                    "ckpt_N.pt.")
    p.add_argument("--ckpt_dir", required=True,
                   help="Trained model checkpoint dir (the port's).")
    p.add_argument("--out", required=True,
                   help="Output path (e.g. ckpt_99.pt).")
    p.add_argument("--ema", action="store_true",
                   help="Export the EMA params (requires training with "
                        "--ema_decay).")
    p.add_argument("--config_file", type=str, default=None,
                   help="Model config JSON the checkpoint was trained "
                        "with (defaults match the reference).")
    return p.parse_args(argv)


def main(argv=None):
    """Write the file; returns the number of tensors written."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.models.export import save_reference_checkpoint

    cfg = Config.from_json(args.config_file) if args.config_file else Config()
    if cfg.model.prompt_conditioning:
        raise SystemExit(
            "export: the reference model is single-speaker only; a "
            "prompt-conditioned checkpoint has no torch counterpart")
    state, step = restore_model_state(args.ckpt_dir, cfg, ema=args.ema)
    n = save_reference_checkpoint(state, cfg.model, args.out)
    logging.info("wrote %s (%d tensors, step %d%s)", args.out, n, step,
                 ", EMA" if args.ema else "")
    return n


if __name__ == "__main__":
    main()
