"""Export the synthesis program as an AOT deployment artifact:
``python -m prompt_tts_tpu_torch.cli.export_program``.

Port of ``prompt_tts_tpu/cli/export_program.py``.  Builds a
``Synthesizer`` on a checkpoint's weights (random without one) and
exports its condition, step and finish programs with ``torch.export``
into one file (``prompt_tts_tpu_torch/aot.py``).  A serving box then runs
``aot.SynthesisProgram(artifact).synthesize(texts)`` with no model code,
config or checkpoint present.  ``--device`` and ``--dtype`` take the place
of the JAX CLI's ``--platforms``: the artifact runs on the device type it
was exported on.  The artifact is single-device: ``aot.export_synthesis``
refuses a ``Synthesizer`` sharded over a model group (``--tp``) or a seq
group (``--sp``), as the JAX package refuses a meshed one.

  python -m prompt_tts_tpu_torch.cli.export_program --out synth_b8.ptts \
      --check
  python -m prompt_tts_tpu_torch.cli.export_program --out synth_b4.ptts \
      --batch 4 --config_file prompt.json --ckpt_dir ckpt --ema \
      --codec_params codec.pt --sampler dpm --steps 25 --guidance_scale 3
"""

import argparse
import logging
import os

import torch

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export the synthesis program as an AOT artifact "
                    "(PyTorch port).")
    p.add_argument("--out", required=True,
                   help="Artifact output path (e.g. synth_b8.ptts).")
    p.add_argument("--batch", type=int, default=8,
                   help="Static batch size to export at.")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="The port's checkpoint directory (cli.train "
                        "--ckpt_dir); random weights if omitted (smoke).")
    p.add_argument("--ema", action="store_true",
                   help="Export the EMA params (requires --ema_decay "
                        "training).")
    p.add_argument("--codec_params", type=str, default=None,
                   help="Codec weights: a port state dict (torch.save), "
                        "as cli.convert_codec writes it.")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--float32", action="store_true",
                   help="Export the float32-wav program instead of the "
                        "device-quantized int16 PCM serving program.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to export on; the artifact runs there.")
    p.add_argument("--dtype", choices=tuple(_DTYPES), default="bf16",
                   help="Denoiser compute dtype (the codec decodes in f32).")
    p.add_argument("--check", action="store_true",
                   help="Reload the artifact and verify it reproduces "
                        "the live program's output bit-for-bit.")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.ema and not args.ckpt_dir:
        raise SystemExit("--ema requires --ckpt_dir")

    import numpy as np

    from prompt_tts_tpu_torch import aot
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer, codes_to_latents

    cfg = Config.from_json(args.config_file) if args.config_file else Config()
    model_state = None
    if args.ckpt_dir:
        from prompt_tts_tpu_torch.cli._common import restore_model_state
        model_state, _ = restore_model_state(args.ckpt_dir, cfg,
                                             ema=args.ema)
    codec_state = (torch.load(args.codec_params, map_location="cpu",
                              weights_only=True)
                   if args.codec_params else None)
    synth = Synthesizer(
        config=cfg, device=args.device, dtype=_DTYPES[args.dtype],
        num_inference_steps=args.steps, sampler=args.sampler,
        guidance_scale=args.guidance_scale, model_state=model_state,
        codec_state=codec_state)

    header = aot.export_synthesis(synth, args.batch, args.out,
                                  pcm16=not args.float32)
    logging.info("wrote %s (%.1f MB, device=%s, batch=%d, %s-%d%s; export "
                 "%.1f s, save %.1f s)", args.out,
                 os.path.getsize(args.out) / 1e6, header["device"],
                 args.batch, header["sampler"],
                 header["num_inference_steps"],
                 ", pcm16" if header["pcm16"] else "",
                 header["seconds"]["export"], header["seconds"]["save"])

    if args.check:
        prog = aot.SynthesisProgram(args.out)
        texts = ["export check"] * args.batch
        kw_prog, kw_live = {}, {}
        if header["prompted"]:
            # mid-scale constant prompt at the exact static prompt length,
            # so live (codes -> latents) and artifact (latents directly)
            # see identical conditioning
            codes = np.full((args.batch, cfg.model.in_channels,
                             cfg.model.prompt_frames), 512, np.int32)
            kw_live = {"prompt_codes": codes}
            kw_prog = {"prompt_latents": codes_to_latents(
                torch.from_numpy(codes)).numpy()}
        got, got_codes = prog.synthesize(texts, seed=0, return_codes=True,
                                         **kw_prog)
        want, want_codes = synth.synthesize(texts, seed=0,
                                            pcm16=header["pcm16"],
                                            return_codes=True, **kw_live)
        if not (np.array_equal(got, want)
                and np.array_equal(got_codes, want_codes)):
            raise SystemExit("artifact output differs from live program")
        logging.info("check OK: artifact matches the live program "
                     "bit-for-bit")
    return header


if __name__ == "__main__":
    main()
