"""Text -> 24 kHz wav on PyTorch (the port's synthesis entry point).

Runs the single-speaker model with the DDIM sampler.  The repo holds no
checkpoint or codec weights, so the model and codec weights are random,
drawn from seeded generators: the output is noise, for driving the path.

  python -m prompt_tts_tpu_torch.cli.synthesize --text "Hello." --out x.wav
"""

import argparse
import logging
import os
import time

import torch

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Synthesize speech from text "
                                            "(PyTorch port).")
    p.add_argument("--text", action="append", required=True,
                   help="Text to speak (repeatable for a batch).")
    p.add_argument("--out", type=str, required=True,
                   help="Output wav path (index appended for batches).")
    p.add_argument("--steps", type=int, default=50,
                   help="DDIM inference steps.")
    p.add_argument("--seed", type=int, default=0,
                   help="Seed of the initial noise x_T.")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=tuple(_DTYPES), default="bf16",
                   help="Denoiser compute dtype (the codec decodes in f32).")
    return p.parse_args(argv)


def main(argv=None):
    """Write one wav per ``--text``; returns ``(paths, wavs, codes)``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.utils.wav import write_wav
    from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE, Synthesizer

    config = Config.from_json(args.config_file) if args.config_file else None
    logging.warning("no checkpoint support yet: using RANDOM model and "
                    "codec weights (output is noise)")
    synth = Synthesizer(config=config, device=args.device,
                        dtype=_DTYPES[args.dtype],
                        num_inference_steps=args.steps)
    t0 = time.perf_counter()
    wavs, codes = synth.synthesize(args.text, seed=args.seed,
                                   return_codes=True)
    logging.info("synthesized %d utterance(s) in %.3f s", len(wavs),
                 time.perf_counter() - t0)

    base, ext = os.path.splitext(args.out)
    paths = []
    for i, wav in enumerate(wavs):
        path = args.out if len(wavs) == 1 else f"{base}_{i}{ext}"
        write_wav(path, wav, SAMPLE_RATE)
        logging.info("wrote %s (%.2f s)", path, len(wav) / SAMPLE_RATE)
        paths.append(path)
    return paths, wavs, codes


if __name__ == "__main__":
    main()
