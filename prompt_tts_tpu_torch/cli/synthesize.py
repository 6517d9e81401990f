"""Text -> 24 kHz wav on PyTorch (the port's synthesis entry point).

Runs either model family (a config with ``prompt_conditioning`` builds the
prompt-conditioned model, which takes ``--prompt_wav``) with the DDIM or
DPM-Solver++ sampler and optional classifier-free guidance.  The repo holds
no checkpoint or codec weights, so the model and codec weights are random,
drawn from seeded generators: the output is noise, for driving the path.

  python -m prompt_tts_tpu_torch.cli.synthesize --text "Hello." --out x.wav
  python -m prompt_tts_tpu_torch.cli.synthesize --text "Hello." --out x.wav \
      --config_file prompt.json --prompt_wav voice.wav --sampler dpm \
      --steps 25 --guidance_scale 3
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
                   help="Sampler inference steps.")
    p.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim",
                   help="ddim (the reference's 50-step configuration) or dpm "
                        "(DPM-Solver++(2M): ~20-25 steps suffice).")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="Classifier-free guidance scale (>1 needs a model "
                        "trained with cond_dropout_prob>0; both families).")
    p.add_argument("--prompt_wav", type=str, default=None,
                   help="Reference-audio prompt (a wav, resampled to 24 kHz "
                        "if needed) for a prompt-conditioned model; every "
                        "--text gets the same prompt.")
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
                        num_inference_steps=args.steps, sampler=args.sampler,
                        guidance_scale=args.guidance_scale)
    prompt_wav = None
    if args.prompt_wav:
        import numpy as np
        from prompt_tts_tpu_torch.utils.wav import read_wav
        audio, sr = read_wav(args.prompt_wav)
        if sr != SAMPLE_RATE:
            from prompt_tts_tpu_torch.utils.resample import resample
            audio = resample(audio, sr, SAMPLE_RATE)
        prompt_wav = np.tile(audio[None, :, 0], (len(args.text), 1))
    t0 = time.perf_counter()
    wavs, codes = synth.synthesize(args.text, seed=args.seed,
                                   return_codes=True, prompt_wav=prompt_wav)
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
