"""Text -> 24 kHz wav on PyTorch (the port's synthesis entry point).

Runs either model family (a config with ``prompt_conditioning`` builds the
prompt-conditioned model, which takes ``--prompt_wav``) with the DDIM or
DPM-Solver++ sampler and optional classifier-free guidance.  The model's
weights come from the port's own checkpoint (``--ckpt_dir``, the trained
parameters or with ``--ema`` their average; ``--config_file`` must be the
config it was trained under) or from a reference-repo ``ckpt_N.pt``
(``--ref_ckpt``); the codec's from a port codec state dict
(``--codec_params``, as ``cli.convert_codec`` writes it).  What is not
given is random, drawn from seeded generators, and the output is noise.
``--long`` takes one ``--text`` of any length, synthesizes it window by
window (``Synthesizer.synthesize_long``) and writes one wav.  ``--tp N``
with ``--multihost`` (under torchrun or the ``PTTS_*`` variables, N
processes) shards the denoiser over the N ranks of one model group
(``parallel/tp.py``), and ``--sp M`` its latent time over M ranks
(``parallel/sp.py``; the world is N x M ranks): every rank runs the same
synthesis, and rank 0 writes.

  python -m prompt_tts_tpu_torch.cli.synthesize --text "Hello." --out x.wav \
      --ckpt_dir ckpt --ema --codec_params codec.pt
  python -m prompt_tts_tpu_torch.cli.synthesize --text "Hello." --out x.wav \
      --config_file prompt.json --ckpt_dir ckpt --codec_params codec.pt \
      --prompt_wav voice.wav --sampler dpm --steps 25 --guidance_scale 3
  python -m prompt_tts_tpu_torch.cli.synthesize --long --crossfade_ms 20 \
      --text "A passage of several sentences. ..." --out long.wav
  torchrun --nproc_per_node 2 -m prompt_tts_tpu_torch.cli.synthesize \
      --multihost --tp 2 --text "Hello." --out x.wav
  torchrun --nproc_per_node 2 -m prompt_tts_tpu_torch.cli.synthesize \
      --multihost --sp 2 --backend gloo --text "Hello." --out x.wav
"""

import argparse
import logging
import os
import time

import torch

from prompt_tts_tpu_torch.cli._common import (
    add_parallel_args, check_one_block, check_parallel_flags,
)

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Synthesize speech from text "
                                            "(PyTorch port).")
    p.add_argument("--text", action="append", default=None,
                   help="Text to speak (repeatable for a batch).")
    p.add_argument("--text_file", type=str, default=None,
                   help="File with one utterance per line (alternative to "
                        "--text; blank lines skipped).")
    p.add_argument("--out", type=str, required=True,
                   help="Output wav path (index appended for batches).")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="The port's checkpoint directory (cli.train "
                        "--ckpt_dir); its latest step is loaded.")
    p.add_argument("--ema", action="store_true",
                   help="Sample from the checkpoint's EMA params "
                        "(requires training with --ema_decay).")
    p.add_argument("--ref_ckpt", type=str, default=None,
                   help="Reference torch checkpoint (ckpt_N.pt from the "
                        "original repo's train.py), converted on the fly.")
    p.add_argument("--codec_params", type=str, default=None,
                   help="Codec weights: a port state dict (torch.save), "
                        "as cli.convert_codec writes it.")
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
    p.add_argument("--trim", action="store_true",
                   help="Trim trailing silence (energy-based; the model "
                        "always generates the full padded duration).")
    p.add_argument("--long", action="store_true",
                   help="Long-form mode: split the (single) --text into "
                        "sentence-packed chunks, synthesize in batches, "
                        "trim each chunk, concatenate into one wav.")
    p.add_argument("--crossfade_ms", type=float, default=0.0,
                   help="Long-form seam treatment: equal-power crossfade "
                        "of this many milliseconds at every window join "
                        "(0 = hard concatenation).")
    p.add_argument("--continuity_prompt", action="store_true",
                   help="Long-form, prompt-conditioned family only: "
                        "condition each window on the previous window's "
                        "generated tail codes (sequential windows).")
    add_parallel_args(p, "Run as one rank of a process group (torchrun or "
                         "the PTTS_* variables), for --tp and --sp; the "
                         "world is one model x seq group.")
    return p.parse_args(argv)


def _texts(args):
    if args.text_file:
        if args.text:
            raise SystemExit("pass --text or --text_file, not both")
        with open(args.text_file) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
        if not texts:
            raise SystemExit(f"{args.text_file} has no utterances")
        return texts
    if not args.text:
        raise SystemExit("one of --text / --text_file is required")
    return args.text


def main(argv=None):
    """Write one wav per text; returns ``(paths, wavs, codes)`` (the wavs
    before ``--trim``; with ``--long`` one joined wav and no codes)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    texts = _texts(args)
    if args.long and len(texts) != 1:
        raise SystemExit("--long takes exactly one --text")
    if args.ema and not args.ckpt_dir:
        raise SystemExit("--ema requires --ckpt_dir (EMA params live in "
                         "checkpoints produced by train --ema_decay)")
    if args.ckpt_dir and args.ref_ckpt:
        raise SystemExit("pass --ckpt_dir or --ref_ckpt, not both")
    check_parallel_flags(args)
    if not args.multihost:
        return _synthesize(args, texts, args.device)
    from prompt_tts_tpu_torch.parallel import init_distributed
    device = init_distributed(args.device, backend=args.backend,
                              n_model=args.tp, n_seq=args.sp)
    try:
        check_one_block(args)
        return _synthesize(args, texts, device)
    finally:
        torch.distributed.destroy_process_group()


def _synthesize(args, texts, device):
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.parallel import world_rank
    from prompt_tts_tpu_torch.utils.wav import (
        trim_trailing_silence, write_wav,
    )
    from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE, Synthesizer

    config = (Config.from_json(args.config_file) if args.config_file
              else Config())
    model_state = None
    if args.ref_ckpt:
        from prompt_tts_tpu_torch.models.convert import load_reference_state
        model_state = load_reference_state(args.ref_ckpt)
        logging.info("converted reference checkpoint %s", args.ref_ckpt)
    elif args.ckpt_dir:
        from prompt_tts_tpu_torch.cli._common import restore_model_state
        model_state, _ = restore_model_state(args.ckpt_dir, config,
                                             ema=args.ema)
    else:
        logging.warning("no --ckpt_dir or --ref_ckpt given: using RANDOM "
                        "model weights (output is noise)")
    codec_state = None
    if args.codec_params:
        codec_state = torch.load(args.codec_params, map_location="cpu",
                                 weights_only=True)
        logging.info("loaded codec params from %s", args.codec_params)
    else:
        logging.warning("no --codec_params given: using RANDOM codec "
                        "weights (output is noise)")
    synth = Synthesizer(config=config, device=device,
                        dtype=_DTYPES[args.dtype],
                        num_inference_steps=args.steps, sampler=args.sampler,
                        guidance_scale=args.guidance_scale,
                        model_state=model_state, codec_state=codec_state)
    prompt_wav = None
    if args.prompt_wav:
        import numpy as np
        from prompt_tts_tpu_torch.utils.wav import read_wav
        audio, sr = read_wav(args.prompt_wav)
        if sr != SAMPLE_RATE:
            from prompt_tts_tpu_torch.utils.resample import resample
            audio = resample(audio, sr, SAMPLE_RATE)
        prompt_wav = np.tile(audio[None, :, 0], (len(texts), 1))
    t0 = time.perf_counter()
    if args.long:
        wav = synth.synthesize_long(texts[0], seed=args.seed,
                                    prompt_wav=prompt_wav,
                                    crossfade_ms=args.crossfade_ms,
                                    continuity_prompt=args.continuity_prompt)
        if world_rank() == 0:
            write_wav(args.out, wav, SAMPLE_RATE)
        logging.info("wrote %s (%.2f s, %d chunks) in %.3f s", args.out,
                     len(wav) / SAMPLE_RATE,
                     len(synth.split_long_text(texts[0])),
                     time.perf_counter() - t0)
        return [args.out], [wav], None
    wavs, codes = synth.synthesize(texts, seed=args.seed,
                                   return_codes=True, prompt_wav=prompt_wav)
    logging.info("synthesized %d utterance(s) in %.3f s", len(wavs),
                 time.perf_counter() - t0)

    base, ext = os.path.splitext(args.out)
    paths = []
    for i, wav in enumerate(wavs):
        if args.trim:
            wav = trim_trailing_silence(wav)
        path = args.out if len(wavs) == 1 else f"{base}_{i}{ext}"
        if world_rank() == 0:
            write_wav(path, wav, SAMPLE_RATE)
            logging.info("wrote %s (%.2f s)", path, len(wav) / SAMPLE_RATE)
        paths.append(path)
    return paths, wavs, codes


if __name__ == "__main__":
    main()
