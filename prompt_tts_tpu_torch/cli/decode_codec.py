"""Codes (.npy) -> wav on PyTorch: ``python -m prompt_tts_tpu_torch.cli.decode_codec``.

Port of ``prompt_tts_tpu/cli/decode_codec.py``: loads a ``[B?, 8, T]`` code
matrix, decodes it with the codec (f32), and writes ``<input>.wav`` at
24 kHz (the first item of a batch).  Without ``--codec_params`` (a port
state dict) the codec is random, drawn from a seeded generator.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert codec codes back to waveform (PyTorch port).")
    p.add_argument("--npy_path", required=True,
                   help="Path to codec code matrix (.npy).")
    p.add_argument("--codec_params", type=str, default=None,
                   help="Codec weights: a port state dict (torch.save).")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Write the wav; returns its path."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE, CodecRunner
    from prompt_tts_tpu_torch.utils.wav import write_wav

    codes = np.load(args.npy_path)
    if codes.ndim == 2:
        codes = codes[None]
    if codes.ndim != 3:
        raise SystemExit("codes must be [B, n_q, T] or [n_q, T]")

    codec_state = None
    if args.codec_params:
        codec_state = torch.load(args.codec_params, map_location="cpu",
                                 weights_only=True)
    runner = CodecRunner(args.device, codec_state)
    wav = runner.decode(codes.astype(np.int64)).cpu().numpy()
    out = args.npy_path.replace(".npy", ".wav")
    write_wav(out, wav[0], SAMPLE_RATE)
    print(f"wrote {out} ({wav.shape[-1] / SAMPLE_RATE:.2f} s)")
    return out


if __name__ == "__main__":
    main()
