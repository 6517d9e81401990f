"""Wav tar -> EnCodec code tar on PyTorch (the port's encode entry point).

Port of ``prompt_tts_tpu/cli/generate_codes.py``: streams wavs from a tar,
takes the first channel, resamples to 24 kHz, zero-pads every clip to
``--max_duration`` seconds (default 12 -> 900 frames), batch-encodes at
6 kbps, and writes ``<id>.npy`` ``[8, 900]`` int64 + ``<id>.len.txt`` (the
true frame count ceil(samples/320), as a float) plus all ``.txt`` members
into ``<input>_processed.tar``.  The repo holds no codec weights, so
without ``--codec_params`` (a port state dict, see ``convert_codec``) the
codec is random, drawn from a seeded generator.

  python -m prompt_tts_tpu_torch.cli.generate_codes --input_file wavs.tar
"""

import argparse
import io
import logging
import math
import tarfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Generate codec codes for a wav tar (PyTorch port).")
    p.add_argument("--input_file", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_duration", type=int, default=12,
                   help="Pad/truncate every clip to this many seconds.")
    p.add_argument("--codec_params", type=str, default=None,
                   help="Codec weights: a port state dict (torch.save).")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def iter_batches(tf, members, batch_size, max_duration, sample_rate=24000):
    """Yield (wavs [B, max_samples], names, frame_lengths)."""
    import numpy as np

    from prompt_tts_tpu_torch.utils.resample import resample
    from prompt_tts_tpu_torch.utils.wav import read_wav

    max_samples = sample_rate * max_duration
    wavs, names, lengths = [], [], []
    for member in members:
        if not member.name.endswith(".wav"):
            continue
        audio, sr = read_wav(io.BytesIO(tf.extractfile(member).read()))
        audio = audio[:, 0]  # mono (first channel, as the reference does)
        if sr != sample_rate:
            audio = resample(audio, sr, sample_rate)
        audio = audio[:max_samples]
        lengths.append(int(math.ceil(len(audio) / 320)))
        names.append(member.name)
        padded = np.zeros(max_samples, np.float32)
        padded[: len(audio)] = audio
        wavs.append(padded)
        if len(wavs) == batch_size:
            yield np.stack(wavs), names, lengths
            wavs, names, lengths = [], [], []
    if wavs:
        yield np.stack(wavs), names, lengths


def _add(tf, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def main(argv=None):
    """Write the code tar; returns ``(output_file, n_items, seconds)`` with
    the host's read/resample seconds and the encode calls' seconds apart."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import numpy as np
    import torch

    from prompt_tts_tpu_torch.pipeline import CodecRunner

    codec_state = None
    if args.codec_params:
        codec_state = torch.load(args.codec_params, map_location="cpu",
                                 weights_only=True)
    else:
        logging.warning("no --codec_params: using a RANDOM codec (seeded)")
    runner = CodecRunner(args.device, codec_state)

    output_file = args.input_file.replace(".tar", "_processed.tar")
    n_items, seconds = 0, {"host_s": 0.0, "encode_s": 0.0}
    with tarfile.open(args.input_file, "r") as tf, \
            tarfile.open(output_file, "w") as out_tf:
        members = tf.getmembers()
        batches = iter_batches(tf, members, args.batch_size,
                               args.max_duration)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            seconds["host_s"] += time.perf_counter() - t0
            if batch is None:
                break
            wavs, names, lengths = batch
            t0 = time.perf_counter()
            codes = runner.encode(wavs).cpu().numpy()  # [B, 8, frames]
            seconds["encode_s"] += time.perf_counter() - t0
            for i, code in enumerate(codes):
                stem = names[i].split("/")[-1][: -len(".wav")]
                buf = io.BytesIO()
                np.save(buf, code.astype(np.int64))
                _add(out_tf, f"{stem}.npy", buf.getvalue())
                _add(out_tf, f"{stem}.len.txt", str(float(lengths[i])).encode())
                n_items += 1
        # copy transcripts through
        for member in members:
            if member.name.endswith(".txt"):
                _add(out_tf, member.name.split("/")[-1],
                     tf.extractfile(member).read())
    logging.info("wrote %s (%d utterances; host read/resample %.3f s, "
                 "encode %.3f s)", output_file, n_items, seconds["host_s"],
                 seconds["encode_s"])
    return output_file, n_items, seconds


if __name__ == "__main__":
    main()
