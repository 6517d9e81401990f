"""LJSpeech metadata -> per-utterance transcript tar:
``python -m prompt_tts_tpu_torch.cli.extract_transcript``.

The port's copy of ``prompt_tts_tpu/cli/extract_transcript.py`` (host
code, the same):

    python -m prompt_tts_tpu_torch.cli.extract_transcript \
        --input_file LJSpeech-1.1.tar.bz2 --output_file lj.tar

Mirror of reference data_preparation/extract_transcript.py:8-40: reads
``LJSpeech-1.1/metadata.csv`` (pipe-delimited: id|text|normalized) from the
corpus tar(.bz2), writes ``<id>.txt`` + ``<id>.normalized.txt`` members and
copies the wavs into a new uncompressed tar (no pandas dependency).
"""

import argparse
import csv
import io
import tarfile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract LJSpeech transcripts.")
    p.add_argument("--input_file", type=str, required=True,
                   help="LJSpeech tar(.bz2) containing metadata.csv + wavs.")
    p.add_argument("--output_file", type=str, default=None,
                   help="Output tar (default: input with .bz2 stripped).")
    return p.parse_args(argv)


def _add_text(tf: tarfile.TarFile, name: str, text: str) -> None:
    data = text.encode("utf-8")
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def main(argv=None):
    args = parse_args(argv)
    output = args.output_file or args.input_file.replace(".bz2", "")
    if output == args.input_file:
        raise SystemExit("output would overwrite input; pass --output_file")

    mode = "r:bz2" if args.input_file.endswith(".bz2") else "r"
    n_rows = 0
    with tarfile.open(args.input_file, mode) as src, \
            tarfile.open(output, "w") as dst:
        meta_member = next(
            m for m in src.getmembers() if m.name.endswith("metadata.csv"))
        meta = src.extractfile(meta_member).read().decode("utf-8")
        for row in csv.reader(io.StringIO(meta), delimiter="|",
                              quoting=csv.QUOTE_NONE):
            if not row:
                continue
            file_name = row[0]
            text = row[1] if len(row) > 1 else ""
            text_norm = row[2] if len(row) > 2 else text
            text = text or text_norm
            text_norm = text_norm or text
            _add_text(dst, f"{file_name}.txt", text)
            _add_text(dst, f"{file_name}.normalized.txt", text_norm)
            n_rows += 1
        for member in src.getmembers():
            if member.name.endswith(".wav"):
                dst.addfile(member, src.extractfile(member))
    print(f"wrote {output} ({n_rows} transcripts)")


if __name__ == "__main__":
    main()
