"""Corpus sequence-length probe (equivalent of reference tts/get_cmu.py):
``python -m prompt_tts_tpu_torch.cli.max_seq_len --input lj.tar``.

The port's copy of ``prompt_tts_tpu/cli/max_seq_len.py``, on the port's
``frontend.tokenizer``.

Reports the max/percentile interspersed-CMU-id lengths over a corpus so
``--max_seq_length`` / ``cmu_seq_len`` can be set tightly (the reference
derived its 550 default this way, get_cmu.py:14-27).

Input: an LJSpeech-style metadata CSV (``id|text|normalized``), a plain
text file (one utterance per line), or a transcript tar
(``*.normalized.txt`` / ``*.txt`` members).
"""

import argparse
import io
import tarfile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Probe CMU sequence lengths.")
    p.add_argument("--input", type=str, required=True,
                   help="metadata.csv, text file, or transcript tar")
    return p.parse_args(argv)


def iter_texts(path):
    if path.endswith(".tar"):
        with tarfile.open(path, "r") as tf:
            names = set(tf.getnames())
            norm = sorted(n for n in names if n.endswith(".normalized.txt"))
            plain = sorted(n for n in names if n.endswith(".txt")
                           and not n.endswith(".normalized.txt")
                           and not n.endswith(".len.txt"))
            use = norm or plain
            for n in use:
                yield tf.extractfile(n).read().decode()
    elif path.endswith(".csv"):
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 3 and parts[2]:
                    yield parts[2]
                elif len(parts) >= 2:
                    yield parts[1]
    else:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield line.strip()


def main(argv=None):
    args = parse_args(argv)
    from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer

    tok = Tokenizer()
    lengths = sorted(len(tok.ids(t)) for t in iter_texts(args.input))
    if not lengths:
        raise SystemExit("no texts found")
    n = len(lengths)
    pct = lambda q: lengths[min(int(q * n), n - 1)]
    print(f"utterances: {n}")
    print(f"max interspersed CMU length: {lengths[-1]}")
    print(f"p50={pct(0.5)} p90={pct(0.9)} p99={pct(0.99)}")


if __name__ == "__main__":
    main()
