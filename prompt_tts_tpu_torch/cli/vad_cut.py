"""VAD corpus segmentation: ``python -m prompt_tts_tpu_torch.cli.vad_cut``.

The port's copy of ``prompt_tts_tpu/cli/vad_cut.py`` (reference
cut_by_vad.py:167-184), over the port's ``data/vad_cut.py``:

    python -m prompt_tts_tpu_torch.cli.vad_cut --input_dir books.tar \
        --n_workers 8 --state_dir .
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Cut a dataset into short sequences using VAD files.")
    p.add_argument("--input_dir", type=str, required=True,
                   help="Input tar of (json, flac/wav) pairs.")
    p.add_argument("--n_workers", type=int, default=8)
    p.add_argument("--state_dir", type=str, default=".",
                   help="Where ignore/error lists live (resumability).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from prompt_tts_tpu_torch.data.vad_cut import cut_corpus
    n_ok, n_err = cut_corpus(args.input_dir, args.n_workers, args.state_dir)
    print(f"segmented {n_ok} items ({n_err} errors)")


if __name__ == "__main__":
    main()
