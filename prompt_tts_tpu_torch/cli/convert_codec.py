"""EnCodec weights -> a port codec state dict (``torch.save``).

Port of ``prompt_tts_tpu/cli/convert_codec.py`` without transformers:
``--torch_state`` reads a ``transformers.EncodecModel`` state dict saved
with ``torch.save`` (``facebook/encodec_24khz``'s layout) and folds its
weight norm (``codec/convert.py``); ``--random`` draws a codec from a
seeded generator, as the CLIs do without weights.

  python -m prompt_tts_tpu_torch.cli.convert_codec --torch_state sd.pt --out codec.pt
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert EnCodec torch weights (PyTorch port).")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--torch_state", type=str,
                     help="A transformers EncodecModel state dict "
                          "(torch.save).")
    src.add_argument("--random", action="store_true",
                     help="Random codec weights (seeded).")
    p.add_argument("--out", type=str, required=True,
                   help="Output state dict path.")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    """Write the port state dict; returns it."""
    args = parse_args(argv)
    import torch

    from prompt_tts_tpu_torch.codec.convert import codec_state_from_encodec
    from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
    from prompt_tts_tpu_torch.pipeline import random_init_

    codec = EncodecCodec()
    if args.torch_state:
        state = codec_state_from_encodec(torch.load(
            args.torch_state, map_location="cpu", weights_only=True))
        codec.load_state_dict(state, strict=True)
    else:
        random_init_(codec, torch.Generator().manual_seed(args.seed))
    state = codec.state_dict()
    torch.save(state, args.out)
    print(f"wrote {args.out}")
    return state


if __name__ == "__main__":
    main()
