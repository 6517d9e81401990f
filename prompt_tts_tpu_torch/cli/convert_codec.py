"""EnCodec weights -> a port codec state dict (``torch.save``).

Port of ``prompt_tts_tpu/cli/convert_codec.py`` without transformers:
``--torch_dir`` reads a local ``transformers.EncodecModel`` checkpoint
directory (``facebook/encodec_24khz``'s layout, as ``save_pretrained``
writes it): its ``model.safetensors`` (through ``safetensors.torch``), or
else its ``pytorch_model.bin`` (``torch.load``, weights only);
``--torch_state`` reads such a state dict saved with ``torch.save``.
Either is folded by ``codec/convert.py:codec_state_from_encodec`` (the
weight norm).  ``--random`` draws a codec from a seeded generator, as the
CLIs do without weights.  Neither ``transformers`` nor ``safetensors`` is
imported unless ``--torch_dir`` needs it.

  python -m prompt_tts_tpu_torch.cli.convert_codec --torch_dir encodec_24khz --out codec.pt
  python -m prompt_tts_tpu_torch.cli.convert_codec --torch_state sd.pt --out codec.pt
"""

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert EnCodec torch weights (PyTorch port).")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--torch_dir", type=str,
                     help="A local transformers EncodecModel checkpoint "
                          "directory (model.safetensors or "
                          "pytorch_model.bin).")
    src.add_argument("--torch_state", type=str,
                     help="A transformers EncodecModel state dict "
                          "(torch.save).")
    src.add_argument("--random", action="store_true",
                     help="Random codec weights (seeded).")
    p.add_argument("--out", type=str, required=True,
                   help="Output state dict path.")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def read_torch_dir(path: str) -> dict:
    """The state dict of a ``transformers`` checkpoint directory: its
    ``model.safetensors`` where ``safetensors`` imports, else its
    ``pytorch_model.bin``."""
    import torch
    st = os.path.join(path, "model.safetensors")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        try:
            from safetensors.torch import load_file
        except ImportError:
            load_file = None
        if load_file is not None:
            return load_file(st, device="cpu")
        if not os.path.exists(binary):
            raise SystemExit(f"--torch_dir {path}: model.safetensors needs "
                             "the safetensors package, and there is no "
                             "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise SystemExit(f"--torch_dir {path}: no model.safetensors or "
                     "pytorch_model.bin")


def main(argv=None):
    """Write the port state dict; returns it."""
    args = parse_args(argv)
    import torch

    from prompt_tts_tpu_torch.codec.convert import codec_state_from_encodec
    from prompt_tts_tpu_torch.codec.encodec import EncodecCodec
    from prompt_tts_tpu_torch.pipeline import random_init_

    codec = EncodecCodec()
    if args.torch_dir or args.torch_state:
        sd = (read_torch_dir(args.torch_dir) if args.torch_dir
              else torch.load(args.torch_state, map_location="cpu",
                              weights_only=True))
        codec.load_state_dict(codec_state_from_encodec(sd), strict=True)
    else:
        random_init_(codec, torch.Generator().manual_seed(args.seed))
    state = codec.state_dict()
    torch.save(state, args.out)
    print(f"wrote {args.out}")
    return state


if __name__ == "__main__":
    main()
