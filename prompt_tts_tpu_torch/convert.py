"""JAX param trees -> the port's ``state_dict``s.

The port's submodules are named after the JAX param tree, so a leaf at
``unet/down_0/attn_0/block_0/attn1/to_q/kernel`` becomes
``unet.down_0.attn_0.block_0.attn1.to_q.weight`` and only the layout
changes:

  Dense kernel [in,out]          -> Linear weight [out,in]
  Conv kernel [k,in,out]         -> Conv1d weight [out,in,k]
  ConvTranspose kernel [k,out,in] -> ConvTranspose1d weight [in,out,k]
                                    (the inverse of prompt_tts_tpu/codec/
                                    convert.py:_convt_params)
  LayerNorm/GroupNorm scale      -> weight
  Embed embedding                -> weight
  LSTM l{n}_w_ih / l{n}_w_hh / l{n}_b and the codebooks: as they are

Input trees are nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them, with or without the
top-level ``"params"`` collection.  A leaf no rule consumes raises here;
a missing or mis-shaped one raises in ``load_state_dict(strict=True)``.
"""

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_AS_IS = re.compile(r"l\d+_(w_ih|w_hh|b)|codebooks")


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _convert(tree: dict) -> Dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    state, unconsumed = {}, []
    for path, arr in _leaves(tree):
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 3:
            name, arr = "weight", arr.transpose(2, 1, 0)
        elif leaf in ("scale", "embedding"):
            name = "weight"
        elif leaf == "bias" or _AS_IS.fullmatch(leaf):
            name = leaf
        else:
            unconsumed.append("/".join(path))
            continue
        state[".".join(mods + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    if unconsumed:
        raise ValueError(f"JAX leaves with no conversion rule: {unconsumed}")
    return state


def model_state_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """``TTSSingleSpeaker`` params (JAX) -> ``TTSSingleSpeaker`` state_dict."""
    return _convert(tree)


def codec_state_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """``EncodecCodec`` params (JAX) -> the port's ``EncodecCodec``
    state_dict.  The encoder subtree is dropped by name: the port holds the
    decode side only."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return _convert({k: v for k, v in tree.items() if k != "encoder"})
