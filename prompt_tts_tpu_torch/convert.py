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
  LSTM l{n}_w_ih / l{n}_w_hh / l{n}_b, the codebooks and the prompt
  encoder's learned queries [K, dim]: as they are

Input trees are nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them, with or without the
top-level ``"params"`` collection.  A leaf no rule consumes raises here;
a missing or mis-shaped one raises in ``load_state_dict(strict=True)``.

``opt_state_from_jax`` carries an optax train state's AdamW moments over
by the same rules, so a JAX run resumes in the port.
"""

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_AS_IS = re.compile(r"l\d+_(w_ih|w_hh|b)|codebooks|queries")


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
    """``TTSSingleSpeaker`` or ``TTSPromptSpeaker`` params (JAX) -> the
    port's state_dict of the same class."""
    return _convert(tree)


def codec_state_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """``EncodecCodec`` params (JAX) -> the port's ``EncodecCodec``
    state_dict: encoder, decoder and codebooks."""
    return _convert(tree)


def _find_adam(tree) -> Optional[object]:
    """The first node with ``mu``, ``nu`` and ``count`` (optax's
    ``ScaleByAdamState``) in an optax state: nested tuples, named tuples
    (``MultiStepsState``, ``MaskedState``) and dicts."""
    if all(hasattr(tree, a) for a in ("mu", "nu", "count")):
        return tree
    if isinstance(tree, Mapping):
        children = tree.values()
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return None
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state, state) -> None:
    """Load the AdamW moments and update count of an optax state (the
    ``clip_by_global_norm`` + ``adamw`` chain of ``make_optimizer``, maybe
    inside ``MultiSteps``; leaves as numpy arrays) into the port's
    ``train.state.TrainState``: ``mu`` -> ``exp_avg``, ``nu`` ->
    ``exp_avg_sq``, ``count`` -> ``step`` and ``update_count``."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) found")
    mu, nu = _convert(adam.mu), _convert(adam.nu)
    count = int(np.asarray(adam.count))
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    sd = opt.state_dict()
    new_state, idx = {}, 0
    for group in opt.param_groups:
        for p in group["params"]:
            n = name_of[id(p)]
            # copies: from_numpy shares the caller's buffers, and AdamW
            # updates its moments in place
            new_state[idx] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu[n].reshape(p.shape).clone(),
                              "exp_avg_sq": nu[n].reshape(p.shape).clone()}
            idx += 1
    unused = set(mu) - set(name_of.values())
    if unused:
        raise ValueError(f"optax moments with no parameter: {sorted(unused)}")
    sd["state"] = new_state
    opt.load_state_dict(sd)
    state.update_count = count
