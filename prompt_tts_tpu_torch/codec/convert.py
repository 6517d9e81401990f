"""torch EnCodec weights -> the port's ``EncodecCodec`` state_dict.

Counterpart of ``prompt_tts_tpu/codec/convert.py``.  It reads the state
dict of a ``transformers.EncodecModel`` (``facebook/encodec_24khz``'s
layout, plain tensors, as ``torch.load`` gives it) and does not import
transformers.  The port's submodules carry the torch layer indices
(``encoder.layers.3`` -> ``encoder.layer_3``), so only names change and
weight norm is folded:

  {enc,de}coder.layers.{i}.conv            -> {enc,de}coder.layer_{i}.conv
  ... .block.{1,3}.conv / .shortcut.conv   -> .block_{1,3}.conv / .shortcut.conv
  weight norm (g, v), either spelling      -> weight = g * v / |v|
    (weight_g / weight_v, or parametrizations.weight.original0 / original1)
  ... .lstm.weight_ih_l{n} / weight_hh_l{n} -> .l{n}_w_ih / .l{n}_w_hh
  ... .lstm.bias_ih_l{n} + bias_hh_l{n}    -> .l{n}_b (torch adds both)
  quantizer.layers.{q}.codebook.embed      -> codebooks[q]

The codebooks' k-means state (``inited``, ``cluster_size``, ``embed_avg``)
is training state that encode and decode never read; it is consumed and
dropped.  A key no rule consumes raises here; a missing or mis-shaped one
raises in ``load_state_dict(strict=True)``.
"""

import re
from typing import Dict, Mapping

import torch

_SEANET = re.compile(
    r"(encoder|decoder)\.layers\.(\d+)\.(?:(block\.\d+\.|shortcut\.)?conv\."
    r"(bias|weight_g|weight_v|parametrizations\.weight\.original[01])"
    r"|lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+))")
_CODEBOOK = re.compile(
    r"quantizer\.layers\.(\d+)\.codebook\.(embed|inited|cluster_size|"
    r"embed_avg)")
_NORM_PART = {"weight_g": "g", "parametrizations.weight.original0": "g",
              "weight_v": "v", "parametrizations.weight.original1": "v"}
_LSTM = {"weight_ih": "w_ih", "weight_hh": "w_hh"}


def codec_state_from_encodec(
        state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``transformers.EncodecModel`` state dict -> the port's
    ``EncodecCodec`` state_dict (f32)."""
    state: Dict[str, torch.Tensor] = {}
    norms: Dict[str, Dict[str, torch.Tensor]] = {}
    biases: Dict[str, Dict[str, torch.Tensor]] = {}
    codebooks: Dict[int, torch.Tensor] = {}
    unconsumed = []
    for key, value in state_dict.items():
        value = value.detach().float()
        m = _SEANET.fullmatch(key)
        if m:
            side, i, sub, leaf, lstm_leaf, n = m.groups()
            prefix = f"{side}.layer_{i}"
            if lstm_leaf in _LSTM:
                state[f"{prefix}.l{n}_{_LSTM[lstm_leaf]}"] = value
            elif lstm_leaf:
                biases.setdefault(f"{prefix}.l{n}_b", {})[lstm_leaf] = value
            else:
                if sub:
                    prefix += "." + sub.rstrip(".").replace(".", "_")
                if leaf == "bias":
                    state[f"{prefix}.conv.bias"] = value
                else:
                    norms.setdefault(f"{prefix}.conv.weight", {})[
                        _NORM_PART[leaf]] = value
            continue
        m = _CODEBOOK.fullmatch(key)
        if m:
            if m.group(2) == "embed":
                codebooks[int(m.group(1))] = value
            continue
        unconsumed.append(key)
    if unconsumed:
        raise ValueError(f"EnCodec keys with no conversion rule: {unconsumed}")
    for name, parts in norms.items():
        if set(parts) != {"g", "v"}:
            raise ValueError(f"{name}: weight norm needs both g and v, got "
                             f"{sorted(parts)}")
        # torch's own fold (what the weight-norm parametrization computes):
        # v * g / |v|, the norm over every dim but 0
        state[name] = torch._weight_norm(parts["v"], parts["g"], 0)
    for name, parts in biases.items():
        if set(parts) != {"bias_ih", "bias_hh"}:
            raise ValueError(f"{name}: the LSTM needs bias_ih and bias_hh, "
                             f"got {sorted(parts)}")
        state[name] = parts["bias_ih"] + parts["bias_hh"]
    if sorted(codebooks) != list(range(len(codebooks))):
        raise ValueError(f"codebook layers {sorted(codebooks)} are not "
                         f"0..n-1")
    if codebooks:
        state["codebooks"] = torch.stack([codebooks[q]
                                          for q in range(len(codebooks))])
    return state
