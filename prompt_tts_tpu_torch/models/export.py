"""The port's state dict -> reference (torch/diffusers-0.15) checkpoint.

The port's copy of ``prompt_tts_tpu/models/export.py`` (numpy only; the
port imports nothing of the JAX package), composed with
``prompt_tts_tpu_torch.convert.model_state_to_jax``: a
``TTSSingleSpeaker`` state dict trained by the port goes to the JAX param
tree, then onto the raw ``state_dict`` naming the reference's
``train.py`` saves (reference train.py:139-144, ``ckpt_{epoch}.pt``), so
the original torch repo loads it with
``model.load_state_dict(torch.load("ckpt_N.pt"))``.  The inverse of
``models/convert.py``.

Two state-dict entries exist in the reference model but have no
counterpart here and are synthesized for strict-load compatibility:

* ``text_encoder.pos_embedding.penc.inv_freq`` -- a deterministic buffer
  (reference tts/models.py:27-29: ``1/10000^(arange(0,C,2)/C)`` with
  ``C = ceil(seq_len/2)*2``; the module is constructed with
  ``channels = seq_len``, the transposed pos-emb quirk,
  tts/models.py:116), recomputed from the config.
* each spatial transformer's ``proj_out.{weight,bias}`` -- the layer the
  reference builds but never applies on the continuous path
  (tts/ldm/transformer_1d.py:188-190,275-279; the quirk is kept, the
  model has no such parameters).  Exported as zeros of the right shape:
  any value is dead in the reference forward.

Every leaf of the tree must be consumed by the mapping; leftovers (the
prompt-conditioned family's parameters, and the UNet's optional variants'
``time_proj/weight``, ``class_embedding/*`` and conv-transpose
``up_I/upsample/{kernel,bias}``, which the reference's saved models never
contain) raise with their paths rather than exporting a partial
checkpoint.  (The JAX module reaches the conv-transpose upsample first and
raises a ``KeyError`` for its missing ``conv`` leaf.)

Layout transforms (exact inverses of convert.py):
  Dense kernel [in,out] -> Linear weight [out,in]
  Conv  kernel [k,in,out] -> Conv1d weight [out,in,k]
  Dense-as-proj_in kernel [in,out] -> Conv1d k1 weight [out,in,1]
  LayerNorm/GroupNorm scale -> weight
  Embed embedding -> Embedding weight
"""

from typing import Dict, Tuple

import numpy as np


class _Walker:
    """Nested-tree reader that records which leaf paths were consumed."""

    def __init__(self, tree: Dict):
        self.tree = tree
        self.consumed = set()

    def node(self, path: Tuple[str, ...]):
        n = self.tree
        for k in path:
            if not isinstance(n, dict) or k not in n:
                return None
            n = n[k]
        return n

    def has(self, path: Tuple[str, ...]) -> bool:
        return self.node(path) is not None

    def take(self, path: Tuple[str, ...]) -> np.ndarray:
        leaf = self.node(path)
        if leaf is None or isinstance(leaf, dict):
            raise KeyError("/".join(path))
        self.consumed.add(path)
        return np.asarray(leaf)

    def leftovers(self):
        out = []

        def rec(n, path):
            if isinstance(n, dict):
                for k, v in n.items():
                    rec(v, path + (k,))
            elif path not in self.consumed:
                out.append("/".join(path))

        rec(self.tree, ())
        return sorted(out)


def _linear(sd, prefix, w, path):
    sd[prefix + ".weight"] = np.ascontiguousarray(
        w.take(path + ("kernel",)).T)
    if w.has(path + ("bias",)):
        sd[prefix + ".bias"] = w.take(path + ("bias",))


def _conv1d(sd, prefix, w, path):
    k = w.take(path + ("conv", "kernel"))  # [k, in, out]
    sd[prefix + ".weight"] = np.ascontiguousarray(k.transpose(2, 1, 0))
    if w.has(path + ("conv", "bias")):
        sd[prefix + ".bias"] = w.take(path + ("conv", "bias"))


def _norm(sd, prefix, w, path, wrap=False):
    p = path + (("norm",) if wrap else ())
    sd[prefix + ".weight"] = w.take(p + ("scale",))
    sd[prefix + ".bias"] = w.take(p + ("bias",))


def _basic_block(sd, prefix, w, path):
    _norm(sd, f"{prefix}.norm1", w, path + ("norm1",))
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.attn1.{name}", w, path + ("attn1", name))
    _linear(sd, f"{prefix}.attn1.to_out.0", w, path + ("attn1", "to_out"))
    if w.has(path + ("attn2",)):
        _norm(sd, f"{prefix}.norm2", w, path + ("norm2",))
        for name in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{prefix}.attn2.{name}", w, path + ("attn2", name))
        _linear(sd, f"{prefix}.attn2.to_out.0", w,
                path + ("attn2", "to_out"))
    _norm(sd, f"{prefix}.norm3", w, path + ("norm3",))
    _linear(sd, f"{prefix}.ff.net.0.proj", w, path + ("ff", "proj"))
    _linear(sd, f"{prefix}.ff.net.2", w, path + ("ff", "out"))


def _spatial_transformer(sd, prefix, w, path):
    _norm(sd, f"{prefix}.norm", w, path + ("norm",), wrap=True)
    k = w.take(path + ("proj_in", "kernel"))  # Dense [in_ch, inner]
    sd[f"{prefix}.proj_in.weight"] = np.ascontiguousarray(k.T)[:, :, None]
    sd[f"{prefix}.proj_in.bias"] = w.take(path + ("proj_in", "bias"))
    # proj_out: built but never applied by the reference
    # (transformer_1d.py:275-279) — zeros, shaped Conv1d(inner -> in_ch)
    sd[f"{prefix}.proj_out.weight"] = np.zeros(
        (k.shape[0], k.shape[1], 1), np.float32)
    sd[f"{prefix}.proj_out.bias"] = np.zeros((k.shape[0],), np.float32)
    i = 0
    while w.has(path + (f"block_{i}",)):
        _basic_block(sd, f"{prefix}.transformer_blocks.{i}", w,
                     path + (f"block_{i}",))
        i += 1


def _resnet(sd, prefix, w, path):
    _norm(sd, f"{prefix}.norm1", w, path + ("norm1",), wrap=True)
    _conv1d(sd, f"{prefix}.conv1", w, path + ("conv1",))
    _linear(sd, f"{prefix}.time_emb_proj", w, path + ("time_emb_proj",))
    _norm(sd, f"{prefix}.norm2", w, path + ("norm2",), wrap=True)
    _conv1d(sd, f"{prefix}.conv2", w, path + ("conv2",))
    if w.has(path + ("conv_shortcut",)):
        _conv1d(sd, f"{prefix}.conv_shortcut", w, path + ("conv_shortcut",))


def _inv_freq(seq_len: int) -> np.ndarray:
    # reference tts/models.py:24-29 with channels = seq_len (the module is
    # PositionalEncodingPermute1D(seq_len) — transposed quirk, :116)
    channels = int(np.ceil(seq_len / 2) * 2)
    return (1.0 / (10000.0 ** (np.arange(0, channels, 2, dtype=np.float32)
                               / channels))).astype(np.float32)


def export_tree(params: Dict, cfg_model) -> Dict:
    """JAX-layout param tree -> reference-named numpy state dict.

    ``params`` is the tree ``convert.model_state_to_jax`` gives (with or
    without the top-level ``"params"`` wrapper).  ``cfg_model`` is the
    :class:`~prompt_tts_tpu_torch.config.ModelConfig` the model was built
    with (needed only for the synthesized ``inv_freq`` buffer).
    """
    tree = params.get("params", params)
    w = _Walker(tree)
    sd: Dict = {}

    # --- text encoder ---
    sd["text_encoder.word_embedding.weight"] = w.take(
        ("text_encoder", "word_embedding", "embedding"))
    sd["text_encoder.pos_embedding.penc.inv_freq"] = _inv_freq(
        cfg_model.cmu_seq_len)
    i = 0
    while w.has(("text_encoder", f"block_{i}")):
        _basic_block(sd, f"text_encoder.transformer_blocks.{i}", w,
                     ("text_encoder", f"block_{i}"))
        i += 1

    # --- unet top ---
    _conv1d(sd, "unet.conv_in", w, ("unet", "conv_in"))
    _linear(sd, "unet.time_embedding.linear_1", w,
            ("unet", "time_embedding", "linear_1"))
    _linear(sd, "unet.time_embedding.linear_2", w,
            ("unet", "time_embedding", "linear_2"))

    # --- down / up blocks ---
    for our, ref in (("down", "down_blocks"), ("up", "up_blocks")):
        b = 0
        while w.has(("unet", f"{our}_{b}")):
            path = ("unet", f"{our}_{b}")
            base = f"unet.{ref}.{b}"
            j = 0
            while w.has(path + (f"resnet_{j}",)):
                _resnet(sd, f"{base}.resnets.{j}", w, path + (f"resnet_{j}",))
                if w.has(path + (f"attn_{j}",)):
                    _spatial_transformer(sd, f"{base}.attentions.{j}", w,
                                         path + (f"attn_{j}",))
                j += 1
            sampler = "downsample" if our == "down" else "upsample"
            ref_sampler = "downsamplers" if our == "down" else "upsamplers"
            # the conv-transpose upsample (no "conv" child) has no
            # reference-checkpoint counterpart: its leaves stay leftovers
            if w.has(path + (sampler, "conv")):
                _conv1d(sd, f"{base}.{ref_sampler}.0.conv", w,
                        path + (sampler, "conv"))
            b += 1

    # --- mid block ---
    j = 0
    while w.has(("unet", "mid", f"resnet_{j}")):
        _resnet(sd, f"unet.mid_block.resnets.{j}", w,
                ("unet", "mid", f"resnet_{j}"))
        j += 1
    j = 0
    while w.has(("unet", "mid", f"attn_{j}")):
        _spatial_transformer(sd, f"unet.mid_block.attentions.{j}", w,
                             ("unet", "mid", f"attn_{j}"))
        j += 1

    # --- output head ---
    _norm(sd, "unet.conv_norm_out", w, ("unet", "conv_norm_out"), wrap=True)
    _conv1d(sd, "unet.conv_out", w, ("unet", "conv_out"))

    left = w.leftovers()
    if left:
        raise ValueError(
            "params contain entries with no reference-checkpoint "
            "counterpart (prompt-conditioned family or optional embedding "
            "variants cannot be exported — the reference model has no such "
            f"modules): {left[:8]}{' ...' if len(left) > 8 else ''}")
    return sd


def export_reference_state_dict(state, cfg_model) -> Dict:
    """The port's ``TTSSingleSpeaker`` state dict -> the reference's numpy
    state dict.  A prompt-conditioned config's state raises (its prompt
    encoder has no reference counterpart)."""
    from prompt_tts_tpu_torch.convert import model_state_to_jax
    return export_tree(model_state_to_jax(state, cfg_model), cfg_model)


def save_reference_checkpoint(state, cfg_model, path: str) -> int:
    """Export the port's state dict and ``torch.save`` a reference-loadable
    ``ckpt_N.pt``.  Returns the number of state-dict entries written."""
    import torch

    sd = export_reference_state_dict(state, cfg_model)
    torch.save({k: torch.from_numpy(
        np.array(v, dtype=np.float32, copy=True)) for k, v in sd.items()},
        path)
    return len(sd)
