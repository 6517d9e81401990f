"""Reference (torch/diffusers-0.15) checkpoint -> JAX-layout param tree
-> the port's state dict.

The port's own copy of ``prompt_tts_tpu/models/convert.py`` (numpy only;
the port imports nothing of the JAX package), plus
:func:`load_reference_state`, which composes it with
``prompt_tts_tpu_torch.convert.model_state_from_jax``.

The reference trains ``TTSSingleSpeaker`` and saves raw ``state_dict``s
(reference train.py:139-144: ``ckpt_{epoch}.pt``).  This converter maps
that state dict — diffusers-0.15-era module naming — onto the JAX
package's param tree (whose names the port's modules carry), so
reference-trained checkpoints run in the port directly.

Key-name map (reference module -> here):
  text_encoder.word_embedding.weight           -> text_encoder/word_embedding/embedding
  text_encoder.transformer_blocks.N.*          -> text_encoder/block_N/*
  unet.conv_in.{weight,bias}                   -> unet/conv_in/conv/*
  unet.time_embedding.linear_{1,2}.*           -> unet/time_embedding/linear_{1,2}/*
  unet.down_blocks.I.resnets.J.*               -> unet/down_I/resnet_J/*
  unet.down_blocks.I.attentions.J.*            -> unet/down_I/attn_J/*
  unet.down_blocks.I.downsamplers.0.conv.*     -> unet/down_I/downsample/conv/*
  unet.mid_block.resnets.J / attentions.J      -> unet/mid/resnet_J / attn_J
  unet.up_blocks.I.(resnets|attentions).J      -> unet/up_I/...
  unet.up_blocks.I.upsamplers.0.conv.*         -> unet/up_I/upsample/conv/*
  unet.conv_norm_out.* / unet.conv_out.*       -> unet/conv_norm_out|conv_out/*

Inside a BasicTransformerBlock (diffusers 0.15):
  attn{1,2}.to_{q,k,v}.weight                  -> attn{1,2}/to_{q,k,v}/kernel (T)
  attn{1,2}.to_out.0.{weight,bias}             -> attn{1,2}/to_out/*
  norm{1,2,3}.{weight,bias}                    -> norm{1,2,3}/{scale,bias}
  ff.net.0.proj.* / ff.net.2.*                 -> ff/proj/* / ff/out/*

Inside a Transformer1DModel:
  norm.* -> norm/norm/*; proj_in (Conv1d k1) -> proj_in (Dense);
  proj_out is DROPPED (the reference never applies it on the continuous
  path, transformer_1d.py:275-279 — quirk kept, see unet1d.py).

Tensors are torch layout: Linear [out,in] -> kernel [in,out] (transpose);
Conv1d [out,in,k] -> [k,in,out]; Conv1d k1 used as proj_in -> Dense
kernel [in,out].
"""

from typing import Dict, Tuple

import numpy as np


def _t(x):  # torch tensor / numpy -> numpy (always a copy)
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    # copy: torch .numpy() SHARES storage with the live tensor, so without
    # it the converted params would silently mutate if the torch model
    # keeps training (bit the loss-parity A/B harness)
    return np.array(x, copy=True)


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _convert_linear(sd, prefix, tree, path):
    _set(tree, path + ("kernel",), _t(sd[prefix + ".weight"]).T)
    if prefix + ".bias" in sd:
        _set(tree, path + ("bias",), _t(sd[prefix + ".bias"]))


def _convert_conv1d(sd, prefix, tree, path):
    w = _t(sd[prefix + ".weight"])  # [out, in, k]
    _set(tree, path + ("conv", "kernel"), np.ascontiguousarray(
        w.transpose(2, 1, 0)))
    if prefix + ".bias" in sd:
        _set(tree, path + ("conv", "bias"), _t(sd[prefix + ".bias"]))


def _convert_norm(sd, prefix, tree, path, wrap=False):
    p = path + (("norm",) if wrap else ())
    _set(tree, p + ("scale",), _t(sd[prefix + ".weight"]))
    _set(tree, p + ("bias",), _t(sd[prefix + ".bias"]))


def _convert_basic_block(sd, prefix, tree, path, has_cross: bool):
    _convert_norm(sd, f"{prefix}.norm1", tree, path + ("norm1",))
    for name in ("to_q", "to_k", "to_v"):
        _convert_linear(sd, f"{prefix}.attn1.{name}", tree,
                        path + ("attn1", name))
    _convert_linear(sd, f"{prefix}.attn1.to_out.0", tree,
                    path + ("attn1", "to_out"))
    if has_cross:
        _convert_norm(sd, f"{prefix}.norm2", tree, path + ("norm2",))
        for name in ("to_q", "to_k", "to_v"):
            _convert_linear(sd, f"{prefix}.attn2.{name}", tree,
                            path + ("attn2", name))
        _convert_linear(sd, f"{prefix}.attn2.to_out.0", tree,
                        path + ("attn2", "to_out"))
    _convert_norm(sd, f"{prefix}.norm3", tree, path + ("norm3",))
    _convert_linear(sd, f"{prefix}.ff.net.0.proj", tree,
                    path + ("ff", "proj"))
    _convert_linear(sd, f"{prefix}.ff.net.2", tree, path + ("ff", "out"))


def _convert_spatial_transformer(sd, prefix, tree, path):
    _convert_norm(sd, f"{prefix}.norm", tree, path + ("norm",), wrap=True)
    # proj_in is a Conv1d k1 in the reference -> Dense here
    w = _t(sd[f"{prefix}.proj_in.weight"])  # [out, in, 1]
    _set(tree, path + ("proj_in", "kernel"),
         np.ascontiguousarray(w[:, :, 0].T))
    _set(tree, path + ("proj_in", "bias"), _t(sd[f"{prefix}.proj_in.bias"]))
    # proj_out intentionally dropped (unused in the reference forward)
    i = 0
    while f"{prefix}.transformer_blocks.{i}.norm1.weight" in sd:
        _convert_basic_block(sd, f"{prefix}.transformer_blocks.{i}", tree,
                             path + (f"block_{i}",), has_cross=True)
        i += 1


def _convert_resnet(sd, prefix, tree, path):
    _convert_norm(sd, f"{prefix}.norm1", tree, path + ("norm1",), wrap=True)
    _convert_conv1d(sd, f"{prefix}.conv1", tree, path + ("conv1",))
    _convert_linear(sd, f"{prefix}.time_emb_proj", tree,
                    path + ("time_emb_proj",))
    _convert_norm(sd, f"{prefix}.norm2", tree, path + ("norm2",), wrap=True)
    _convert_conv1d(sd, f"{prefix}.conv2", tree, path + ("conv2",))
    if f"{prefix}.conv_shortcut.weight" in sd:
        _convert_conv1d(sd, f"{prefix}.conv_shortcut", tree,
                        path + ("conv_shortcut",))


def convert_reference_state_dict(state_dict: Dict) -> Dict:
    """torch TTSSingleSpeaker state_dict -> flax {'params': ...} pytree."""
    sd = state_dict
    tree: Dict = {}

    # --- text encoder ---
    _set(tree, ("text_encoder", "word_embedding", "embedding"),
         _t(sd["text_encoder.word_embedding.weight"]))
    i = 0
    while f"text_encoder.transformer_blocks.{i}.norm1.weight" in sd:
        _convert_basic_block(
            sd, f"text_encoder.transformer_blocks.{i}", tree,
            ("text_encoder", f"block_{i}"), has_cross=False)
        i += 1

    # --- unet top ---
    _convert_conv1d(sd, "unet.conv_in", tree, ("unet", "conv_in"))
    _convert_linear(sd, "unet.time_embedding.linear_1", tree,
                    ("unet", "time_embedding", "linear_1"))
    _convert_linear(sd, "unet.time_embedding.linear_2", tree,
                    ("unet", "time_embedding", "linear_2"))

    # --- down blocks ---
    b = 0
    while f"unet.down_blocks.{b}.resnets.0.norm1.weight" in sd:
        base = f"unet.down_blocks.{b}"
        path = ("unet", f"down_{b}")
        j = 0
        while f"{base}.resnets.{j}.norm1.weight" in sd:
            _convert_resnet(sd, f"{base}.resnets.{j}", tree,
                            path + (f"resnet_{j}",))
            if f"{base}.attentions.{j}.norm.weight" in sd:
                _convert_spatial_transformer(
                    sd, f"{base}.attentions.{j}", tree, path + (f"attn_{j}",))
            j += 1
        if f"{base}.downsamplers.0.conv.weight" in sd:
            # Downsample1D wraps Conv1d("conv") which wraps nn.Conv("conv")
            _convert_conv1d(sd, f"{base}.downsamplers.0.conv", tree,
                            path + ("downsample", "conv"))
        b += 1

    # --- mid block ---
    if "unet.mid_block.resnets.0.norm1.weight" in sd:
        j = 0
        while f"unet.mid_block.resnets.{j}.norm1.weight" in sd:
            _convert_resnet(sd, f"unet.mid_block.resnets.{j}", tree,
                            ("unet", "mid", f"resnet_{j}"))
            j += 1
        j = 0
        while f"unet.mid_block.attentions.{j}.norm.weight" in sd:
            _convert_spatial_transformer(
                sd, f"unet.mid_block.attentions.{j}", tree,
                ("unet", "mid", f"attn_{j}"))
            j += 1

    # --- up blocks ---
    b = 0
    while f"unet.up_blocks.{b}.resnets.0.norm1.weight" in sd:
        base = f"unet.up_blocks.{b}"
        path = ("unet", f"up_{b}")
        j = 0
        while f"{base}.resnets.{j}.norm1.weight" in sd:
            _convert_resnet(sd, f"{base}.resnets.{j}", tree,
                            path + (f"resnet_{j}",))
            if f"{base}.attentions.{j}.norm.weight" in sd:
                _convert_spatial_transformer(
                    sd, f"{base}.attentions.{j}", tree, path + (f"attn_{j}",))
            j += 1
        if f"{base}.upsamplers.0.conv.weight" in sd:
            _convert_conv1d(sd, f"{base}.upsamplers.0.conv", tree,
                            path + ("upsample", "conv"))
        b += 1

    # --- output head ---
    _convert_norm(sd, "unet.conv_norm_out", tree,
                  ("unet", "conv_norm_out"), wrap=True)
    _convert_conv1d(sd, "unet.conv_out", tree, ("unet", "conv_out"))

    return {"params": tree}


def load_reference_checkpoint(path: str) -> Dict:
    """Load a reference ``ckpt_N.pt`` and convert it."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_reference_state_dict(sd)


def load_reference_state(path: str) -> Dict:
    """A reference ``ckpt_N.pt`` -> the port's ``TTSSingleSpeaker``
    state dict (``--init_from_ref``, ``synthesize --ref_ckpt``)."""
    from prompt_tts_tpu_torch.convert import model_state_from_jax
    return model_state_from_jax(load_reference_checkpoint(path))
