"""Tensor parallelism: the Megatron rules over the ``model`` axis.

Port of ``prompt_tts_tpu/parallel/tp.py``.  The JAX package gives GSPMD a
``PartitionSpec`` for each parameter and lets XLA insert the collectives;
here the rules pick the same tensors by their state-dict names, each rank
of a model group (``parallel/mesh.py``) holds its slice, and the modules
that own them run the collectives themselves (``models/layers.py``):

* q/k/v of every attention (``attn1``/``attn2`` of a transformer block and
  the prompt encoder's ``pool``) are column-parallel: a rank computes its
  ``num_heads / n`` heads, and the attention kernels run on those local
  heads unchanged.  ``to_out`` is row-parallel: its partial products are
  summed over the group (:func:`reduce_from_model`) before its bias.
* The GEGLU ``ff.proj`` is column-parallel and ``ff.out`` row-parallel.
  ``proj``'s output is ``[value | gate]``: rank ``r`` takes its slice of
  each half, so its local output is ``[value_r | gate_r]`` and the GEGLU
  runs on local columns (:func:`shard_state` permutes, :func:`gather_state`
  inverts).  Its dropout draws the whole hidden layer's mask and keeps its
  slice, so the ranks' masks are the slices of one mask.
* ``conv1``, ``conv2`` and ``conv_shortcut`` of the UNet resnet blocks are
  sharded on their output channels, each followed by a gather
  (:func:`gather_from_model`), as GSPMD would do: the GroupNorms see whole
  channels.
* ``word_embedding`` is sharded on its feature dim, then gathered.

The biases of the column-parallel layers are sliced with their weights
(JAX replicates them and GSPMD slices them in the program).  A tensor
whose sharded dim does not divide ``n`` stays whole on every rank, as
``tp_shardings_one`` replicates it; the GEGLU projection needs each half
to divide.  An attention whose heads would split raises.  The optimizer
moments, the EMA and the accumulated gradients are sharded like their
parameters (:func:`shard_train_state`), and a checkpoint holds the whole
(``n`` = 1) layout (:func:`gather_train_state`).

The collectives are ``torch.autograd.Function``s on the model group:
copy-to-model (identity forward, all-reduce backward), reduce-from-model
(all-reduce forward, identity backward) and gather-from-model (all-gather
forward, this rank's slice backward).  A gather travels as an all-reduce
of a zero-filled whole buffer that holds this rank's slice: one non-zero
term an element, so exact, and gloo, which has no ``all_gather`` on CUDA
tensors, runs it as NCCL does.
"""

import re
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# (state-dict name, the dim sharded), first match wins.  Linear weights are
# [out, in], conv weights [out, in, k], embeddings [vocab, dim]:
# column-parallel shards dim 0 (JAX's kernel dim -1), row-parallel dim 1
# (JAX's dim 0).
TP_RULES = [
    # attention: q/k/v column-parallel (heads split), out row-parallel
    (r".*attn\d\.to_[qkv]\.weight", 0),
    (r".*attn\d\.to_out\.weight", 1),
    (r".*pool\.to_[qkv]\.weight", 0),
    (r".*pool\.to_out\.weight", 1),
    # GEGLU feed-forward: proj column-parallel ([value | gate] paired),
    # out row-parallel
    (r".*ff\.proj\.(weight|bias)", 0),
    (r".*ff\.out\.weight", 1),
    # resnet convs: output channels
    (r".*conv[12]\.conv\.(weight|bias)", 0),
    (r".*conv_shortcut\.conv\.(weight|bias)", 0),
    # embeddings: the feature dim
    (r".*word_embedding\.weight", 1),
]

_GEGLU = re.compile(r".*ff\.proj\.(weight|bias)")


class TPGroup(NamedTuple):
    """A module's model group: the process group, this rank, its size."""
    group: object
    rank: int
    size: int


def tp_param_spec(name: str, tensor) -> Optional[int]:
    """The dim the rules shard of state-dict entry ``name`` (None: whole),
    before the divisibility rule (JAX ``tp_param_spec``)."""
    if getattr(tensor, "ndim", 0) == 0:
        return None
    for pattern, dim in TP_RULES:
        if re.fullmatch(pattern, name):
            return dim
    return None


def shard_dim(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The dim of ``name`` (whole shape ``shape``) sharded over ``n`` ranks,
    or None when it stays whole: no rule, ``n`` 1, or a dim that does not
    divide (JAX ``tp_shardings_one``; the GEGLU projection needs each of
    its halves to divide)."""
    if n == 1 or len(shape) == 0:
        return None
    dim = tp_param_spec(name, torch.empty(shape, device="meta"))
    if dim is None:
        return None
    size = shape[dim] // 2 if _GEGLU.fullmatch(name) else shape[dim]
    if shape[dim] % n or size % n:
        return None
    return dim


def _slice(name: str, t: torch.Tensor, dim: int, rank: int,
           n: int) -> torch.Tensor:
    if _GEGLU.fullmatch(name):
        value, gate = t.chunk(2, dim)
        w = value.shape[dim] // n
        return torch.cat([value.narrow(dim, rank * w, w),
                          gate.narrow(dim, rank * w, w)], dim)
    w = t.shape[dim] // n
    return t.narrow(dim, rank * w, w)


def _join(name: str, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
    if _GEGLU.fullmatch(name):
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim)
    return torch.cat(parts, dim)


def shard_state(full: Mapping[str, torch.Tensor], rank: int,
                size: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state of ``size``: each ruled tensor's slice (a
    contiguous copy), every other tensor as it is."""
    out = {}
    for name, t in full.items():
        dim = shard_dim(name, tuple(t.shape), size)
        out[name] = (t if dim is None
                     else _slice(name, t, dim, rank, size).contiguous())
    return out


def gather_state(shards: Sequence[Mapping[str, torch.Tensor]],
                 shapes: Mapping[str, Sequence[int]]
                 ) -> Dict[str, torch.Tensor]:
    """The whole state of the ranks' ``shards`` (in model-rank order), the
    inverse of :func:`shard_state`; ``shapes`` are the whole tensors'
    shapes by name (a ruled dim of one size can be whole or a slice, so
    the shards alone do not tell)."""
    n = len(shards)
    out = {}
    for name, t in shards[0].items():
        dim = shard_dim(name, tuple(shapes[name]), n)
        out[name] = (t if dim is None
                     else _join(name, [s[name] for s in shards], dim))
    return out


def _moments(train_sd: Mapping, names: Sequence[str]):
    """(param name, moment key) of every moment tensor of an AdamW state
    dict in ``train_sd`` (``TrainState.state_dict``)."""
    for idx, st in train_sd["optimizer"]["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                yield idx, names[idx], k


def _named_parts(train_sd: Mapping) -> List[str]:
    return [k for k in ("model", "ema", "acc_grads")
            if train_sd.get(k) is not None]


def shard_train_state(full: Mapping, names: Sequence[str], rank: int,
                      size: int) -> dict:
    """``TrainState.state_dict()`` in the whole layout -> rank ``rank``'s
    of ``size``: the model, the EMA, the accumulated gradients and the
    AdamW moments (``names``: the parameters' names in optimizer order)."""
    out = dict(full)
    for k in _named_parts(full):
        out[k] = shard_state(full[k], rank, size)
    opt = full["optimizer"]
    state = {i: dict(st) for i, st in opt["state"].items()}
    for idx, name, k in _moments(full, names):
        state[idx][k] = shard_state({name: state[idx][k]}, rank,
                                    size)[name]
    out["optimizer"] = dict(opt, state=state)
    return out


def gather_train_state(shards: Sequence[Mapping], names: Sequence[str],
                       shapes: Mapping[str, Sequence[int]]) -> dict:
    """The ranks' ``TrainState.state_dict()``s (model-rank order) -> the
    whole layout, the inverse of :func:`shard_train_state`."""
    first = shards[0]
    out = dict(first)
    for k in _named_parts(first):
        out[k] = gather_state([s[k] for s in shards], shapes)
    opt = first["optimizer"]
    state = {i: dict(st) for i, st in opt["state"].items()}
    for idx, name, k in _moments(first, names):
        state[idx][k] = gather_state(
            [{name: s["optimizer"]["state"][idx][k]} for s in shards],
            shapes)[name]
    out["optimizer"] = dict(opt, state=state)
    return out


# -- the collectives -------------------------------------------------------

def _all_reduce(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=tp.group)
    return y


def _all_gather(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the last dim, in rank order: an
    all-reduce of a zero-filled whole buffer that holds this rank's slice
    (one non-zero term an element, so exact), which gloo, lacking an
    ``all_gather`` on CUDA tensors, and NCCL both run."""
    w = x.shape[-1]
    full = x.new_zeros(x.shape[:-1] + (w * tp.size,))
    full[..., tp.rank * w:(tp.rank + 1) * w] = x
    dist.all_reduce(full, group=tp.group)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, tp)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        w = g.shape[-1] // tp.size
        return g[..., tp.rank * w:(tp.rank + 1) * w].contiguous(), None


def copy_to_model(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """``x`` (replicated) entering column-parallel layers: the identity,
    whose backward sums the ranks' partial gradients."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (a row-parallel layer's output);
    its gradient passes through unchanged, as the output is replicated."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The ranks' last-dim slices ``x`` joined in rank order; the backward
    keeps this rank's slice of the gradient."""
    return _GatherFromModel.apply(x, tp)


def sharded_dropout(h: torch.Tensor, p: float, tp: Optional[TPGroup] = None,
                    seq=None) -> torch.Tensor:
    """Dropout of this rank's slice of a hidden layer: with ``tp`` its
    last-dim slice of a layer ``tp.size`` times as wide, with ``seq`` (a
    ``parallel.sp.SeqGroup``) its time slice (dim 1) of a sequence
    ``seq.size`` times as long.  The whole layer's mask is drawn (every
    rank of the groups draws the same, from the same generator state) and
    this rank keeps its slice, so the masks of the ranks are the slices of
    one mask and their generators stay in step."""
    shape = list(h.shape)
    if seq is not None:
        shape[1] *= seq.size
    if tp is not None:
        shape[-1] *= tp.size
    keep = torch.empty(shape, dtype=torch.bool,
                       device=h.device).bernoulli_(1.0 - p)
    if seq is not None:
        t = h.shape[1]
        keep = keep[:, seq.rank * t:(seq.rank + 1) * t]
    if tp is not None:
        w = h.shape[-1]
        keep = keep[..., tp.rank * w:(tp.rank + 1) * w]
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))


# -- the modules -------------------------------------------------------------

def shard_model_(model: nn.Module, rank: int, size: int,
                 group) -> nn.Module:
    """Keep rank ``rank``'s slices of ``model``'s ruled parameters (each
    marked with ``tp_dim``) and set its layers to run their collectives on
    ``group`` (see the module docstring).  The whole shapes stay in
    ``model.tp_full_shapes`` for :func:`gather_state`.  Call it before any
    cast (``models.layers.cast_compute_``), on weights in their final
    values.  Nothing changes at ``size`` 1."""
    from prompt_tts_tpu_torch.models.layers import (
        Attention, Conv1d, Embedding, GEGLUFeedForward,
    )
    if size == 1:
        return model
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tp = TPGroup(group, rank, size)
    for name, p in list(model.named_parameters()):
        dim = shard_dim(name, tuple(p.shape), size)
        if dim is None:
            continue
        owner, attr = name.rsplit(".", 1)
        local = nn.Parameter(_slice(name, p.data, dim, rank, size).clone(),
                             requires_grad=p.requires_grad)
        local.tp_dim = dim
        setattr(model.get_submodule(owner), attr, local)

    def sharded(w):
        return getattr(w, "tp_dim", None) is not None

    for mname, m in model.named_modules():
        if isinstance(m, Attention) and sharded(m.to_q.weight):
            if m.num_heads % size:
                raise ValueError(
                    f"{mname}: {m.num_heads} heads do not split over "
                    f"{size} ranks")
            m.num_heads //= size
            m.tp = m.to_out.tp = tp
        elif isinstance(m, GEGLUFeedForward) and sharded(m.proj.weight):
            m.tp = m.out.tp = tp
        elif isinstance(m, (Conv1d, Embedding)):
            w = m.conv.weight if isinstance(m, Conv1d) else m.weight
            if sharded(w):
                m.tp = tp
    model.tp_full_shapes = shapes
    return model


def sharded_mask(params: Sequence[torch.Tensor]) -> List[bool]:
    """Which of ``params`` are tensor-parallel slices."""
    return [getattr(p, "tp_dim", None) is not None for p in params]
