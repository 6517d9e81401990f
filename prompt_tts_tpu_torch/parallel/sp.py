"""Sequence parallelism: latent time sharded over a ``seq`` process group.

Port of ``prompt_tts_tpu/parallel/sp.py``.  The JAX package shards the
UNet's activations along time over the mesh ``seq`` axis and lets GSPMD
insert the k=3 convolutions' halo exchanges and the GroupNorms'
reductions; only self-attention, whose every output row needs every key,
runs a hand-written ring (``ops/ring_attention.py``).  Here every rank of
a seq group (``parallel/mesh.py``) holds one contiguous slice of each
sharded level's frames, and the modules that need another rank's frames
run the collectives themselves:

* ``models/unet1d.py`` runs a level sharded when its length divides the
  group (900 and 450 of the flagship's 900/450/225/113 at ``sp`` 2) and
  whole on every rank otherwise: :func:`gather_time` at the boundary into
  a whole level, :func:`slice_time` where a sharded one resumes;
* a k=3 convolution pads its slice with its neighbours' edge frames
  (:func:`halo`), the sequence's own edges with zeros;
* a GroupNorm reduces its f32 statistics over the group
  (:func:`group_norm`: the global mean, then the centred sum of squares);
* self-attention is the exact ring of ``ops/ring_attention.py``
  (:func:`maybe_ring_attention`), on kernels #1 and #2 on the card;
  cross-attention needs nothing: the local queries see the whole,
  replicated text context;
* a dropout keeps its slice of one whole mask (:func:`sharded_dropout`,
  ``parallel/tp.py``), drawn alike by the ranks of the group.

The text and prompt encoders run whole on every rank.  The collectives
are ``torch.autograd.Function``s whose gradients follow one rule: the
gradient a rank holds of a replicated tensor is its own rows' part, and
the parts sum to the whole.  So slicing's backward scatters into zeros,
gathering's sums the ranks' gradients and keeps the slice, a halo's
returns to its owner and adds there, and a statistics all-reduce's is an
all-reduce.  The trainer backs the whole loss out of every rank of a data
row, which makes each rank's gradient ``sp`` times its part; DDP averages
over data x seq (``parallel.grad_group``), which gives the data average
of the whole gradients (``train/loop.py``).

Transport.  The halos, the statistics and the gathers are all-reduces
(a gather: of a zero-filled whole buffer that holds this rank's slice, one
non-zero term an element, so exact), which gloo runs on CUDA tensors too.
The ring's blocks travel point to point (``batch_isend_irecv``): over
NCCL on the card, over gloo directly on the CPU, and staged through host
memory for gloo ranks that share one card, since gloo has no send or
recv on CUDA tensors.  Each rank holds one K/V block at a time.

:func:`enable` / :func:`sequence_parallel` arm a group for direct calls of
``ops.attention.scaled_dot_product_attention`` on time-sharded tensors (as
JAX's ``enable(mesh)`` arms its dispatcher); the model's layers carry
their own group, set by :func:`shard_seq_`.
"""

import collections
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class SeqGroup(NamedTuple):
    """A seq group: the process group, this rank's place in it, its size
    and its world ranks in seq order (the ring's neighbours)."""
    group: object
    rank: int
    size: int
    ranks: tuple


# the armed group of direct attention calls, and the ring's calls by the
# whole sequence length they attended over
_STATE = {"seq": None, "ring_tqs": collections.Counter()}


def mesh_seq() -> Optional[SeqGroup]:
    """This rank's seq group of the current mesh (None at ``sp`` 1)."""
    from prompt_tts_tpu_torch.parallel.mesh import (
        seq_group, seq_group_ranks, seq_rank, seq_size,
    )
    if seq_size() == 1:
        return None
    return SeqGroup(seq_group(), seq_rank(), seq_size(),
                    tuple(seq_group_ranks()))


def enable(seq: Optional[SeqGroup]) -> None:
    """Arm ring attention for direct attention calls on time-sharded
    tensors that name no group."""
    _STATE["seq"] = seq


def disable() -> None:
    _STATE["seq"] = None


def active() -> Optional[SeqGroup]:
    """The armed group, if one of more than one rank is armed."""
    seq = _STATE["seq"]
    return seq if seq is not None and seq.size > 1 else None


@contextmanager
def sequence_parallel(seq: Optional[SeqGroup]):
    prev = _STATE["seq"]
    _STATE["seq"] = seq
    try:
        yield
    finally:
        _STATE["seq"] = prev


def ring_trace_count() -> int:
    """How many attention calls ran on the ring since the last reset (a
    diagnostic: tests see that SP engaged rather than fell back)."""
    return sum(_STATE["ring_tqs"].values())


def ring_trace_tqs() -> List[int]:
    """The whole sequence lengths (Tq) the ring attended over since the
    last reset, each once, in order: which UNet levels rang (900 and 450
    of the flagship at ``sp`` 2) and which ran whole (225, 113)."""
    return sorted(_STATE["ring_tqs"])


def reset_ring_traces() -> None:
    _STATE["ring_tqs"].clear()


def maybe_ring_attention(q, k, v, bias, seq: Optional[SeqGroup] = None):
    """Exact attention over time-sharded q/k/v ``[B, T/sp, H, D]`` on the
    ring of ``seq`` (or of the armed group), when the call is one the ring
    takes: self-attention (k and v shaped as q) with a key-only bias or
    none (JAX ``sp.py``'s gates; the level rule has already made the
    length divide).  Returns None otherwise, and the caller runs the
    attention on its own rows."""
    seq = seq if seq is not None else active()
    if seq is None or seq.size == 1:
        return None
    B, Tq, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        return None
    if bias is not None and tuple(bias.shape) != (B, 1, 1, Tq):
        return None
    from prompt_tts_tpu_torch.ops.ring_attention import ring_attention
    _STATE["ring_tqs"][Tq * seq.size] += 1
    return ring_attention(q, k, v, bias, seq)


def shard_seq_(model: torch.nn.Module, seq: Optional[SeqGroup]):
    """Run ``model``'s UNet (``model.unet``, or ``model`` itself) with its
    latent time sharded over ``seq``: it slices its sample at entry,
    gathers its output at exit, and arms each level sharded or whole at
    every call (``models/unet1d.py``).  Nothing changes at ``sp`` 1."""
    if seq is None or seq.size == 1:
        return model
    unet = getattr(model, "unet", model)
    unet.seq = seq
    return model


# -- transport ---------------------------------------------------------------

def _staged(t: torch.Tensor, seq: SeqGroup) -> bool:
    """Whether ``t`` must travel through host memory: gloo ranks sharing a
    card have no point-to-point transport of CUDA tensors."""
    return t.device.type == "cuda" and \
        dist.get_backend(seq.group) == dist.Backend.GLOO


def _all_reduce(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=seq.group)
    return y


def rotate(t: torch.Tensor, seq: SeqGroup, shift: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``shift`` places on in the ring and return
    what the rank ``shift`` places back sent (the same shape and dtype)."""
    n = seq.size
    dst = seq.ranks[(seq.rank + shift) % n]
    src = seq.ranks[(seq.rank - shift) % n]
    staged = _staged(t, seq)
    send = t.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, seq.group),
            dist.P2POp(dist.irecv, recv, src, seq.group)]):
        req.wait()
    return recv.to(t.device, non_blocking=True) if staged else recv


def rotate_packed(tensors: Sequence[torch.Tensor], seq: SeqGroup
                  ) -> List[torch.Tensor]:
    """:func:`rotate` of several tensors in one message (their bytes
    joined), so each hop is one send and one receive; each comes back in a
    fresh allocation of its own (the kernels want aligned rows)."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    got = rotate(torch.cat(flat), seq)
    out, at = [], 0
    for t, f in zip(tensors, flat):
        out.append(got[at:at + f.numel()].clone().view(t.dtype)
                   .reshape(t.shape))
        at += f.numel()
    return out


# -- the collectives as autograd functions ----------------------------------

class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return rotate(x, seq, 1)

    @staticmethod
    def backward(ctx, g):
        return rotate(g, ctx.seq, -1), None


class _SliceTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq, ctx.shape = seq, x.shape
        n = x.shape[1] // seq.size
        return x[:, seq.rank * n:(seq.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        out = g.new_zeros(ctx.shape)
        n = g.shape[1]
        out[:, seq.rank * n:(seq.rank + 1) * n] = g
        return out, None


def _gather(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    n = x.shape[1]
    full = x.new_zeros((x.shape[0], n * seq.size) + tuple(x.shape[2:]))
    full[:, seq.rank * n:(seq.rank + 1) * n] = x
    dist.all_reduce(full, group=seq.group)
    return full


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _gather(x, seq)

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        n = g.shape[1] // seq.size
        g = _all_reduce(g, seq)
        return g[:, seq.rank * n:(seq.rank + 1) * n].contiguous(), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_reduce(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.seq), None


def _edges(first: torch.Tensor, last: torch.Tensor,
           seq: SeqGroup) -> torch.Tensor:
    """Every rank's (first, last) frames ``[sp, 2, B, C]``: an all-reduce
    of a zero-filled buffer that holds this rank's pair (exact)."""
    buf = first.new_zeros((seq.size, 2) + tuple(first.shape))
    buf[seq.rank, 0] = first
    buf[seq.rank, 1] = last
    dist.all_reduce(buf, group=seq.group)
    return buf


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, left, right):
        ctx.seq, ctx.left, ctx.right = seq, left, right
        r, n = seq.rank, seq.size
        edges = _edges(x[:, 0], x[:, -1], seq)
        parts = []
        if left:
            parts.append((edges[r - 1, 1] if r > 0
                          else torch.zeros_like(x[:, 0]))[:, None])
        parts.append(x)
        if right:
            parts.append((edges[r + 1, 0] if r < n - 1
                          else torch.zeros_like(x[:, 0]))[:, None])
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        seq, left, right = ctx.seq, ctx.left, ctx.right
        r, n = seq.rank, seq.size
        T = g.shape[1] - left - right
        gx = g[:, left:left + T].clone()
        zero = torch.zeros_like(gx[:, 0])
        # this rank's halo gradients go back to their owners: the left
        # halo's to the previous rank's last frame, the right's to the next
        # rank's first
        edges = _edges(g[:, 0] if left else zero,
                       g[:, -1] if right else zero, seq)
        if r > 0:
            gx[:, 0] += edges[r - 1, 1]
        if r < n - 1:
            gx[:, -1] += edges[r + 1, 0]
        return gx, None, None, None


def slice_time(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """This rank's slice of the time axis (dim 1) of the whole ``x``."""
    return _SliceTime.apply(x, seq)


def gather_time(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The ranks' time slices ``x`` joined in seq order: the whole."""
    return _GatherTime.apply(x, seq)


def all_reduce_sum(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The sum over the group of the ranks' partial ``x``."""
    return _AllReduce.apply(x, seq)


def halo(x: torch.Tensor, seq: SeqGroup, left: int = 1,
         right: int = 1) -> torch.Tensor:
    """This rank's slice ``[B, T, C]`` with ``left`` (0 or 1) frames of the
    previous rank's in front and ``right`` of the next rank's behind; the
    whole sequence's edges get zeros, the convolution's own padding."""
    return _Halo.apply(x, seq, left, right)


def rotate_diff(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """:func:`rotate` by one, differentiable: the gradient rotates back."""
    return _Rotate.apply(x, seq)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float,
               seq: SeqGroup) -> torch.Tensor:
    """GroupNorm of the time-sharded ``x [B, T/sp, C]`` over the whole
    sequence: f32 statistics in two passes over the group (the mean, then
    the centred sum of squares), each an all-reduce of ``[B, groups]``;
    returns ``x``'s dtype."""
    B, T, C = x.shape
    g = x.float().reshape(B, T, num_groups, C // num_groups)
    n = T * seq.size * (C // num_groups)
    mean = all_reduce_sum(g.sum(dim=(1, 3)), seq) / n
    d = g - mean[:, None, :, None]
    var = all_reduce_sum((d * d).sum(dim=(1, 3)), seq) / n
    y = (d * torch.rsqrt(var + eps)[:, None, :, None]).reshape(B, T, C)
    return (y * weight.float() + bias.float()).to(x.dtype)
