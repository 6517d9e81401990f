"""Ring attention: exact self-attention over a time-sharded seq group.

Port of ``prompt_tts_tpu/ops/ring_attention.py``.  Each rank of a seq
group (``parallel/sp.py``) holds its slice of the queries, keys and values
``[B, T/sp, H, D]`` (and of a key-only bias ``[B, 1, 1, T/sp]``); the
K/V blocks travel around the ring, one hop a step, so that after ``sp``
steps every local query row has seen every key, while each rank holds
one visiting block at a time.

The JAX ring is an online-softmax loop of XLA einsums; here each step is
one call of the port's attention kernels, and the blocks' results are
merged in f32:

* **forward** (:class:`RingAttentionFunction`): step i calls kernel #1
  (``ops/cuda/attention.py:flash_attention(..., return_lse=True)``) on the
  local queries and the visiting block, then ``lse = logaddexp(lse,
  lse_i)`` and ``o = Σ_i exp(lse_i − lse) o_i``;
* **backward**: step i calls kernel #2 (``ops/cuda/attention_bwd.py:
  attention_bwd``) with the visiting block, the merged output, its
  gradient and the **merged** lse; the kernel recomputes ``p = exp(s ·
  scale + bias − lse)``, the block's own slice of the whole softmax, so
  each block's dq, dk, dv and bias gradient is an exact part.  dq sums
  locally; dk, dv and the bias gradient travel with their block and come
  home after ``sp`` hops.  Every sum is f32.

On the CPU the same function runs the blocks' plain versions: kernel #1's
(``ops/attention.py:attention_plain`` with ``ops/cuda/attention.py:
attention_lse_plain``), and a backward that takes the merged lse as
kernel #2 does (:func:`attention_block_bwd_plain`); ``ops/attention.py:
attention_bwd_plain`` renormalises inside its block and cannot serve a
ring.  :func:`ring_attention_plain` is JAX's loop itself, differentiable
through its rotations: the plain version the ring is held to.
"""

from typing import Optional

import torch

from prompt_tts_tpu_torch.ops.attention import attention_plain
from prompt_tts_tpu_torch.parallel import sp


def attention_block_bwd_plain(q, k, v, o, do, bias, lse,
                              need_dbias: bool = False):
    """One block's part of the attention gradients given the whole row
    log-sum-exp ``lse`` ``[B, H, Tq]``, as kernel #2 computes them: ``p =
    exp(s·scale + bias − lse)`` (not renormalised in the block), ``delta =
    rowsum(do·o)`` of the whole output ``o``, ``dv = pᵀ do``, ``ds = p (do
    vᵀ − delta)``, ``dq = ds k·scale``, ``dk = dsᵀ q·scale``; p and
    ds·scale rounded to the input dtype before their products.  Returns
    dq, dk, dv at the input dtype and the f32 bias gradient ``[B, 1, 1,
    Tk]`` (or None)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None])
    delta = (dof * o.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta)
    dbias = ds.sum(dim=(1, 2))[:, None, None, :] if need_dbias else None
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _block_fwd(q, k, v, bias):
    from prompt_tts_tpu_torch.ops.cuda.attention import (
        attention_lse_plain, flash_attention,
    )
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias), attention_lse_plain(q, k, bias)
    return flash_attention(q, k, v, bias, return_lse=True)


def _block_bwd(q, k, v, o, do, bias, lse, need_dbias):
    if q.device.type == "cpu":
        return attention_block_bwd_plain(q, k, v, o, do, bias, lse,
                                         need_dbias)
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    dq, dk, dv, db = attention_bwd(q, k, v, o, do, bias, lse,
                                   need_dbias=need_dbias)
    return dq, dk, dv, None if db is None else db.float()


def _merge(o_acc, lse_acc, o_i, lse_i):
    """Fold one block's ``(o_i, lse_i)`` into the running f32 pair."""
    if o_acc is None:
        return o_i.float(), lse_i
    lse = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse).permute(0, 2, 1)[..., None]
    w_i = torch.exp(lse_i - lse).permute(0, 2, 1)[..., None]
    return o_acc * w_acc + o_i.float() * w_i, lse


class RingAttentionFunction(torch.autograd.Function):
    """``(o, lse)`` of the local queries against every rank's keys; the
    blocks on kernels #1 and #2 on the card (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seq):
        blocks = (k, v) if bias is None else (k, v, bias)
        o_acc = lse = None
        for i in range(seq.size):
            o_i, lse_i = _block_fwd(q, *blocks[:2],
                                    blocks[2] if bias is not None else None)
            o_acc, lse = _merge(o_acc, lse, o_i, lse_i)
            if i < seq.size - 1:
                blocks = sp.rotate_packed(blocks, seq)
        o = o_acc.to(q.dtype).contiguous()
        ctx.seq = seq
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        seq = ctx.seq
        need_dbias = ctx.needs_input_grad[3]
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # the visiting block and its gradients' running f32 sums
        blocks = [k, v] + ([bias] if bias is not None else [])
        grads = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        if need_dbias:
            grads.append(torch.zeros(bias.shape, dtype=torch.float32,
                                     device=bias.device))
        for i in range(seq.size):
            dq_i, dk_i, dv_i, db_i = _block_bwd(
                q, blocks[0], blocks[1], o, do,
                blocks[2] if bias is not None else None, lse, need_dbias)
            dq += dq_i.float()
            grads[0] += dk_i.float()
            grads[1] += dv_i.float()
            if need_dbias:
                grads[2] += db_i
            # after sp hops each block's sums are home; the last hop
            # carries the sums alone
            if i < seq.size - 1:
                moved = sp.rotate_packed(blocks + grads, seq)
                blocks, grads = moved[:len(blocks)], moved[len(blocks):]
            else:
                grads = sp.rotate_packed(grads, seq)
        db = grads[2].to(bias.dtype) if need_dbias else None
        return (dq.to(q.dtype), grads[0].to(k.dtype), grads[1].to(v.dtype),
                db, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], seq: "sp.SeqGroup",
                   return_lse: bool = False):
    """Exact self-attention of the time-sharded ``q``, ``k``, ``v``
    ``[B, T/sp, H, D]`` (and a key-only bias ``[B, 1, 1, T/sp]`` or None)
    over the seq group ``seq``: this rank's rows of the whole attention,
    and with ``return_lse`` their f32 row log-sum-exp ``[B, H, T/sp]``."""
    o, lse = RingAttentionFunction.apply(q, k, v, bias, seq)
    return (o, lse) if return_lse else o


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], seq: "sp.SeqGroup",
                         return_lse: bool = False):
    """JAX ``ring_attention``'s loop (prompt_tts_tpu/ops/ring_attention.py:
    33-85): f32 running max, sum and output over the K/V/bias blocks as
    they rotate (``sp.rotate_diff``, whose gradient rotates back), so
    autograd differentiates it; the output at q's dtype, and with
    ``return_lse`` the f32 row log-sum-exp ``[B, H, T/sp]``."""
    scale = q.shape[-1] ** -0.5
    B, Tq, H, _ = q.shape
    qf = q.float()
    m = torch.full((B, H, Tq, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc = None
    kb, vb = k, v
    bb = (torch.zeros((B, 1, 1, k.shape[1]), device=q.device)
          if bias is None else bias.float())
    for i in range(seq.size):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale + bb
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
        acc = pv if acc is None else alpha * acc + pv
        m = m_new
        if i < seq.size - 1:
            kb, vb, bb = (sp.rotate_diff(t, seq) for t in (kb, vb, bb))
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out
