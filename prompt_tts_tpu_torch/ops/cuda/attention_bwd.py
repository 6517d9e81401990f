"""Wrapper of the hand-written attention backward kernel
(csrc/attention_bwd.cu).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/attention_bwd.py:
attention_fused_bwd``: from q, o, do ``[B,Tq,H,D]``, k, v ``[B,Tk,H,D]``
(f32 or bf16, head dim 32/64/96/128), the key-only bias ``[B,1,1,Tk]`` or
None and the forward kernel's f32 row log-sum-exp ``[B,H,Tq]``, it returns
dq, dk, dv at the input dtype and, when asked, the real bias gradient
``[B,1,1,Tk]`` (ds summed over heads and query rows) at the bias's dtype.

Both dtypes run on the tensor cores (``wgmma``) and the dtype picks the
kernel: bf16 rounds p and ds*scale to bf16 before their products, as the
TPU kernel and the plain version on bf16 tensors do; f32 runs every
product as 3 x TF32, at f32 accuracy.  A CUDA
tensor launches the kernel (two launches: the dq pass, then the dk/dv
pass) or raises; a CPU tensor runs the plain version
(:func:`prompt_tts_tpu_torch.ops.attention.attention_bwd_plain`), which
recomputes the softmax and needs no lse.  ``attention_bwd.launches``
counts kernel launches, two per call.

The kernel is also the op ``torch.ops.ptts.attention_bwd(q, k, v, o, do,
bias, lse, need_dbias) -> (dq, dk, dv, dbias)`` (``dbias`` an empty tensor
unless asked for): the launcher on CUDA tensors, the plain version on CPU
ones (``ops/cuda/library.py``).
"""

import ctypes
from typing import Optional

import torch

from prompt_tts_tpu_torch.ops.attention import attention_bwd_plain
from prompt_tts_tpu_torch.ops.cuda import _build, opcount
from prompt_tts_tpu_torch.ops.cuda.attention import check_copy_alignment
from prompt_tts_tpu_torch.ops.cuda.library import LIB, traced

HEAD_DIMS = (32, 64, 96, 128)
LAUNCHES_PER_CALL = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = _build.load("attention_bwd")
    fn = lib.ptts_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  lse: Optional[torch.Tensor] = None,
                  need_dbias: bool = False):
    """``(dq, dk, dv, dbias)``; ``dbias`` is None unless ``need_dbias``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if bias is not None and tuple(bias.shape) != (B, 1, 1, Tk):
        raise ValueError(f"attention_bwd takes a key-only bias [B,1,1,Tk] = "
                         f"{(B, 1, 1, Tk)} or None, got {tuple(bias.shape)}")
    if need_dbias and bias is None:
        raise ValueError("attention_bwd: need_dbias without a bias")
    if traced():
        dq, dk, dv, db = torch.ops.ptts.attention_bwd(q, k, v, o, do, bias,
                                                      lse, need_dbias)
        return dq, dk, dv, (db if need_dbias else None)
    if q.device.type == "cpu":
        dq, dk, dv, db = attention_bwd_plain(q, k, v, o, do, bias)
        return dq, dk, dv, (db.to(bias.dtype) if need_dbias else None)
    return _launch(q, k, v, o, do, bias, lse, need_dbias)


def _launch(q, k, v, o, do, bias, lse, need_dbias):
    """Check the inputs and launch both passes: ``(dq, dk, dv, dbias or
    None)``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention_bwd: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention_bwd: head dim {D} not in {HEAD_DIMS}")
    want = {"k": (B, Tk, H, D), "v": (B, Tk, H, D), "o": (B, Tq, H, D),
            "do": (B, Tq, H, D)}
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"attention_bwd: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"attention_bwd: {name} shape "
                             f"{tuple(t.shape)} != {want[name]}")
    if lse is None or lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (B, H, Tq):
        raise ValueError(f"attention_bwd: needs the forward's f32 lse "
                         f"{(B, H, Tq)} on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse)):
        raise ValueError("attention_bwd: q, k, v, o and lse must be "
                         "contiguous")
    do = do.contiguous()
    check_copy_alignment("attention_bwd", q=q, k=k, v=v, o=o, do=do)
    key_bias = None
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("attention_bwd: bias on another device")
        key_bias = bias.reshape(B, Tk).to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    dbias_h = (torch.empty(B, H, Tk, dtype=torch.float32, device=q.device)
               if need_dbias else None)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), ptr(key_bias), lse.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    ptr(dbias_h), delta.data_ptr(), B, Tq, Tk, H, D,
                    _DTYPES[q.dtype], D ** -0.5,
                    _build.stream_handle(q.device))
    _build.check(err, "attention backward kernel launch")
    attention_bwd.launches += LAUNCHES_PER_CALL
    opcount.record(opcount.attention_bwd(B, Tq, Tk, H, D))
    dbias = None
    if need_dbias:   # the bias broadcasts over heads: sum them
        dbias = dbias_h.sum(dim=1).reshape(B, 1, 1, Tk).to(bias.dtype)
    return dq, dk, dv, dbias


attention_bwd.launches = 0


def _op_cpu(q, k, v, o, do, bias, lse, need_dbias=False):
    dq, dk, dv, db = attention_bwd_plain(q, k, v, o, do, bias)
    db = db.to(bias.dtype).contiguous() if need_dbias else q.new_empty(
        0, dtype=torch.float32)
    return dq.contiguous(), dk.contiguous(), dv.contiguous(), db


def _op_cuda(q, k, v, o, do, bias, lse, need_dbias=False):
    dq, dk, dv, db = _launch(q, k, v, o, do, bias, lse, need_dbias)
    if db is None:
        db = q.new_empty(0, dtype=torch.float32)
    return dq, dk, dv, db


def _op_fake(q, k, v, o, do, bias, lse, need_dbias=False):
    B, _, _, _ = q.shape
    db = (bias.new_empty(B, 1, 1, k.shape[1]) if need_dbias
          else q.new_empty(0, dtype=torch.float32))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), db


LIB.define("attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, "
           "Tensor? bias, Tensor lse, bool need_dbias=False) "
           "-> (Tensor, Tensor, Tensor, Tensor)")
LIB.impl("attention_bwd", _op_cpu, "CPU")
LIB.impl("attention_bwd", _op_cuda, "CUDA")
torch.library.register_fake("ptts::attention_bwd", _op_fake, lib=LIB)
