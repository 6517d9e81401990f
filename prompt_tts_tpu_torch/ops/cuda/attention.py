"""Wrapper of the hand-written attention forward kernel (csrc/attention.cu).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/attention.py:
flash_attention``: q ``[B,Tq,H,D]``, k/v ``[B,Tk,H,D]`` (f32 or bf16, head
dim 32/64/96/128), an optional key-only bias ``[B,1,1,Tk]``; f32 scores and
softmax statistics; output at q's dtype in ``[B,Tq,H,D]``.  Both dtypes run
on the tensor cores (``wgmma``) and the dtype picks the kernel: bf16 rounds
p to bf16 for PV as the TPU kernel does
(:func:`~prompt_tts_tpu_torch.ops.attention.flash_attention_plain` computes
the same); f32 runs every product as 3 x TF32 (each operand split into two
TF32 parts, three products), which keeps f32 accuracy.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (:func:`prompt_tts_tpu_torch.ops.attention.attention_plain`).
``flash_attention.launches`` counts kernel launches.

The kernel is also the op ``torch.ops.ptts.flash_attention(q, k, v, bias,
return_lse) -> (o, lse)`` (``lse`` is an empty tensor unless asked for):
the launcher on a CUDA tensor, the plain version with its f32 row
log-sum-exp on a CPU tensor, shapes alone on a fake tensor.  Traced code
(``torch.export``) reaches the kernel through the op; eager calls go to the
launcher directly, which saves the dispatcher's host time (PERF.md, the op
route).
"""

import ctypes
from typing import Optional

import torch

from prompt_tts_tpu_torch.ops.attention import attention_plain
from prompt_tts_tpu_torch.ops.cuda import _build, opcount
from prompt_tts_tpu_torch.ops.cuda.library import LIB, traced

HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_copy_alignment(what: str, **tensors) -> None:
    """Raise unless every row of each ``[B,T,H,D]`` tensor starts on 16
    bytes: the kernels copy rows in 16-byte pieces (bf16 by ``cp.async``,
    f32 by 16-byte loads before the TF32 split)."""
    for name, t in tensors.items():
        size = t.element_size()
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError(f"{what}: {name} rows are not 16-byte aligned "
                             f"(pointer {t.data_ptr():#x}, strides "
                             f"{t.stride()})")


def _fn():
    lib = _build.load("attention")
    fn = lib.ptts_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """Fused attention over ``[B, T, H, D]``; ``bias`` is key-only or None.

    Returns ``o``, or ``(o, lse)`` with ``return_lse`` (``lse`` is None on
    the CPU, whose plain backward recomputes the softmax itself)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if bias is not None and tuple(bias.shape) != (B, 1, 1, Tk):
        raise ValueError(f"attention takes a key-only bias [B,1,1,Tk] = "
                         f"{(B, 1, 1, Tk)} or None, got {tuple(bias.shape)}")
    if traced():
        out, lse = torch.ops.ptts.flash_attention(q, k, v, bias, return_lse)
        return (out, lse) if return_lse else out
    if q.device.type == "cpu":
        out = attention_plain(q, k, v, bias)
        return (out, None) if return_lse else out
    out, lse = _launch(q, k, v, bias, return_lse)
    return (out, lse) if return_lse else out


def _launch(q, k, v, bias, return_lse):
    """Check the inputs and launch the kernel: ``(o, lse or None)``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != (B, Tk, H, D):
            raise ValueError(f"flash_attention: {name} shape "
                             f"{tuple(t.shape)} != {(B, Tk, H, D)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    check_copy_alignment("flash_attention", q=q, k=k, v=v)
    key_bias = None
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("flash_attention: bias on another device")
        key_bias = bias.reshape(B, Tk).to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if key_bias is None else key_bias.data_ptr(),
                    out.data_ptr(), None if lse is None else lse.data_ptr(),
                    B, Tq, Tk, H, D, _DTYPES[q.dtype],
                    strides, _build.stream_handle(q.device))
    _build.check(err, "attention kernel launch")
    flash_attention.launches += 1
    opcount.record(opcount.attention_fwd(B, Tq, Tk, H, D))
    return out, lse


flash_attention.launches = 0


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 row log-sum-exp ``[B, H, Tq]`` of the scaled scores plus the
    bias, in natural-log units, as the kernel writes it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias.float()
    return torch.logsumexp(s, dim=-1)


def _op_cpu(q, k, v, bias, return_lse=False):
    lse = (attention_lse_plain(q, k, bias) if return_lse
           else q.new_empty(0, dtype=torch.float32))
    # contiguous, as the kernel writes it: the callers' reshape copies a
    # strided result to the same layout, so the values downstream are the
    # eager path's
    return attention_plain(q, k, v, bias).contiguous(), lse


def _op_cuda(q, k, v, bias, return_lse=False):
    out, lse = _launch(q, k, v, bias, return_lse)
    return out, (q.new_empty(0, dtype=torch.float32) if lse is None else lse)


def _op_fake(q, k, v, bias, return_lse=False):
    B, Tq, H, _ = q.shape
    lse = q.new_empty((B, H, Tq) if return_lse else (0,),
                      dtype=torch.float32)
    return torch.empty_like(q), lse


LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, Tensor? bias, "
           "bool return_lse=False) -> (Tensor, Tensor)")
LIB.impl("flash_attention", _op_cpu, "CPU")
LIB.impl("flash_attention", _op_cuda, "CUDA")
torch.library.register_fake("ptts::flash_attention", _op_fake, lib=LIB)
