"""Wrapper of the hand-written fused resnet block kernel (csrc/resnet.cu).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/resnet.py:
fused_resnet_block``: the whole UNet ``ResnetBlock1D`` for inference, on
channels-last ``[B, T, Cin]`` (f32 or bf16), with the time-embedding
projection ``temb_proj [B, Cout]`` computed outside.  Three launches a
call (GroupNorm statistics, conv1, conv2); ``fused_resnet_block.launches``
counts calls.

The kernel takes its weights packed once (:func:`pack_resnet_weights`):
k3 kernels as ``[3, Cin, Cout]`` and the shortcut as ``[Cin, Cout]`` in the
activations' dtype, norms and biases as f32.  A CUDA tensor launches the
kernel or raises; the plain version lives in ``ops/resnet.py``.
"""

import ctypes
from typing import Dict, Optional

import torch

from prompt_tts_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 128


def pack_resnet_weights(block, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernel's layout of a ``ResnetBlock1D``'s weights, on its device:
    ``w1 [3, Cin, Cout]``, ``w2 [3, Cout, Cout]``, ``ws [Cin, Cout]`` (or
    None) in ``dtype``; ``g1w, g1b, b1, g2w, g2b, b2, bs`` in f32."""
    def k3(conv):   # torch [Cout, Cin, 3] -> [3, Cin, Cout]
        return conv.conv.weight.detach().permute(2, 1, 0).to(
            dtype).contiguous()

    def f32(t):
        return None if t is None else t.detach().float().contiguous()

    sc = block.conv_shortcut
    return {
        "g1w": f32(block.norm1.norm.weight), "g1b": f32(block.norm1.norm.bias),
        "w1": k3(block.conv1), "b1": f32(block.conv1.conv.bias),
        "g2w": f32(block.norm2.norm.weight), "g2b": f32(block.norm2.norm.bias),
        "w2": k3(block.conv2), "b2": f32(block.conv2.conv.bias),
        "ws": None if sc is None else sc.conv.weight.detach()[..., 0].t().to(
            dtype).contiguous(),
        "bs": None if sc is None else f32(sc.conv.bias),
    }


def _lib():
    lib = _build.load("resnet")
    if lib.ptts_resnet_block.argtypes is None:
        lib.ptts_resnet_partials.argtypes = [ctypes.c_int] * 4
        lib.ptts_resnet_partials.restype = ctypes.c_longlong
        lib.ptts_resnet_block.argtypes = ([ctypes.c_void_p] * 16
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
        lib.ptts_resnet_block.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_resnet_block(x: torch.Tensor, temb_proj: torch.Tensor,
                       packed: Dict[str, torch.Tensor], groups: int,
                       eps: float) -> torch.Tensor:
    """x ``[B, T, Cin]`` (CUDA, f32 or bf16), temb_proj ``[B, Cout]``,
    ``packed`` from :func:`pack_resnet_weights` at x's dtype -> ``[B, T,
    Cout]`` at x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_block: x on {x.device}; the plain "
                         f"version is ops/resnet.py:resnet_block_plain")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_resnet_block: dtype {x.dtype} not supported")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_resnet_block: x must be a contiguous "
                         "[B, T, Cin]")
    B, T, Cin = x.shape
    w1, w2, ws = packed["w1"], packed["w2"], packed["ws"]
    Cout = w1.shape[2]
    if tuple(w1.shape) != (3, Cin, Cout) or tuple(w2.shape) != (3, Cout, Cout):
        raise ValueError(f"fused_resnet_block: packed conv weights "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} do not fit "
                         f"x [.., .., {Cin}]")
    if (ws is None) != (Cin == Cout) or (
            ws is not None and tuple(ws.shape) != (Cin, Cout)):
        raise ValueError("fused_resnet_block: the shortcut must be a 1x1 "
                         "[Cin, Cout] exactly when Cin != Cout")
    for name, t in packed.items():
        if t is None:
            continue
        want = x.dtype if name in ("w1", "w2", "ws") else torch.float32
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"fused_resnet_block: packed {name} is {t.dtype} "
                             f"on {t.device}, wants contiguous {want} on "
                             f"{x.device}")
    if tuple(temb_proj.shape) != (B, Cout) or temb_proj.device != x.device:
        raise ValueError(f"fused_resnet_block: temb_proj "
                         f"{tuple(temb_proj.shape)} on {temb_proj.device}, "
                         f"wants {(B, Cout)} on {x.device}")
    if not (0 < groups <= MAX_GROUPS) or Cin % groups or Cout % groups or (
            Cin // groups > 256) or Cin % 8 or Cout % 8:
        raise ValueError(f"fused_resnet_block: {groups} groups over "
                         f"{Cin} -> {Cout} channels not supported (channel "
                         f"counts must be multiples of 8)")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("ws", ws)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fused_resnet_block: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte vectors)")
    lib = _lib()
    temb = temb_proj.float().contiguous()
    h = torch.empty(B, T, Cout, device=x.device, dtype=x.dtype)
    out = torch.empty_like(h)
    stats = torch.empty(B, groups, 2, device=x.device, dtype=torch.float32)
    part = torch.empty(lib.ptts_resnet_partials(B, T, Cout, groups),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.ptts_resnet_block(
            x.data_ptr(), temb.data_ptr(), *(_ptr(packed[k]) for k in (
                "g1w", "g1b", "w1", "b1", "g2w", "g2b", "w2", "b2", "ws",
                "bs")),
            h.data_ptr(), stats.data_ptr(), part.data_ptr(), out.data_ptr(),
            B, T, Cin, Cout, groups, eps, _DTYPES[x.dtype],
            _build.stream_handle(x.device))
    _build.check(err, "resnet block kernel launch")
    fused_resnet_block.launches += 1
    return out


fused_resnet_block.launches = 0
