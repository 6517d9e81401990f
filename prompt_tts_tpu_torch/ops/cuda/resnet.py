"""Wrapper of the hand-written fused resnet block kernel (csrc/resnet.cu).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/resnet.py:
fused_resnet_block``: the whole UNet ``ResnetBlock1D`` for inference, on
channels-last ``[B, T, Cin]`` (f32 or bf16), with the time-embedding
projection ``temb_proj [B, Cout]`` computed outside.  A call makes five
launches (GroupNorm statistics; the activation pass ``silu(GN1(x))``;
conv1 on ``wgmma``, fed by TMA; ``silu(GN2(h))``; conv2 on ``wgmma``) in
the tile shape :func:`resnet_tiles` picks: bf16 products in bf16, f32 ones
in 3 x TF32 (each operand split into TF32 hi and lo parts, ``hi.lo +
lo.hi + hi.hi``; :func:`fused_resnet_block_tf32x3` is that arithmetic on
the CPU).  ``fused_resnet_block.launches`` counts calls.

The kernel takes its weights packed once (:func:`pack_resnet_weights`):
k3 kernels as ``[3, Cout, Cin]`` and the shortcut as ``[Cout, Cin]``
(K-major: input channels contiguous) in the activations' dtype, for f32
as their TF32 planes, norms and biases as f32.  A CUDA tensor launches the
kernel or raises; a CPU tensor runs :func:`fused_resnet_block_plain`,
which rounds where the kernel rounds.

The kernel is also the op ``torch.ops.ptts.fused_resnet_block(x,
temb_proj, g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws, bs, groups, eps)``, the
packed tensors in :data:`_ORDER` (``ops/cuda/library.py``): the launcher on
CUDA tensors, the plain version on CPU ones.  An exported UNet passes it
the block's packed buffers (``ops/resnet.py:pack_kernel_weights_``).
"""

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from prompt_tts_tpu_torch.ops.cuda import _build, opcount
from prompt_tts_tpu_torch.ops.cuda.library import LIB, traced
from prompt_tts_tpu_torch.ops.cuda.rvq import split_tf32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 128
MAX_CHANNELS_PER_GROUP = 256
# The order of the packed tensors in the kernel's argument list.
_ORDER = ("g1w", "g1b", "w1", "b1", "g2w", "g2b", "w2", "b2", "ws", "bs")

# The products' tile shapes (rows BM of T, output channels BN), largest
# first, and the SMs of the card (an H100 SXM has 132).  f32 has no 64 x
# 128 tile: with two f32 stages in 96 KB it lost to both others at every
# block shape and batch of the f32 tile sweep (PERF.md, the f32 tiles).
TILES = ((128, 128), (64, 128), (64, 64))
TILES_F32 = ((128, 128), (64, 64))
SMS = 132


def resnet_tiles(B: int, T: int, Cin: int, Cout: int,
                 dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """The products' tile shape ``(BM, BN)`` for a block in ``dtype``: the
    largest of :data:`TILES` (f32: :data:`TILES_F32`) whose grid (``B *
    ceil(T / BM) * ceil(Cout / BN)`` CTAs) fills at least half the SMs;
    where none does (small batches at the deep levels), the smallest,
    which gives the most CTAs.  A 128 x 128 CTA (two consumer warpgroups;
    a ring of 128 KB in bf16, 192 KB in f32) holds an SM alone and does its
    work in less than half the time of two 64-row CTAs, so it wins from
    half a wave of CTAs on (PERF.md, the tile sweeps).  ``Cin`` does not
    enter: it sets the depth of the K loop, not the grid."""
    del Cin
    tiles = TILES_F32 if dtype == torch.float32 else TILES
    for bm, bn in tiles:
        if 2 * B * -(-T // bm) * -(-Cout // bn) >= SMS:
            return bm, bn
    return tiles[-1]


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """f32 ``w`` as its TF32 planes ``[2, *w.shape]``: ``hi = rna(w)``,
    ``lo = rna(w - hi)``, the bits of ``cvt.rna.tf32.f32``
    (``ops/cuda/rvq.py:split_tf32``, on w's device)."""
    return torch.stack(split_tf32(w.float().contiguous()))


def pack_resnet_weights(block, dtype: torch.dtype) -> Dict[str, object]:
    """The kernel's layout of a ``ResnetBlock1D``'s weights, on its device:
    ``w1 [3, Cout, Cin]``, ``w2 [3, Cout, Cout]``, ``ws [Cout, Cin]`` (or
    None) in ``dtype``, for f32 as their TF32 planes ``[2, ...]``
    (:func:`split_planes`: the kernel reads only these); ``g1w, g1b, b1,
    g2w, g2b, b2, bs`` in f32.  Also
    ``spec`` (dtype, device, Cin, Cout), which each call checks in place of
    the tensors, and the kernel's tensors' addresses in its order."""
    def w(t):   # in dtype; f32 as its TF32 planes
        t = t.detach().to(dtype)
        return split_planes(t) if dtype == torch.float32 else t.contiguous()

    def k3(conv):   # torch [Cout, Cin, 3] -> [3, Cout, Cin]
        return w(conv.conv.weight.permute(2, 0, 1))

    def f32(t):
        return None if t is None else t.detach().float().contiguous()

    sc = block.conv_shortcut
    packed = {
        "g1w": f32(block.norm1.norm.weight), "g1b": f32(block.norm1.norm.bias),
        "w1": k3(block.conv1), "b1": f32(block.conv1.conv.bias),
        "g2w": f32(block.norm2.norm.weight), "g2b": f32(block.norm2.norm.bias),
        "w2": k3(block.conv2), "b2": f32(block.conv2.conv.bias),
        "ws": None if sc is None else w(sc.conv.weight[..., 0]),
        "bs": None if sc is None else f32(sc.conv.bias),
    }
    for name in _ORDER:
        t = packed[name]
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"pack_resnet_weights: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte vectors)")
    return _with_spec(packed, dtype)


def _with_spec(packed: Dict[str, object], dtype: torch.dtype
               ) -> Dict[str, object]:
    """``packed`` with its ``spec`` and its tensors' addresses in the
    kernel's order."""
    cout, cin = packed["w1"].shape[-2:]
    packed["spec"] = (dtype, packed["w1"].device, cin, cout)
    packed["ptrs"] = tuple(None if packed[k] is None else packed[k].data_ptr()
                           for k in _ORDER)
    return packed


def packed_tensors(packed: Dict[str, object]):
    """The packed tensors in the op's order (:data:`_ORDER`)."""
    return tuple(packed[k] for k in _ORDER)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("resnet")
    lib.ptts_resnet_scratch_bytes.argtypes = [ctypes.c_int] * 7
    lib.ptts_resnet_scratch_bytes.restype = ctypes.c_longlong
    lib.ptts_resnet_block.argtypes = ([ctypes.c_void_p] * 14
                                      + [ctypes.c_int] * 5 + [ctypes.c_float]
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    lib.ptts_resnet_block.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(*shape) -> int:
    """Bytes of the kernel's scratch buffer for (B, T, Cin, Cout, groups,
    dtype code, BM): the C library's own layout, asked once a shape."""
    return _lib().ptts_resnet_scratch_bytes(*shape)


def fused_resnet_block(x: torch.Tensor, temb_proj: torch.Tensor,
                       packed: Dict[str, object], groups: int,
                       eps: float) -> torch.Tensor:
    """x ``[B, T, Cin]`` (f32 or bf16), temb_proj ``[B, Cout]``, ``packed``
    from :func:`pack_resnet_weights` at x's dtype and device -> ``[B, T,
    Cout]`` at x's dtype, in the tiles :func:`resnet_tiles` picks."""
    if traced():
        return torch.ops.ptts.fused_resnet_block(
            x, temb_proj, *packed_tensors(packed), groups, eps)
    return _launch(x, temb_proj, packed, groups, eps, None)


def _launch(x: torch.Tensor, temb_proj: torch.Tensor,
            packed: Dict[str, object], groups: int, eps: float,
            tiles: Optional[Tuple[int, int]]) -> torch.Tensor:
    """:func:`fused_resnet_block` in the tile shape ``tiles`` (one of
    :data:`TILES`, f32 :data:`TILES_F32`; None: :func:`resnet_tiles`'s
    pick).  The card tests and
    ``chip_smoke.py --resnet-tiles`` launch every tile through it."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_resnet_block: dtype {x.dtype} not supported")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_resnet_block: x must be a contiguous "
                         "[B, T, Cin]")
    B, T, Cin = x.shape
    dtype, device, cin, Cout = packed["spec"]
    if cin != Cin:
        raise ValueError(f"fused_resnet_block: packed weights for {cin} "
                         f"input channels do not fit x [.., .., {Cin}]")
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"fused_resnet_block: x is {x.dtype} on {x.device}, "
                         f"the packed weights {dtype} on {device}")
    if tuple(temb_proj.shape) != (B, Cout) or temb_proj.device != x.device:
        raise ValueError(f"fused_resnet_block: temb_proj "
                         f"{tuple(temb_proj.shape)} on {temb_proj.device}, "
                         f"wants {(B, Cout)} on {x.device}")
    if not (0 < groups <= MAX_GROUPS) or Cin % groups or Cout % groups or (
            Cin // groups > MAX_CHANNELS_PER_GROUP) or Cin % 8 or Cout % 8:
        raise ValueError(f"fused_resnet_block: {groups} groups over "
                         f"{Cin} -> {Cout} channels not supported (channel "
                         f"counts must be multiples of 8)")
    if x.device.type == "cpu":
        return fused_resnet_block_plain(x, temb_proj, packed, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_block: unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("fused_resnet_block: x is not 16-byte aligned (the "
                         "kernel loads 16-byte vectors)")
    bm, bn = resnet_tiles(B, T, Cin, Cout, x.dtype) if tiles is None \
        else tiles
    allowed = TILES_F32 if x.dtype == torch.float32 else TILES
    if (bm, bn) not in allowed:
        raise ValueError(f"fused_resnet_block: tiles {(bm, bn)} not in "
                         f"{allowed} ({x.dtype})")
    code = _DTYPES[x.dtype]
    lib = _lib()
    # temb_proj in x's dtype, as the TPU kernel casts it
    temb = temb_proj.to(x.dtype).contiguous()
    out = torch.empty((B, T, Cout), device=x.device, dtype=x.dtype)
    scratch = torch.empty(_scratch_bytes(B, T, Cin, Cout, groups, code, bm),
                          device=x.device, dtype=torch.uint8)
    args = (x.data_ptr(), temb.data_ptr(), *packed["ptrs"],
            scratch.data_ptr(), out.data_ptr(), B, T, Cin, Cout, groups,
            eps, code, bm, bn, _build.stream_handle(x.device))
    if x.device.index == torch.cuda.current_device():
        err = lib.ptts_resnet_block(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.ptts_resnet_block(*args)
    _build.check(err, "resnet block kernel launch")
    fused_resnet_block.launches += 1
    opcount.record(opcount.resnet_block(B, T, Cin, Cout))
    return out


fused_resnet_block.launches = 0


def fused_resnet_block_plain(x: torch.Tensor, temb_proj: torch.Tensor,
                             packed: Dict[str, object], groups: int,
                             eps: float) -> torch.Tensor:
    """What the kernel computes, in torch ops on the packed weights, rounded
    to x's dtype where the kernel rounds: ``a = silu(GN1(x))`` and ``a2 =
    silu(GN2(h))`` before each product, ``h`` once after ``+ b1 +
    temb_proj``, and the output; GroupNorm statistics in f64, products and
    sums in f32; ``temb_proj`` taken in x's dtype, as the kernel (and the
    TPU kernel) takes it; f32 weights as the sum of their TF32 planes,
    within 2^-21 of the module's.  The plain version of
    :func:`fused_resnet_block` (its CPU path and the card's reference); the
    model's own CPU path is ``ops/resnet.py:resnet_block_plain``."""
    return _fused(x, temb_proj, packed, groups, eps, _mm_f32)


def fused_resnet_block_tf32x3(x: torch.Tensor, temb_proj: torch.Tensor,
                              packed: Dict[str, object], groups: int,
                              eps: float) -> torch.Tensor:
    """The f32 kernel's arithmetic on the CPU: :func:`fused_resnet_block_plain`
    with every product in 3 x TF32 as the kernel takes it, on the packed
    weights' TF32 planes and a, a2 and x split the same way
    (``split_tf32``): ``(hi.lo + lo.hi) + hi.hi``, each product of two
    TF32 values exact in f32, f32 sums (on the card, under TF32 off).  The kernel adds the same terms in another
    order (a 32-channel chunk's three at a time)."""
    if x.dtype != torch.float32:
        raise ValueError(f"fused_resnet_block_tf32x3: f32 only, not "
                         f"{x.dtype}")
    return _fused(x, temb_proj, packed, groups, eps, _mm_tf32x3)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., C] @ w [Cout, C]^T`` in f32; an f32 ``w`` is its TF32
    planes ``[2, Cout, C]``, taken as their sum."""
    if w.dtype == torch.float32:
        w = w[0] + w[1]
    return a.float() @ w.float().t()


def _mm_tf32x3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same in 3 x TF32, ``w [2, Cout, C]`` the weights' TF32 planes."""
    ah, al = split_tf32(a)
    return (ah @ w[1].t() + al @ w[0].t()) + ah @ w[0].t()


def _fused(x, temb_proj, packed, groups, eps, mm):
    """The block on ``packed`` with the products ``mm(a, w)`` over its
    packed weights (a k3 kernel's tap s is ``w.select(-3, s)``)."""
    dt = x.dtype
    w1, w2, ws = packed["w1"], packed["w2"], packed["ws"]

    def act(v, gamma, beta):   # silu(GN(v)) rounded, v [B, T, C]
        B, T, C = v.shape
        g = v.double().reshape(B, T, groups, C // groups)
        mean = g.mean(dim=(1, 3))
        var = (g - mean[:, None, :, None]).square().mean(dim=(1, 3))
        rstd = (var + eps).rsqrt()
        per_c = C // groups
        mean_c = mean.float().repeat_interleave(per_c, dim=1)[:, None]
        rstd_c = rstd.float().repeat_interleave(per_c, dim=1)[:, None]
        scale = gamma * rstd_c
        shift = beta - mean_c * scale
        return F.silu(v.float() * scale + shift).to(dt)

    def conv3(a, w):   # "same" k3, zero edges: [B, T, C] -> f32 [B, T, Cout]
        T = a.shape[1]
        ap = F.pad(a.float(), (0, 0, 1, 1))
        return sum(mm(ap[:, s:s + T], w.select(-3, s)) for s in range(3))

    h = (conv3(act(x, packed["g1w"], packed["g1b"]), w1)
         + packed["b1"] + temb_proj.to(dt).float()[:, None, :]).to(dt)
    out = conv3(act(h, packed["g2w"], packed["g2b"]), w2) + packed["b2"]
    if ws is None:
        out = out + x.float()
    else:
        out = out + (mm(x, ws) + packed["bs"])
    return out.to(dt)


def _op_impl(x, temb_proj, g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws, bs,
             groups, eps):
    """The op on real tensors: the packed weights as arguments; the
    launcher on CUDA tensors, the plain version on CPU ones."""
    packed = dict(zip(_ORDER, (g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws, bs)))
    return _launch(x, temb_proj, _with_spec(packed, w1.dtype), groups, eps,
                   None)


def _op_fake(x, temb_proj, g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws, bs,
             groups, eps):
    B, T, _ = x.shape
    return x.new_empty(B, T, w1.shape[-2])


LIB.define("fused_resnet_block(Tensor x, Tensor temb_proj, Tensor g1w, "
           "Tensor g1b, Tensor w1, Tensor b1, Tensor g2w, Tensor g2b, "
           "Tensor w2, Tensor b2, Tensor? ws, Tensor? bs, int groups, "
           "float eps) -> Tensor")
LIB.impl("fused_resnet_block", _op_impl, "CPU")
LIB.impl("fused_resnet_block", _op_impl, "CUDA")
torch.library.register_fake("ptts::fused_resnet_block", _op_fake, lib=LIB)
