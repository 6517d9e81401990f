"""Wrapper of the hand-written residual-VQ encode kernel (``csrc/rvq.cu``).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/rvq.py:
rvq_encode_fused``: embeddings ``[B, T, D]`` f32 and codebooks
``[n_q, K, D]`` f32 -> indices ``[B, n_q, T]`` int32, every layer in one
call, the residual peeled in f32 between layers.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`rvq_encode_plain`, the per-layer loop of
``prompt_tts_tpu/codec/rvq.py:rvq_encode``.  ``rvq_encode.launches``
counts calls that launched the kernel; :func:`rvq_plan` is its launch
shape (vectors a CTA, and the thread-block cluster that splits the codes).

The kernel takes its dot products in 3 x TF32 on the tensor cores (both
operands split into two TF32 parts, the lo.lo term dropped), about as
accurate as f32 but summed in another order than the plain version's
matrix product, so where two codes tie to within f32 rounding of the score
the two may choose differently.  :func:`index_contract` states what a run
holds them to: every vector whose indices differ must, at the first layer
where they differ, hold a near-tie in f64.  :func:`rvq_encode_tf32x3`
computes the kernel's scores in PyTorch (for the tests; never on the
encode path).

The kernel is also the op ``torch.ops.ptts.rvq_encode(embeddings,
codebooks)``: the launcher on CUDA tensors, :func:`rvq_encode_plain` on
CPU ones (``ops/cuda/library.py``).
"""

import ctypes
import math
from typing import NamedTuple

import torch

from prompt_tts_tpu_torch.ops.cuda import _build, opcount
from prompt_tts_tpu_torch.ops.cuda.library import LIB, traced

DIM = 128          # the code dim the kernel takes
CODE_TILE = 64     # K must be a multiple of the kernel's code tile
SMS = 132          # an H100 SXM's SMs: rvq_plan's default
CLUSTERS = (1, 2, 4, 8)   # CTAs a cluster may split the codes over
# |s64(a) - s64(b)| <= NEAR_TIE * (|r| + max(|e_a|, |e_b|))^2 at the first
# differing layer: f32 rounding of a 128-term dot product and of the
# |r|^2 and |e|^2 terms, on both sides, is ~1e-6 of that scale.
NEAR_TIE = 1e-5


def codebook_quantize(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest codebook indices: ``x [..., D]``, ``embed [K, D]`` ->
    ``[...]`` int64.

    score = -(|x|^2 - 2 x.E^T + |E|^2), the formula and order of the JAX
    package and of torch EnCodec; |x|^2 does not move the argmax but is
    kept, so the scores round as theirs do.  The first index wins ties.
    """
    flat = x.reshape(-1, x.shape[-1]).float()
    e = embed.float()
    x_sq = torch.sum(flat * flat, dim=1, keepdim=True)
    e_sq = torch.sum(e * e, dim=1)[None, :]
    scores = -(x_sq - 2.0 * flat @ e.T + e_sq)
    return torch.argmax(scores, dim=-1).reshape(x.shape[:-1])


def rvq_encode_plain(embeddings: torch.Tensor,
                     codebooks: torch.Tensor) -> torch.Tensor:
    """``[B, T, D]`` x ``[n_q, K, D]`` -> ``[B, n_q, T]`` int32: for each
    layer, quantize the residual and subtract the chosen code in f32."""
    residual = embeddings.float()
    indices = []
    for embed in codebooks.float():
        idx = codebook_quantize(residual, embed)
        residual = residual - embed[idx]
        indices.append(idx)
    return torch.stack(indices, dim=1).to(torch.int32)


class RvqPlan(NamedTuple):
    """The kernel's launch shape: ``bm`` vectors a CTA (64: one consumer
    warpgroup; 128: two, which share every code tile), ``cluster`` CTAs
    that split each layer's codes between them, ``ctas`` in the grid."""
    bm: int
    cluster: int
    ctas: int


def rvq_plan(N: int, n_q: int, K: int, sms: int = SMS) -> RvqPlan:
    """The launch shape for ``N`` vectors and ``n_q`` codebooks of ``K``
    codes on a card of ``sms`` SMs, as ``csrc/rvq.cu`` takes it.

    128 vectors a CTA where those tiles alone fill the SMs, else 64; then
    the smallest cluster whose grid covers the SMs and whose share of the
    codes, ``K / cluster``, is a whole number of 64-code tiles (the largest
    such cluster where none covers them).  Raises on what the kernel cannot
    take."""
    if N <= 0 or n_q <= 0 or K <= 0 or K % CODE_TILE:
        raise ValueError(f"rvq_plan: the kernel takes K a multiple of "
                         f"{CODE_TILE} and non-empty inputs; got N={N} "
                         f"n_q={n_q} K={K}")
    bm = 128 if math.ceil(N / 128) >= sms else 64
    tiles = math.ceil(N / bm)
    fits = [c for c in CLUSTERS if K % (CODE_TILE * c) == 0]
    c = next((c for c in fits if tiles * c >= sms), fits[-1])
    return RvqPlan(bm, c, tiles * c)


def _lib():
    lib = _build.load("rvq")
    fn = lib.ptts_rvq_encode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ptts_rvq_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.ptts_rvq_scratch_floats.restype = ctypes.c_longlong
    return lib


def _launch(embeddings: torch.Tensor, codebooks: torch.Tensor,
            plan: RvqPlan) -> torch.Tensor:
    """Launch the kernel with the launch shape ``plan`` (checked inputs)."""
    B, T, D = embeddings.shape
    n_q, K, _ = codebooks.shape
    dev = embeddings.device
    lib = _lib()
    out = torch.empty(B, n_q, T, dtype=torch.int32, device=dev)
    scratch = torch.empty(
        lib.ptts_rvq_scratch_floats(B * T, n_q, K, plan.bm, plan.cluster),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ptts_rvq_encode(
            embeddings.data_ptr(), codebooks.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B * T, T, n_q, K, D, plan.bm, plan.cluster,
            _build.stream_handle(dev))
    _build.check(err, "RVQ kernel launch")
    return out


def rvq_encode(embeddings: torch.Tensor,
               codebooks: torch.Tensor) -> torch.Tensor:
    """Residual VQ encode: ``[B, T, D]`` x ``[n_q, K, D]`` -> ``[B, n_q, T]``
    int32 code indices."""
    if embeddings.dim() != 3 or codebooks.dim() != 3:
        raise ValueError("rvq_encode: embeddings [B,T,D], codebooks [n_q,K,D]")
    B, T, D = embeddings.shape
    n_q, K, Dc = codebooks.shape
    if Dc != D:
        raise ValueError(f"rvq_encode: embedding dim {D} != codebook dim "
                         f"{Dc}")
    if traced():
        return torch.ops.ptts.rvq_encode(embeddings, codebooks)
    if embeddings.device.type == "cpu":
        return rvq_encode_plain(embeddings, codebooks)
    return _encode_cuda(embeddings, codebooks)


def _encode_cuda(embeddings: torch.Tensor,
                 codebooks: torch.Tensor) -> torch.Tensor:
    """Check the inputs, plan and launch the kernel."""
    B, T, D = embeddings.shape
    n_q, K, Dc = codebooks.shape
    if Dc != D:
        raise ValueError(f"rvq_encode: embedding dim {D} != codebook dim "
                         f"{Dc}")
    if embeddings.device.type != "cuda" or \
            codebooks.device != embeddings.device:
        raise ValueError(f"rvq_encode: embeddings on {embeddings.device}, "
                         f"codebooks on {codebooks.device}")
    if embeddings.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise ValueError("rvq_encode: embeddings and codebooks must be "
                         "float32")
    if not (embeddings.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError("rvq_encode: inputs must be contiguous")
    if embeddings.data_ptr() % 16 or codebooks.data_ptr() % 16:
        raise ValueError("rvq_encode: the kernel takes 16-byte aligned "
                         "inputs")
    if D != DIM or K % CODE_TILE or B * T == 0 or n_q == 0:
        raise ValueError(f"rvq_encode: the kernel takes D = {DIM}, K a "
                         f"multiple of {CODE_TILE} and non-empty inputs; got "
                         f"B={B} T={T} n_q={n_q} K={K} D={D}")
    sms = torch.cuda.get_device_properties(embeddings.device) \
        .multi_processor_count
    out = _launch(embeddings, codebooks, rvq_plan(B * T, n_q, K, sms))
    rvq_encode.launches += 1
    opcount.record(opcount.rvq_encode(B * T, n_q, K, D))
    return out


rvq_encode.launches = 0


def _encode_fake(embeddings: torch.Tensor,
                 codebooks: torch.Tensor) -> torch.Tensor:
    B, T, _ = embeddings.shape
    return embeddings.new_empty(B, codebooks.shape[0], T, dtype=torch.int32)


LIB.define("rvq_encode(Tensor embeddings, Tensor codebooks) -> Tensor")
LIB.impl("rvq_encode", rvq_encode_plain, "CPU")
LIB.impl("rvq_encode", _encode_cuda, "CUDA")
torch.library.register_fake("ptts::rvq_encode", _encode_fake, lib=LIB)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds it: half of the dropped
    13 bits' range added to the magnitude bits, then those bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi = rna(x)``, ``lo = rna(x - hi)``, the kernel's
    split of each operand."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def distances_tf32x3(r: torch.Tensor, e: torch.Tensor,
                     e_sq: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` distances ``(|r|^2 - 2 r.e) + |e|^2`` with ``r.e`` in
    3 x TF32 as the kernel takes it: ``(hi_r.lo_e + lo_r.hi_e) +
    hi_r.hi_e`` (each product of two TF32 values exact in f32), f32 sums
    (on the card, under TF32 off)."""
    rh, rl = split_tf32(r)
    eh, el = split_tf32(e)
    dot = (rh @ el.T + rl @ eh.T) + rh @ eh.T
    r_sq = torch.sum(r * r, dim=1, keepdim=True)
    return (r_sq - 2.0 * dot) + e_sq[None, :]


def rvq_encode_tf32x3(embeddings: torch.Tensor,
                      codebooks: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``[B, T, D]`` x ``[n_q, K, D]``
    -> ``[B, n_q, T]`` int32 from :func:`distances_tf32x3` (the first
    index wins ties), the residual peeled in f32.  For the tests; the
    encode path never calls it."""
    B, T, D = embeddings.shape
    r = embeddings.reshape(-1, D).float()
    indices = []
    for e in codebooks.float():
        idx = torch.argmin(distances_tf32x3(r, e, torch.sum(e * e, dim=1)),
                           dim=1)
        r = r - e[idx]
        indices.append(idx)
    return torch.stack(indices, dim=1).reshape(B, T, -1).transpose(1, 2) \
        .to(torch.int32)


def index_contract(embeddings: torch.Tensor, codebooks: torch.Tensor,
                   got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Hold two encodings of the same inputs to each other.

    For each vector whose indices differ, take the first layer where they
    do: up to it both sides peeled the same codes in f32, so both held the
    residual ``r`` rebuilt here.  There the two chosen codes ``a`` and
    ``b`` must score a near-tie in f64:
    ``|s64(a) - s64(b)| <= NEAR_TIE * (|r| + max(|e_a|, |e_b|))^2``.
    Returns the count of vectors, of differing vectors, of differing
    vectors that break the rule, the largest score gap and the largest gap
    over its limit."""
    n_q, _, D = codebooks.shape
    a = got.transpose(1, 2).reshape(-1, n_q).long()
    b = ref.transpose(1, 2).reshape(-1, n_q).to(a.device).long()
    x = embeddings.reshape(-1, D).float()
    cbs = codebooks.float()
    differ = (a != b).any(dim=1)
    nd = int(differ.sum())
    worst, max_gap, bad = 0.0, 0.0, 0
    if nd:
        a, b, r = a[differ], b[differ], x[differ]
        first = (a != b).int().argmax(dim=1)
        for q in range(n_q):
            at = first == q
            if at.any():
                rd = r[at].double()
                ea, eb = (cbs[q][c[at, q]].double() for c in (a, b))
                # s(a) - s(b) = 2 r.(e_a - e_b) - |e_a|^2 + |e_b|^2
                gap = (2.0 * (rd * (ea - eb)).sum(1)
                       - (ea * ea).sum(1) + (eb * eb).sum(1)).abs()
                scale = (rd.norm(dim=1) + torch.maximum(
                    ea.norm(dim=1), eb.norm(dim=1))) ** 2
                ratio = gap / (NEAR_TIE * scale)
                bad += int((ratio > 1.0).sum())
                worst = max(worst, float(ratio.max()))
                max_gap = max(max_gap, float(gap.max()))
            r = r - cbs[q][a[:, q]]    # both sides' codes for layers < first
    return {"vectors": x.shape[0], "differ": nd, "violations": bad,
            "max_score_gap": max_gap, "worst_gap_over_limit": worst}
