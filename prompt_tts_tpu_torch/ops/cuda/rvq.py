"""Wrapper of the hand-written residual-VQ encode kernel (``csrc/rvq.cu``).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/rvq.py:
rvq_encode_fused``: embeddings ``[B, T, D]`` f32 and codebooks
``[n_q, K, D]`` f32 -> indices ``[B, n_q, T]`` int32, every layer in one
call, the residual peeled in f32 between layers.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`rvq_encode_plain`, the per-layer loop of
``prompt_tts_tpu/codec/rvq.py:rvq_encode``.  ``rvq_encode.launches``
counts calls that launched the kernel.

The kernel sums its dot products in another order than the plain
version's matrix product, so where two codes tie to within f32 rounding of
the score the two may choose differently.  :func:`index_contract` states
what a run holds them to: every vector whose indices differ must, at the
first layer where they differ, hold a near-tie in f64.
"""

import ctypes

import torch

from prompt_tts_tpu_torch.ops.cuda import _build

DIM = 128          # the code dim the kernel takes
CODE_TILE = 64     # K must be a multiple of the kernel's code tile
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


def _fn():
    lib = _build.load("rvq")
    fn = lib.ptts_rvq_encode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    if embeddings.device.type == "cpu":
        return rvq_encode_plain(embeddings, codebooks)
    if embeddings.device.type != "cuda" or \
            codebooks.device != embeddings.device:
        raise ValueError(f"rvq_encode: embeddings on {embeddings.device}, "
                         f"codebooks on {codebooks.device}")
    if embeddings.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise ValueError("rvq_encode: embeddings and codebooks must be "
                         "float32")
    if not (embeddings.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError("rvq_encode: inputs must be contiguous")
    if D != DIM or K % CODE_TILE or B * T == 0 or n_q == 0:
        raise ValueError(f"rvq_encode: the kernel takes D = {DIM}, K a "
                         f"multiple of {CODE_TILE} and non-empty inputs; got "
                         f"B={B} T={T} n_q={n_q} K={K} D={D}")
    dev = embeddings.device
    out = torch.empty(B, n_q, T, dtype=torch.int32, device=dev)
    cb_t = torch.empty(n_q, D, K, dtype=torch.float32, device=dev)
    esq = torch.empty(n_q, K, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn()(embeddings.data_ptr(), codebooks.data_ptr(),
                    cb_t.data_ptr(), esq.data_ptr(), out.data_ptr(),
                    B * T, T, n_q, K, D, _build.stream_handle(dev))
    _build.check(err, "RVQ kernel launch")
    rvq_encode.launches += 1
    return out


rvq_encode.launches = 0


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
