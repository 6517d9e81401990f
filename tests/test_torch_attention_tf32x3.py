"""The f32 attention kernels' arithmetic, 3 x TF32, against JAX's f32 attention.

The f32 paths of both CUDA attention kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``) run every ``[T,T,D]`` product on the tensor cores
in TF32: each operand is split as ``hi = rna(x)``, ``lo = rna(x - hi)``
(``cvt.rna.tf32.f32``), and a product is ``hi.lo + lo.hi + hi.hi`` with
f32 accumulation.  Here that arithmetic is emulated in PyTorch on the CPU,
in the kernels' order of operations (scores, the softmax in log2 units,
the unnormalised p split for P V, the division by the row sum; the
backward from the forward's lse, with ds * scale split for its products),
and held against JAX's f32 attention (``_xla_attention`` and ``jax.vjp``
of it) on the same numpy inputs, at the card's own tolerances.  A single
TF32 product misses them: that is why the kernels take three.  The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.ops.attention import _xla_attention
from prompt_tts_tpu_torch.ops.cuda.rvq import split_tf32, tf32_rna

# The card's tolerances (chip_smoke.py): the forward 2e-5 absolute; the
# backward per output 2e-5 * (1 + max |ref|); a batch row whose keys are
# all masked (scores at -1e4, where an f32 ulp is ~1e-3) 5e-3 for both.
ATTN_TOL_F32 = 2e-5
BWD_TOL = 2e-5
TOL_ALL_MASKED = 5e-3
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# Ragged tails (65 rows, 130 keys: neither a multiple of the kernels' 64);
# batch row 0 keeps its first 100 keys, row 1 has every key masked.
B, TQ, TK, H = 2, 65, 130, 2
KEEP = 100


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tier-1 shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(D, seed=0):
    rng = np.random.default_rng(seed + D)
    q, k, v = (rng.standard_normal((B, T, H, D), dtype=np.float32)
               for T in (TQ, TK, TK))
    do = rng.standard_normal((B, TQ, H, D), dtype=np.float32)
    mask = np.zeros((B, TK), np.float32)
    mask[0, :KEEP] = 1.0
    bias = ((1.0 - mask) * -1e4)[:, None, None, :]
    return q, k, v, bias, do


def _mm3(eq, a, b):
    """``einsum(eq, a, b)`` in 3 x TF32: ``(hi.lo + lo.hi) + hi.hi``, the
    small terms first, each product of two TF32 values exact in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) \
        + torch.einsum(eq, ah, bh)


def _mm1(eq, a, b):
    """``einsum(eq, a, b)`` in one TF32 product."""
    return torch.einsum(eq, tf32_rna(a), tf32_rna(b))


def _forward(q, k, v, bias, mm):
    """The forward kernel's arithmetic: ``(o, lse)``.  Scores to log2 units
    with the scale and the bias (``fmaf(s, scale log2e, bias log2e)``), the
    row max, ``exp2``, the row sum; the unnormalised p times v, divided by
    the sum; ``lse = (m + log2 l) ln 2``."""
    scale_log2 = q.shape[-1] ** -0.5 * LOG2E
    s = mm("bqhd,bkhd->bhqk", q, k)
    x = s * scale_log2 + bias * LOG2E
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(dim=-1, keepdim=True)
    o = mm("bhqk,bkhd->bqhd", p, v) / l.permute(0, 2, 1, 3)
    return o, ((m + torch.log2(l)) * LN2)[..., 0]


def _backward(q, k, v, bias, o, lse, do, mm):
    """The backward kernels' arithmetic: ``(dq, dk, dv, dbias)``.  p
    recomputed from the lse in log2 units, ``delta = rowsum(do o)``,
    ``ds = p (do v^T - delta)``; ds * scale split for dq and dk, p for
    dv; the bias gradient sums ds over heads and rows."""
    scale = q.shape[-1] ** -0.5
    s = mm("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s * (scale * LOG2E) + bias * LOG2E
                   - (lse * LOG2E)[..., None])
    delta = (do * o).sum(dim=-1).permute(0, 2, 1)[..., None]
    dp = mm("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta)
    dss = ds * scale
    return (mm("bhqk,bkhd->bqhd", dss, k), mm("bhqk,bqhd->bkhd", dss, q),
            mm("bhqk,bqhd->bkhd", p, do), ds.sum(dim=(1, 2))[:, None, None])


def _jax(q, k, v, bias, do):
    """JAX's f32 attention and its vjp: ``(o, (dq, dk, dv, dbias))``."""
    o, vjp = jax.vjp(_xla_attention, *(jnp.asarray(x) for x in
                                       (q, k, v, bias)))
    return np.asarray(o), tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _fwd_errors(o, ref):
    """Max |err| of the forward over batch row 0 and, apart, row 1 (all
    keys masked)."""
    err = (o.numpy() - ref).__abs__()
    return float(err[0].max()), float(err[1].max())


def _bwd_over(got, ref):
    """Per output, max |err| / (1 + max |ref|) over batch row 0 and over
    row 1 (all keys masked)."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        err = np.abs(a.numpy() - b)
        top = 1.0 + float(np.abs(b).max())
        out[name] = (float(err[0].max()) / top, float(err[1].max()) / top)
    return out


@pytest.fixture(scope="module", params=[32, 64, 96], ids=lambda d: f"D{d}")
def case(request):
    """One head dim's inputs, JAX's results and the 3 x TF32 forward."""
    q, k, v, bias, do = _inputs(request.param)
    ref_o, ref_g = _jax(q, k, v, bias, do)
    qt, kt, vt, bt, dot = _torch(q, k, v, bias, do)
    o, lse = _forward(qt, kt, vt, bt, _mm3)
    return {"t": (qt, kt, vt, bt, dot), "ref_o": ref_o, "ref_g": ref_g,
            "o": o, "lse": lse}


def test_tf32x3_forward_matches_jax_f32(case):
    """Within ATTN_TOL_F32 of JAX's f32 attention (the all-masked row within
    TOL_ALL_MASKED), and the lse is the f64 log-sum-exp of the scaled,
    biased scores."""
    err, err_masked = _fwd_errors(case["o"], case["ref_o"])
    assert err <= ATTN_TOL_F32, err
    assert err_masked <= TOL_ALL_MASKED, err_masked
    q, k, _, bias, _ = (x.double() for x in case["t"])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1]) + bias
    want = torch.logsumexp(s, dim=-1)
    assert (case["lse"].double() - want).abs()[0].max() <= 1e-5
    assert (case["lse"].double() - want).abs()[1].max() <= 1e-2


def test_tf32x3_backward_matches_jax_f32(case):
    """dq, dk, dv and the bias gradient within BWD_TOL (relative to
    1 + max |ref|) of ``jax.vjp`` of the f32 attention, from the 3 x TF32
    forward's own o and lse as the kernels take them; the all-masked row
    within TOL_ALL_MASKED."""
    q, k, v, bias, do = case["t"]
    got = _backward(q, k, v, bias, case["o"], case["lse"], do, _mm3)
    for name, (err, err_masked) in _bwd_over(got, case["ref_g"]).items():
        assert err <= BWD_TOL, (name, err)
        assert err_masked <= TOL_ALL_MASKED, (name, err_masked)


def test_one_tf32_product_misses_the_contract(case):
    """The same arithmetic with one TF32 product (operands rounded once)
    misses ATTN_TOL_F32 in the forward and BWD_TOL in the backward."""
    q, k, v, bias, do = case["t"]
    o, lse = _forward(q, k, v, bias, _mm1)
    err, _ = _fwd_errors(o, case["ref_o"])
    assert err > ATTN_TOL_F32, err
    got = _backward(q, k, v, bias, o, lse, do, _mm1)
    worst = max(e for e, _ in _bwd_over(got, case["ref_g"]).values())
    assert worst > BWD_TOL, worst
