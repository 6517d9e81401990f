"""Attention: the PyTorch port against the JAX package.

The port's plain attention (``attention_plain``, the CPU path of the
dispatcher and of the CUDA kernel's wrapper) is held against the JAX TPU
kernel ``flash_attention`` run in Pallas interpret mode, and against the
JAX ``_xla_attention`` it ports.  Inputs come from a numpy seed and go to
both sides.  The CUDA kernel itself is compared with the plain version on
the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.ops.attention import _xla_attention
from prompt_tts_tpu.ops.pallas.attention import flash_attention as jax_flash
from prompt_tts_tpu_torch.ops.attention import (
    attention_plain, flash_attention_plain, scaled_dot_product_attention,
)
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention

# f32 against f32: the two sides differ only in summation order (the
# Pallas kernel pads keys to 128 and sums in another order), so 1e-5
# absolute on O(1) outputs.
F32_TOL = 1e-5
# bf16: both sides store bf16 scores and probabilities; rounding at
# slightly different places gives up to a few bf16 ulps on O(1) outputs
# (bf16 eps is 2^-8 = 3.9e-3).
BF16_TOL = 2e-2


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits), for normal x."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _inputs(seed, B, Tq, Tk, H, D, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Tk, H, D), dtype=np.float32)
    v = rng.standard_normal((B, Tk, H, D), dtype=np.float32)
    bias = None
    if masked:
        mask = np.ones((B, Tk), np.float32)
        mask[0, Tk // 2:] = 0.0          # padded text keys
        mask[-1, 5:] = 0.0
        bias = ((1.0 - mask) * -1e4)[:, None, None, :]
    return q, k, v, bias


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


@pytest.mark.parametrize("D", [32, 96])
def test_plain_matches_pallas_flash_interpret(D):
    """Ragged Tq/Tk (tails inside the kernel's 128 padding), masked keys."""
    q, k, v, bias = _inputs(0, 2, 70, 45, 2, D)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(_j(q), _j(k), _j(v), bias=_j(bias))
    out = attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=0)


@pytest.mark.parametrize("D", [32, 96])
def test_flash_plain_matches_pallas_flash_interpret_bf16(D):
    """``flash_attention_plain`` (what the bf16 CUDA kernel computes) against
    the TPU kernel in interpret mode at bf16: ragged Tq/Tk, masked keys.
    Both take f32 scores and statistics and round the unnormalised p to
    bf16 for PV; the f32 sums run in another order, so the two outputs may
    round to neighbouring bf16 values: at most one bf16 ulp of |out|."""
    q, k, v, bias = _inputs(5, 2, 70, 45, 2, D)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash(jq, jk, jv, bias=_j(bias))
                         .astype(jnp.float32))
    out = flash_attention_plain(q, k, v, _t(bias))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = np.abs(out.float().numpy() - ref)
    assert (err <= _bf16_ulp(ref)).all(), err.max()


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_xla_attention_f32(masked):
    q, k, v, bias = _inputs(1, 2, 37, 29, 3, 64, masked)
    ref = _xla_attention(_j(q), _j(k), _j(v), _j(bias))
    out = attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=0)


def test_plain_matches_xla_attention_bf16():
    q, k, v, bias = _inputs(2, 2, 41, 33, 2, 32)
    # round once to bf16 so both sides start from the same bf16 values
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v))
    ref = _xla_attention(jq, jk, jv, _j(bias))
    out = attention_plain(q, k, v, _t(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=0)


def test_cpu_dispatch_takes_plain_path():
    q, k, v, bias = _inputs(3, 2, 19, 23, 2, 32)
    before = flash_attention.launches
    out = scaled_dot_product_attention(_t(q), _t(k), _t(v), _t(bias))
    assert flash_attention.launches == before
    ref = attention_plain(_t(q), _t(k), _t(v), _t(bias))
    assert torch.equal(out, ref)


def test_rejects_bias_that_is_not_key_only():
    q, k, v, _ = _inputs(4, 2, 8, 8, 2, 32, masked=False)
    with pytest.raises(ValueError, match="key-only"):
        scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                     torch.zeros(2, 2, 8, 8))
