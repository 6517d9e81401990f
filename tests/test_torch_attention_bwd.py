"""The port's attention backward against the JAX fused backward kernel.

The port's ``AttentionFunction`` on CPU tensors (``attention_plain``
forward, ``attention_bwd_plain`` backward, which is what the CUDA kernel's
wrapper runs on the CPU) against ``attention_fused_bwd`` with its Pallas
backward kernel in interpret mode, on the same numpy-seeded inputs and the
same output cotangent; and against torch autograd of ``attention_plain``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.ops.pallas.attention_bwd import attention_fused_bwd
from prompt_tts_tpu_torch.ops.attention import (
    AttentionFunction, attention_bwd_plain, attention_plain,
    scaled_dot_product_attention,
)
from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd

# f32: the same math on both sides, sums in another order (the JAX test's
# own tolerance against autodiff, tests/test_attention_bwd.py).
TOL_F32 = 2e-5
# bf16: both sides round p and ds to bf16 before their products, but at
# differently rounded probabilities; the JAX test's bf16 tolerance.
TOL_BF16 = 0.08

# (B, Tq, Tk, H, D): tests/test_attention_bwd.py:45-49
SHAPES = [
    (2, 113, 113, 4, 32),
    (2, 129, 57, 2, 64),
    (1, 48, 96, 3, 96),
]


def make_inputs(B, Tq, Tk, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    mask = rng.uniform(size=(B, Tk)) > 0.2
    mask[:, 0] = True          # no query row sees only masked keys
    bias = np.where(mask, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    w = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    return q, k, v, bias, w


def jax_grads(q, k, v, bias, w, dtype=jnp.float32):
    """dq, dk, dv (and dbias) of sum(o * w) through the Pallas backward."""
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    argnums = (0, 1, 2)
    if bias is not None:
        args.append(jnp.asarray(bias))
        argnums = (0, 1, 2, 3)

    def loss(*a):
        b = a[3] if bias is not None else None
        o = attention_fused_bwd(a[0], a[1], a[2], b)
        return jnp.sum(o.astype(jnp.float32) * w)

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=argnums)(*args)
    return [np.asarray(g, np.float32) for g in grads]


def torch_grads(fn, q, k, v, bias, w, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    b = None if bias is None else torch.tensor(bias, requires_grad=True)
    o = fn(*ts, b)
    (o.float() * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.float().numpy() for t in ts]
    if b is not None:
        grads.append(b.grad.numpy())
    return grads


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_pallas_backward(shape, with_bias):
    q, k, v, bias, w = make_inputs(*shape)
    bias = bias if with_bias else None
    ref = jax_grads(q, k, v, bias, w)
    got = torch_grads(AttentionFunction.apply, q, k, v, bias, w)
    for r, g, name in zip(ref, got, ("dq", "dk", "dv", "dbias")):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=TOL_F32, atol=TOL_F32,
                                   err_msg=f"{name} at {shape}")
    if with_bias:   # the bias gradient is real, not a silent zero
        assert np.abs(ref[3]).max() > 0


def test_bf16_matches_pallas_backward():
    q, k, v, bias, w = make_inputs(2, 113, 57, 4, 32)
    ref = jax_grads(q, k, v, bias, w, jnp.bfloat16)
    got = torch_grads(AttentionFunction.apply, q, k, v, bias, w,
                      torch.bfloat16)
    for r, g, name in zip(ref, got, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g, r, rtol=TOL_BF16, atol=TOL_BF16,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_autograd_of_plain(shape):
    """The hand-derived backward against torch autograd of the forward."""
    q, k, v, bias, w = make_inputs(*shape, seed=1)
    got = torch_grads(AttentionFunction.apply, q, k, v, bias, w)
    ref = torch_grads(attention_plain, q, k, v, bias, w)
    for r, g, name in zip(ref, got, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g, r, rtol=TOL_F32, atol=TOL_F32,
                                   err_msg=name)


def test_fully_masked_row_stays_finite():
    """A batch row whose keys are all masked (an empty text, or a dropped
    condition): the -1e4 bias keeps every gradient finite, and the plain
    backward follows autograd there too."""
    q, k, v, bias, w = make_inputs(2, 40, 30, 2, 32, seed=2)
    bias[1] = -1e4
    got = torch_grads(AttentionFunction.apply, q, k, v, bias, w)
    ref = torch_grads(attention_plain, q, k, v, bias, w)
    for r, g in zip(ref, got):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=TOL_F32, atol=TOL_F32)


def test_dispatcher_takes_the_function_only_for_grads():
    q, k, v, bias, _ = make_inputs(1, 16, 16, 2, 32)
    qt, kt, vt, bt = (torch.from_numpy(x) for x in (q, k, v, bias))
    out = scaled_dot_product_attention(qt, kt, vt, bt)
    assert out.grad_fn is None
    qt.requires_grad_()
    out = scaled_dot_product_attention(qt, kt, vt, bt)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    with torch.no_grad():
        assert scaled_dot_product_attention(qt, kt, vt, bt).grad_fn is None


def test_wrapper_on_cpu_runs_the_plain_backward():
    q, k, v, bias, w = (torch.from_numpy(x) for x in make_inputs(
        2, 20, 12, 2, 32))
    o = attention_plain(q, k, v, bias)
    before = attention_bwd.launches
    dq, dk, dv, db = attention_bwd(q, k, v, o, w, bias, need_dbias=True)
    ref = attention_bwd_plain(q, k, v, o, w, bias)
    for a, b in zip((dq, dk, dv, db), ref):
        assert torch.equal(a, b)
    assert attention_bwd(q, k, v, o, w, bias)[3] is None
    assert attention_bwd.launches == before   # no kernel ran
    with pytest.raises(ValueError, match="key-only"):
        attention_bwd(q, k, v, o, w, bias[:, :, :, :5])
    with pytest.raises(ValueError, match="without a bias"):
        attention_bwd(q, k, v, o, w, None, need_dbias=True)
