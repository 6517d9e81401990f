"""LSTM recurrence: the PyTorch port against the JAX package.

The port's plain recurrence (the CPU path of the CUDA kernel's wrapper) is
held against the JAX TPU kernel ``lstm_recurrence`` in Pallas interpret
mode, and the port's ``CodecLSTM`` (which calls the wrapper) against the
JAX ``CodecLSTM`` scan.  Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.codec.layers import CodecLSTM as JaxCodecLSTM
from prompt_tts_tpu.ops.pallas.lstm import lstm_recurrence as jax_lstm
from prompt_tts_tpu_torch.codec.layers import CodecLSTM
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_plain,
)

# f32 on both sides; only the order of the [B,H]x[H,4H] sums differs, and
# 70 recurrent steps of bounded gates keep the drift well under 1e-5.
TOL = 1e-5


def test_plain_matches_pallas_kernel_interpret():
    """T=70 with block_t=32 covers the kernel's time padding."""
    rng = np.random.default_rng(0)
    T, B, H = 70, 2, 32
    xp = rng.standard_normal((T, B, 4 * H), dtype=np.float32) * 0.5
    w = rng.standard_normal((H, 4 * H), dtype=np.float32) * 0.1
    with pltpu.force_tpu_interpret_mode():
        ref = jax_lstm(jnp.asarray(xp), jnp.asarray(w), block_t=32)
    out = lstm_recurrence_plain(torch.from_numpy(xp), torch.from_numpy(w))
    assert out.shape == (T, B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_codec_lstm_matches_jax_scan():
    rng = np.random.default_rng(1)
    B, T, C, H = 2, 40, 16, 16
    x = rng.standard_normal((B, T, C), dtype=np.float32)
    params = {}
    for layer in range(2):
        cin = C if layer == 0 else H
        params[f"l{layer}_w_ih"] = rng.standard_normal(
            (4 * H, cin), dtype=np.float32) * 0.2
        params[f"l{layer}_w_hh"] = rng.standard_normal(
            (4 * H, H), dtype=np.float32) * 0.2
        params[f"l{layer}_b"] = rng.standard_normal(
            (4 * H,), dtype=np.float32) * 0.1
    ref = JaxCodecLSTM(hidden=H, num_layers=2).apply(
        {"params": {k: jnp.asarray(v) for k, v in params.items()}},
        jnp.asarray(x))
    port = CodecLSTM(C, H, num_layers=2)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    before = lstm_recurrence.launches
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert lstm_recurrence.launches == before   # CPU tensors: plain path
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="4\\*H"):
        lstm_recurrence(torch.zeros(5, 2, 12), torch.zeros(4, 16))
