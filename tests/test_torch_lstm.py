"""LSTM recurrence: the PyTorch port against the JAX package.

The port's plain recurrences (the CPU paths of the two CUDA kernels'
wrappers) are held against the JAX TPU kernels ``lstm_recurrence`` and
``lstm_recurrence_t`` in Pallas interpret mode, and the port's ``CodecLSTM``
(which calls a wrapper, in the schedule it is given) against the JAX
``CodecLSTM`` scan.  Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.codec.layers import CodecLSTM as JaxCodecLSTM
from prompt_tts_tpu.ops.pallas.lstm import lstm_recurrence as jax_lstm
from prompt_tts_tpu.ops.pallas.lstm import lstm_recurrence_t as jax_lstm_t
from prompt_tts_tpu_torch.codec.layers import CodecLSTM
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    STEP_SMEM_MAX, UNITS_PER_CTA, lstm_plan, lstm_recurrence,
    lstm_recurrence_plain, lstm_recurrence_t, lstm_recurrence_t_plain,
)

# f32 on both sides; only the order of the [B,H]x[H,4H] sums differs, and
# 70 recurrent steps of bounded gates keep the drift well under 1e-5.
TOL = 1e-5
# The transposed schedule at the JAX kernel test's shape: f32 both sides,
# h @ W^T summed in torch's order and in XLA's; 70 steps of bounded gates.
TOL_T = 1e-6


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


def test_plain_t_matches_pallas_kernel_t_interpret():
    """lstm_recurrence_t at T=70, B=8, H=64; block_t=32 covers its time
    padding."""
    rng = np.random.default_rng(2)
    T, B, H = 70, 8, 64
    xp = rng.standard_normal((T, B, 4 * H), dtype=np.float32) * 0.5
    w = rng.standard_normal((4 * H, H), dtype=np.float32) * 0.1
    with pltpu.force_tpu_interpret_mode():
        ref = jax_lstm_t(jnp.asarray(xp), jnp.asarray(w), block_t=32)
    before = lstm_recurrence_t.launches
    out = lstm_recurrence_t(torch.from_numpy(xp), torch.from_numpy(w))
    assert lstm_recurrence_t.launches == before    # CPU: the plain version
    assert out.shape == (T, B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL_T,
                               rtol=0)
    np.testing.assert_allclose(
        lstm_recurrence_t_plain(torch.from_numpy(xp),
                                torch.from_numpy(w)).numpy(),
        out.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("schedule", ["step", "persistent", None])
def test_codec_lstm_matches_jax_scan(schedule):
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
    before = lstm_recurrence.launches + lstm_recurrence_t.launches
    with torch.no_grad():
        out = port(torch.from_numpy(x), schedule)
    # CPU tensors: the plain versions
    assert lstm_recurrence.launches + lstm_recurrence_t.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="4\\*H"):
        lstm_recurrence(torch.zeros(5, 2, 12), torch.zeros(4, 16))


def test_codec_lstm_schedules_agree_and_refuse_unknown():
    rng = np.random.default_rng(3)
    port = CodecLSTM(16, 16, num_layers=2)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32) * 0.2))
        x = torch.from_numpy(rng.standard_normal((3, 25, 16),
                                                 dtype=np.float32))
        step, persistent = port(x, "step"), port(x, "persistent")
        np.testing.assert_allclose(step.numpy(), persistent.numpy(),
                                   atol=1e-6, rtol=0)
        with pytest.raises(ValueError, match="schedule"):
            port(x, "scan")


@pytest.mark.parametrize("schedule", ["step", "persistent"])
def test_plain_matches_pallas_at_a_wide_batch(schedule):
    """B = 32 at H = 32, T = 40: a batch that fills the kernels' 32-row
    chunk and its 8 x 8 register tiles; each plain version against its
    Pallas kernel in interpret mode (block_t = 32 pads T)."""
    rng = np.random.default_rng(4)
    T, B, H = 40, 32, 32
    xp = rng.standard_normal((T, B, 4 * H), dtype=np.float32) * 0.5
    w = rng.standard_normal((H, 4 * H), dtype=np.float32) * 0.1
    if schedule == "step":
        jax_fn, plain, w = jax_lstm, lstm_recurrence_plain, w
    else:
        jax_fn, plain, w = jax_lstm_t, lstm_recurrence_t_plain, \
            np.ascontiguousarray(w.T)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fn(jnp.asarray(xp), jnp.asarray(w), block_t=32)
    out = plain(torch.from_numpy(xp), torch.from_numpy(w))
    assert out.shape == (T, B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("schedule", ["step", "persistent"])
def test_codec_lstm_matches_jax_scan_at_the_encoder_batch(schedule):
    """CodecLSTM at B = 32, generate_codes' batch, in both schedules."""
    rng = np.random.default_rng(5)
    B, T, C, H = 32, 24, 16, 16
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
    with torch.no_grad():
        out = port(torch.from_numpy(x), schedule)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


# lstm_plan at the paths' shapes (T does not enter it): the decoder's and
# the prompt encode's B = 4 and the encoder's B = 32 at the codec's H = 512,
# with the shared memory each kernel lays out (csrc/lstm.cuh:layout, in
# floats: W 16 H, the h chunk, x_proj 16 a row, the partial sums, the cell
# state of a chunk or of every row).
@pytest.mark.parametrize("schedule,B,chunk,floats", [
    ("step", 4, 4, 16 * 512 + 4 * 512 + 16 * 4 + 2 * 16 * 4 + 4 * 4),
    ("persistent", 4, 4, 16 * 512 + 4 * 512 + 16 * 4 + 2 * 16 * 4 + 4 * 4),
    ("step", 32, 32, 16 * 512 + 32 * 512 + 16 * 32 + 16 * 32 + 4 * 32),
    ("persistent", 32, 32, 16 * 512 + 32 * 512 + 16 * 32 + 16 * 32 + 4 * 32),
    ("persistent", 100, 32,
     16 * 512 + 32 * 512 + 16 * 32 + 16 * 32 + 4 * 100),
])
def test_lstm_plan_at_the_path_shapes(schedule, B, chunk, floats):
    plan = lstm_plan(schedule, B, 512)
    assert plan == {"ctas": 512 // UNITS_PER_CTA, "chunk": chunk,
                    "smem": 4 * floats}
    # the step kernel leaves room for a second CTA on an SM
    assert schedule != "step" or plan["smem"] <= STEP_SMEM_MAX


def test_lstm_plan_refuses():
    """The step kernel's largest H at B >= 32 is 576 (two CTAs an SM);
    580 is refused, as is an H no multiple of the units a CTA owns, in both
    schedules.  The persistent kernel has no shared-memory rule here: its
    grid's co-residency is the card's to decide."""
    assert lstm_plan("step", 32, 576)["smem"] <= STEP_SMEM_MAX
    with pytest.raises(ValueError, match="two CTAs an SM"):
        lstm_plan("step", 32, 580)
    assert lstm_plan("persistent", 32, 580)["ctas"] == 145
    for schedule in ("step", "persistent"):
        with pytest.raises(ValueError, match="multiple of 4"):
            lstm_plan(schedule, 4, 510)
