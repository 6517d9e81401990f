"""The CUDA kernels and the port's path on an NVIDIA GPU.

Each kernel against its plain PyTorch version on the card, the wrappers'
checks, and a small synthesis on the card against the same synthesis on
the CPU.  The kernels have no CPU mode, so every test here needs a card
(marker ``gpu``) and skips without one.  The card's machine has no jax,
so run them there without ``tests/conftest.py`` (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.unet1d import cross_attn_sites
from prompt_tts_tpu_torch.ops.attention import (
    attention_bwd_plain, attention_plain,
)
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
from prompt_tts_tpu_torch.ops.cuda.attention_bwd import (
    LAUNCHES_PER_CALL, attention_bwd,
)
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_plain,
)
from prompt_tts_tpu_torch.pipeline import (
    Synthesizer, full_f32, latents_to_codes, random_init_,
)
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.train.step import make_loss_fn, make_train_step

pytestmark = pytest.mark.gpu

# f32 kernel vs f32 plain: the same math, f32 sums in another order.
ATTN_TOL_F32 = 2e-5
# bf16 kernel vs the f32 plain version of the same bf16 inputs: the kernel
# keeps scores and probabilities in f32, so it differs only by rounding its
# output to bf16, at most half an ulp (2^-9 relative).
ATTN_RTOL_BF16 = 4e-3
# LSTM: f32 both sides, gate sums in another order, a contractive
# recurrence.
LSTM_TOL = 1e-5
# Synthesis on the card against the CPU, f32 (TF32 off): latents the
# model-level 5e-4 contract, the wav decoded from the same codes the
# codec's 1e-5 decode contract.
LATENT_TOL, WAV_TOL = 5e-4, 1e-5
# Attention backward, kernel vs the f32 plain backward of the same inputs,
# per output, |err| <= BWD_TOL * (1 + max|ref|): f32 sums in another order
# (delta = rowsum(do*o) and do.v^T cancel to ~1e-6 where p = 1).  bf16
# inputs: the kernel keeps p and ds in f32 and rounds dq/dk/dv to bf16 once,
# so it differs from the f32 plain version by that rounding (half an ulp,
# 2^-9 relative, rtol 4e-3); dbias is f32 on both sides.
BWD_TOL = 2e-5
# A batch row whose keys are all masked: its scores sit at -1e4, where an
# f32 ulp is ~1e-3, so both sides recompute p = exp(s + bias - lse) with
# ~1e-3 relative rounding; they agree to that, and stay finite.
BWD_TOL_ALL_MASKED = 5e-3
# One f32 train step on the card against the CPU (TF32 off): the loss to
# the model-level contract, the gradients in relative L2 per tensor (a
# tensor whose gradient is zero in exact arithmetic, a bias in front of a
# GroupNorm, is rounding noise on both sides and held below
# ZERO_GRAD * the global norm instead).
TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL, ZERO_GRAD = 1e-4, 1e-3, 1e-6

# Small widths whose head dims the attention kernel takes (32 and 64).
CARD_CFG = ModelConfig(
    block_out_channels=(128, 128, 256, 256), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
    sample_size=48, layers_per_block=1, unet_num_heads=4)
TEXTS = ["hello world", "printing, in the only sense"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(dev, B, Tq, Tk, H, D, dtype, masked, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
               for T in (Tq, Tk, Tk))
    bias = None
    if masked:   # request i keeps Tk >> i keys, the rest padded away
        keep = torch.arange(Tk, device=dev)[None, :] < (
            Tk >> torch.arange(B, device=dev))[:, None]
        bias = ((1.0 - keep.float()) * -1e4)[:, None, None, :]
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_kernel_matches_plain(dev, D, dtype):
    """Ragged Tq/Tk (one key, one row, tails of 63/65/113/550)."""
    for Tq, Tk, masked in ((1, 1, False), (63, 65, True), (113, 550, False),
                           (130, 7, True)):
        q, k, v, bias = _qkv(dev, 2, Tq, Tk, 3, D, dtype, masked)
        out = flash_attention(q, k, v, bias)
        ref = attention_plain(q.float(), k.float(), v.float(), bias)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=ATTN_TOL_F32, rtol=0)
        else:
            torch.testing.assert_close(out.float(), ref, atol=1e-4,
                                       rtol=ATTN_RTOL_BF16)


def test_attention_kernel_on_a_side_stream(dev):
    q, k, v, bias = _qkv(dev, 2, 70, 45, 2, 64, torch.float32, True)
    ref = flash_attention(q, k, v, bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = flash_attention(q, k, v, bias)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(out, ref)


def test_attention_wrapper_counts_and_checks(dev):
    q, k, v, bias = _qkv(dev, 2, 16, 24, 2, 32, torch.float32, True)
    before = flash_attention.launches
    flash_attention(q, k, v, bias)
    flash_attention(q, k, v)
    assert flash_attention.launches == before + 2
    bad = {
        "contiguous": (q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                       None),
        "head dim": (q[..., :16].contiguous(), k[..., :16].contiguous(),
                     v[..., :16].contiguous(), None),
        "not supported": (q.half(), k.half(), v.half(), None),
        "key-only": (q, k, v, torch.zeros(2, 1, 16, 24, device=dev)),
        "on cpu": (q, k.cpu(), v, None),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            flash_attention(*args)
    assert flash_attention.launches == before + 2


def test_attention_kernel_on_every_card(dev):
    """The shared-memory opt-in (D = 96/128 need > 48 KB) holds per device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        q, k, v, bias = _qkv(d, 1, 40, 40, 2, 128, torch.float32, False)
        with torch.cuda.device(d):
            out = flash_attention(q, k, v, bias)
        torch.testing.assert_close(out, attention_plain(q, k, v),
                                   atol=ATTN_TOL_F32, rtol=0)


@pytest.mark.parametrize("B,H", [(1, 32), (4, 512), (9, 64)])
def test_lstm_kernel_matches_plain(dev, B, H):
    """B = 9 takes two passes over the kernel's 8-row batch tile."""
    g = torch.Generator(dev).manual_seed(1)
    T = 60
    x = torch.randn(T, B, 4 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 4 * H, generator=g, device=dev) * H ** -0.5
    before = lstm_recurrence.launches
    with full_f32():
        out = lstm_recurrence(x, w)
        ref = lstm_recurrence_plain(x, w)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    torch.testing.assert_close(out, ref, atol=LSTM_TOL, rtol=0)


def test_lstm_wrapper_checks(dev):
    x = torch.zeros(5, 2, 96, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_recurrence(x, torch.zeros(24, 96, device=dev))
    with pytest.raises(ValueError, match="float32"):
        lstm_recurrence(x.double(), torch.zeros(24, 96, device=dev).double())


@pytest.fixture
def synth_pair(dev):
    config = Config(model=CARD_CFG)
    return {d: Synthesizer(config=config, device=d, dtype=torch.float32,
                           num_inference_steps=2) for d in ("cpu", "cuda")}


def test_synthesis_on_card_matches_cpu(synth_pair):
    """Same weights (drawn on CPU generators), same x_T, ids and mask."""
    cpu, card = synth_pair["cpu"], synth_pair["cuda"]
    ids, mask = cpu.tokenizer.encode_batch(TEXTS)
    x_T = torch.randn((len(TEXTS), CARD_CFG.sample_size, 8),
                      generator=torch.Generator().manual_seed(3))
    lat = {}
    for name, s in synth_pair.items():
        lat[name] = s.denoise_latents(
            x_T.to(s.device), torch.as_tensor(ids, device=s.device),
            torch.as_tensor(mask, device=s.device)).cpu()
    torch.testing.assert_close(lat["cuda"], lat["cpu"], atol=LATENT_TOL,
                               rtol=0)
    codes = latents_to_codes(lat["cpu"])
    assert (latents_to_codes(lat["cuda"]) - codes).abs().max() <= 1
    wav_card = card.codec_runner.decode(codes.cuda()).cpu()
    torch.testing.assert_close(wav_card, cpu.codec_runner.decode(codes),
                               atol=WAV_TOL, rtol=0)


def test_synthesize_bf16_launches_every_site(dev):
    """bf16 denoiser: one attention launch per text-encoder layer, two per
    UNet transformer and step (the cross k/v hoist runs no attention), and
    one LSTM launch per codec LSTM layer."""
    steps = 3
    synth = Synthesizer(config=Config(model=CARD_CFG), device=dev,
                        dtype=torch.bfloat16, num_inference_steps=steps)
    flash_attention.launches = lstm_recurrence.launches = 0
    wav, codes = synth.synthesize(TEXTS, seed=0, return_codes=True)
    n_sites = len(list(cross_attn_sites(CARD_CFG)))
    assert flash_attention.launches == (CARD_CFG.text_encoder_layers
                                        + 2 * n_sites * steps)
    assert lstm_recurrence.launches == 2
    assert wav.shape == (len(TEXTS), CARD_CFG.sample_size * 320)
    assert np.isfinite(wav).all()
    assert codes.min() >= 0 and codes.max() <= 1023


def _bwd_case(dev, B, Tq, Tk, H, D, dtype, masked, seed=0):
    q, k, v, bias = _qkv(dev, B, Tq, Tk, H, D, dtype, masked, seed)
    o, lse = flash_attention(q, k, v, bias, return_lse=True)
    g = torch.Generator(dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    return q, k, v, bias, o, lse, do


def _assert_bwd_close(got, ref, dtype, tol=BWD_TOL):
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if a is None:
            continue
        assert torch.isfinite(a).all(), name
        atol = tol * (1.0 + b.abs().max().item())
        rtol = ATTN_RTOL_BF16 if dtype == torch.bfloat16 and \
            name != "dbias" else 0.0
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_bwd_kernel_matches_plain(dev, D, dtype):
    """Ragged Tq/Tk (one key, one row, tails of 63/65/113/550)."""
    for Tq, Tk, masked in ((1, 1, False), (63, 65, True), (113, 550, False),
                           (130, 7, True), (200, 70, True)):
        q, k, v, bias, o, lse, do = _bwd_case(dev, 2, Tq, Tk, 3, D, dtype,
                                              masked)
        got = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=masked)
        ref = attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                  do.float(), bias)
        torch.cuda.synchronize()
        for t, like in zip(got[:3], (q, k, v)):
            assert t.dtype == dtype and t.shape == like.shape
        if masked:
            assert got[3].shape == bias.shape
        _assert_bwd_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_all_masked_row(dev, dtype):
    """Batch row 1 has every key masked (an empty text): finite, and with
    the plain version; its dk/dv on masked keys are exactly 0 in row 0."""
    q, k, v, _, _, _, _ = _bwd_case(dev, 2, 90, 40, 2, 64, dtype, False)
    bias = torch.zeros(2, 1, 1, 40, device=dev)
    bias[0, ..., 30:] = -1e4
    bias[1] = -1e4
    o, lse = flash_attention(q, k, v, bias, return_lse=True)
    do = torch.randn(q.shape, device=dev).to(dtype)
    got = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    ref = attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              do.float(), bias)
    _assert_bwd_close(got, ref, dtype, BWD_TOL_ALL_MASKED)
    assert got[1][0, 30:].abs().max() == 0 and got[2][0, 30:].abs().max() == 0


def test_attention_bwd_kernel_is_deterministic(dev):
    """Two launches per call and no atomics: the same bits every run."""
    args = _bwd_case(dev, 3, 333, 550, 8, 96, torch.bfloat16, True)
    q, k, v, bias, o, lse, do = args
    a = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    b = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_attention_bwd_wrapper_counts_and_checks(dev):
    q, k, v, bias, o, lse, do = _bwd_case(dev, 2, 16, 24, 2, 32,
                                          torch.float32, True)
    before = attention_bwd.launches
    attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    attention_bwd(q, k, v, o, do, None, lse)
    assert attention_bwd.launches == before + 2 * LAUNCHES_PER_CALL
    bad = {
        "lse": (q, k, v, o, do, bias, None),
        "shape": (q, k, v[:, :5].contiguous(), o, do, bias, lse),
        "contiguous": (q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                       o, do, bias, lse),
        "head dim": (q[..., :16].contiguous(), k[..., :16].contiguous(),
                     v[..., :16].contiguous(), o[..., :16].contiguous(),
                     do[..., :16].contiguous(), bias, lse),
        "not supported": (q.half(), k.half(), v.half(), o.half(), do.half(),
                          bias, lse),
        "key-only": (q, k, v, o, do, torch.zeros(2, 1, 16, 24, device=dev),
                     lse),
        "is torch.float32 on cpu": (q, k.cpu(), v, o, do, bias, lse),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            attention_bwd(*args)
    with pytest.raises(ValueError, match="without a bias"):
        attention_bwd(q, k, v, o, do, None, lse, need_dbias=True)
    assert attention_bwd.launches == before + 2 * LAUNCHES_PER_CALL


def test_train_step_on_card_matches_cpu(dev):
    """One f32 train step of the small model, same weights, batch, noise
    and timesteps on both devices; on the card every attention call runs
    the forward kernel (with the lse) and the backward kernel once."""
    cfg = dataclasses.replace(CARD_CFG, text_encoder_dropout=0.0)
    tcfg = TrainConfig(batch_size=2, learning_rate=1e-3, lr_warmup_steps=0)
    g = torch.Generator().manual_seed(5)
    batch = {"codes": torch.rand(2, cfg.sample_size, 8, generator=g) * 2 - 1,
             "text_ids": torch.randint(1, 149, (2, cfg.cmu_seq_len),
                                       generator=g, dtype=torch.int32),
             "text_mask": torch.ones(2, cfg.cmu_seq_len, dtype=torch.int32)}
    batch["text_mask"][1, 20:] = 0
    inputs = {"noise": torch.randn(2, cfg.sample_size, 8, generator=g),
              "timesteps": torch.tensor([17, 803])}
    cpu_model = TTSSingleSpeaker(cfg)
    random_init_(cpu_model, torch.Generator().manual_seed(0))
    out, grads = {}, {}
    with full_f32():
        for d in ("cpu", "cuda"):
            model = TTSSingleSpeaker(cfg, device=d)
            model.load_state_dict(cpu_model.state_dict())
            state = TrainState(model, tcfg, num_training_steps=10)
            step = make_train_step(state, linear_schedule(device=d))
            model.train()
            loss = make_loss_fn(model, linear_schedule(device=d))(
                {k: t.to(d) for k, t in batch.items()},
                **{k: t.to(d) for k, t in inputs.items()})
            flash_attention.launches = attention_bwd.launches = 0
            loss.backward()
            grads[d] = {n: p.grad.cpu() for n, p in model.named_parameters()}
            n_bwd = attention_bwd.launches
            state.optimizer.zero_grad(set_to_none=True)
            out[d] = {k: float(t) for k, t in step(
                {k: t.to(d) for k, t in batch.items()},
                **{k: t.to(d) for k, t in inputs.items()}).items()}
            if d == "cuda":
                calls = cfg.text_encoder_layers + 2 * len(list(
                    cross_attn_sites(cfg)))
                assert n_bwd == LAUNCHES_PER_CALL * calls
                assert flash_attention.launches == calls
    assert abs(out["cuda"]["loss"] - out["cpu"]["loss"]) <= TRAIN_LOSS_TOL
    gn = out["cpu"]["grad_norm"]
    assert abs(out["cuda"]["grad_norm"] - gn) <= TRAIN_GRAD_RTOL * gn
    for n, ref in grads["cpu"].items():
        err = (grads["cuda"][n] - ref).norm().item()
        if ref.norm().item() <= ZERO_GRAD * gn:
            assert err <= ZERO_GRAD * gn, n
        else:
            assert err <= TRAIN_GRAD_RTOL * ref.norm().item(), n
