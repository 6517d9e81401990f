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
import torch.nn.functional as F

from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D, cross_attn_sites
from prompt_tts_tpu_torch.ops.attention import (
    attention_bwd_plain, attention_plain,
)
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
from prompt_tts_tpu_torch.ops.cuda.attention_bwd import (
    LAUNCHES_PER_CALL, attention_bwd,
)
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_plain, lstm_recurrence_t,
    lstm_recurrence_t_plain,
)
from prompt_tts_tpu_torch.ops.cuda.resnet import fused_resnet_block
from prompt_tts_tpu_torch.ops.resnet import (
    resnet_block, resnet_block_plain,
)
from prompt_tts_tpu_torch.ops.cuda.rvq import (
    index_contract, rvq_encode, rvq_encode_plain,
)
from prompt_tts_tpu_torch.pipeline import (
    CodecRunner, Synthesizer, full_f32, latents_to_codes, random_init_,
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
# Fused resnet block, kernel vs the plain module arithmetic on the same
# inputs, max |err| <= tol * max(1, max |ref|).  f32: the same math, f32
# sums in another order, and GroupNorm statistics as shifted sums
# (E[(x-K)^2] - E[x-K]^2, tiles combined in f64) where the plain version
# takes torch's two passes: ~1e-6 relative.  bf16: the plain version rounds
# conv1's output and then h + temb to bf16 (two roundings), the kernel
# rounds h once, as the TPU kernel does; a bf16 ulp is 2^-8 relative, and
# the difference in h passes through GN2 and conv2 and the output's own
# rounding.
RESNET_TOL_F32, RESNET_TOL_BF16 = 1e-4, 3e-2
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
# RVQ kernel vs plain (cuBLAS, TF32 off): every vector whose indices differ
# is a near-tie at its first differing layer (ops/cuda/rvq.py:
# index_contract), and at most this share of the vectors differ.
RVQ_MAX_DIFFER = 1e-3
# An f32 encode on the card against the CPU: latents through 16 conv layers
# and the 2-layer LSTM, cuDNN's f32 algorithms against the CPU's, 1e-4 of
# max(1, max |latent|); the codes then differ at most at that share.
ENC_TOL = 1e-4
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


@pytest.mark.parametrize("B,H", [(1, 32), (4, 512), (9, 64), (32, 512)])
def test_lstm_kernel_matches_plain(dev, B, H):
    """B = 9 takes two passes over the kernel's 8-row batch tile; B = 32,
    the encoder's batch, four."""
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


@pytest.mark.parametrize("B", [1, 4, 32])
def test_lstm_t_kernel_matches_plain(dev, B):
    """The persistent schedule, T = 77 (a multiple of nothing), H = 512."""
    g = torch.Generator(dev).manual_seed(2)
    T, H = 77, 512
    x = torch.randn(T, B, 4 * H, generator=g, device=dev) * 0.5
    w = torch.randn(4 * H, H, generator=g, device=dev) * H ** -0.5
    before = lstm_recurrence_t.launches
    with full_f32():
        out = lstm_recurrence_t(x, w)
        ref = lstm_recurrence_t_plain(x, w)
    torch.cuda.synchronize()
    assert lstm_recurrence_t.launches == before + 1
    torch.testing.assert_close(out, ref, atol=LSTM_TOL, rtol=0)


def test_lstm_t_refuses_a_grid_that_cannot_be_resident(dev):
    """H = 2048: 4H x H f32 is 64 MB of W_hh, more than every SM's shared
    memory together, so the 512 CTAs of 4 units (128 KB each, one an SM)
    cannot all be resident.  The wrapper raises rather than launching a
    grid barrier that deadlocks."""
    x = torch.zeros(2, 1, 4 * 2048, device=dev)
    w = torch.zeros(4 * 2048, 2048, device=dev)
    before = lstm_recurrence_t.launches
    with pytest.raises(RuntimeError, match="co-resident"):
        lstm_recurrence_t(x, w)
    assert lstm_recurrence_t.launches == before


def _resnet_case(dev, B, T, cin, cout, dtype, seed=0):
    """A ResnetBlock1D on the card with non-trivial norms and biases, and
    inputs with a per-channel offset (as the UNet's skip concatenations
    have)."""
    g = torch.Generator().manual_seed(seed)
    block = ResnetBlock1D(cin, cout, 1024)
    random_init_(block, g)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    block = cast_compute_(block.to(dev).eval(), dtype)
    x = (torch.randn(B, T, cin, generator=g) * 1.5
         + torch.randn(cin, generator=g)).to(dev, dtype)
    temb = torch.randn(B, 1024, generator=g).to(dev)
    return block, x, temb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,cin,cout", [(900, 256, 256), (225, 1536, 768),
                                        (113, 768, 768), (450, 768, 512),
                                        (37, 128, 96)])
def test_resnet_kernel_matches_plain(dev, T, cin, cout, dtype):
    """The UNet's lengths (113 and 225 are tile multiples of nothing), the
    up blocks' skip concatenations (Cin = 1536, Cin != Cout: the 1x1
    shortcut) and a width that is not a tile multiple, at B = 1."""
    block, x, temb = _resnet_case(dev, 1, T, cin, cout, dtype)
    before = fused_resnet_block.launches
    with torch.no_grad(), full_f32():
        out = resnet_block(block, x, temb)
        ref = resnet_block_plain(block, x,
                                 block.time_emb_proj(F.silu(temb)))
    torch.cuda.synchronize()
    assert fused_resnet_block.launches == before + 1
    assert out.dtype == dtype and out.shape == (1, T, cout)
    assert torch.isfinite(out).all()
    tol = RESNET_TOL_F32 if dtype == torch.float32 else RESNET_TOL_BF16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


def test_resnet_kernel_is_deterministic(dev):
    """No atomics: GN2's partial sums are reduced in a fixed order."""
    block, x, temb = _resnet_case(dev, 8, 900, 512, 256, torch.bfloat16)
    with torch.no_grad():
        a = resnet_block(block, x, temb)
        b = resnet_block(block, x, temb)
    assert torch.equal(a, b)


def test_resnet_dispatch_keeps_autograd_and_checks(dev):
    """With a gradient the module arithmetic runs (the kernel has no
    backward); the wrapper refuses what the kernel does not take."""
    block, x, temb = _resnet_case(dev, 2, 40, 64, 64, torch.float32)
    before = fused_resnet_block.launches
    out = resnet_block(block, x, temb)
    out.sum().backward()
    assert fused_resnet_block.launches == before
    assert block.conv1.conv.weight.grad is not None
    with torch.no_grad():
        packed = block.kernel_weights     # packed once, by cast_compute_
        assert packed["w1"].dtype == torch.float32
        tp = torch.zeros(2, 64, device=dev)
        for match, args in {
                "on cpu": (x.cpu(), tp, packed),
                "not supported": (x.half(), tp, packed),
                "temb_proj": (x, tp[:1], packed),
                "do not fit": (x[..., :32].contiguous(), tp, packed)}.items():
            with pytest.raises(ValueError, match=match):
                fused_resnet_block(*args, groups=32, eps=1e-5)
    assert fused_resnet_block.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_all_masked_keys(dev, dtype):
    """Classifier-free guidance's null text masks every key of the text
    encoder's self-attention (a bias of -1e4 on all 550).  The bias shifts
    every score alike, so the kernel (f32 scores) gives the softmax of the
    unmasked scores, held against the f32 plain version of the same inputs
    to BWD_TOL_ALL_MASKED: the scores sit at -1e4, where an f32 ulp is
    ~1e-3.  (The bf16 plain version adds the bias in bf16, whose ulp at 1e4
    is 64, so every score rounds to -1e4 and its rows are uniform.)"""
    q, k, v, _ = _qkv(dev, 2, 550, 550, 12, 64, dtype, False)
    bias = torch.full((2, 1, 1, 550), -1e4, device=dev)
    out = flash_attention(q, k, v, bias)
    ref = attention_plain(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    rtol = ATTN_RTOL_BF16 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref, atol=BWD_TOL_ALL_MASKED,
                               rtol=rtol)


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
    UNet transformer and step (the cross k/v hoist runs no attention), one
    fused resnet call per UNet resnet block and step, and one LSTM launch
    per codec LSTM layer (in the default schedule)."""
    steps = 3
    synth = Synthesizer(config=Config(model=CARD_CFG), device=dev,
                        dtype=torch.bfloat16, num_inference_steps=steps)
    flash_attention.launches = lstm_recurrence.launches = 0
    lstm_recurrence_t.launches = fused_resnet_block.launches = 0
    wav, codes = synth.synthesize(TEXTS, seed=0, return_codes=True)
    n_sites = len(list(cross_attn_sites(CARD_CFG)))
    n_resnets = sum(isinstance(m, ResnetBlock1D)
                    for m in synth.model.modules())
    assert flash_attention.launches == (CARD_CFG.text_encoder_layers
                                        + 2 * n_sites * steps)
    assert fused_resnet_block.launches == n_resnets * steps
    assert lstm_recurrence.launches + lstm_recurrence_t.launches == 2
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


def _rvq_inputs(dev, B, T, n_q, seed=0, K=1024, D=128):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, T, D, generator=g, device=dev) * 2.0
    cb = torch.randn(n_q, K, D, generator=g, device=dev)
    return x, cb


@pytest.mark.parametrize("n_q", [1, 8, 32])
def test_rvq_kernel_keeps_the_index_contract(dev, n_q):
    """Ragged N (3 x 333, 5 x 1, 1 x 64 vectors), K = 1024, D = 128."""
    for B, T in ((3, 333), (5, 1), (1, 64)):
        x, cb = _rvq_inputs(dev, B, T, n_q, seed=n_q + T)
        got = rvq_encode(x, cb)
        with full_f32():
            ref = rvq_encode_plain(x, cb)
        torch.cuda.synchronize()
        assert got.shape == (B, n_q, T) and got.dtype == torch.int32
        r = index_contract(x, cb, got, ref)
        assert r["violations"] == 0, r
        assert r["differ"] <= RVQ_MAX_DIFFER * B * T + 1, r


def test_rvq_kernel_first_index_wins(dev):
    """Duplicated codes tie exactly: the kernel takes the lowest index,
    wherever in the 1024 codes (and its 64-code tiles) the copies sit."""
    x, cb = _rvq_inputs(dev, 2, 50, 2, seed=3)
    for dup in (700, 64, 1023):
        cb[:, dup] = cb[:, 5]
        cb[:, dup - 1] = cb[:, 600]
    x[0, :10] = cb[0, 5]       # copies at 64, 700, 1023
    x[1, :10] = cb[0, 600]     # copies at 63, 699, 1022: 63 is the lowest
    got = rvq_encode(x, cb).cpu()
    assert (got[0, 0, :10] == 5).all() and (got[1, 0, :10] == 63).all()
    ref = rvq_encode_plain(x.cpu(), cb.cpu())
    assert index_contract(x.cpu(), cb.cpu(), got, ref)["violations"] == 0


def test_rvq_wrapper_counts_and_checks(dev):
    x, cb = _rvq_inputs(dev, 2, 10, 2)
    before = rvq_encode.launches
    rvq_encode(x, cb)
    assert rvq_encode.launches == before + 1
    bad = {
        "float32": (x.double(), cb.double()),
        "contiguous": (x.transpose(0, 1).contiguous().transpose(0, 1), cb),
        "D = 128": (x[..., :64].contiguous(), cb[..., :64].contiguous()),
        "multiple of 64": (x, cb[:, :1000].contiguous()),
        "codebooks on cpu": (x, cb.cpu()),
        "codebook dim": (x, cb[..., :8].contiguous()),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            rvq_encode(*args)
    assert rvq_encode.launches == before + 1


def test_encode_on_card_matches_cpu(dev):
    """A small f32 encode (2 x 1.5 s) through the codec on both devices:
    latents within ENC_TOL, codes differing at no more than RVQ_MAX_DIFFER
    of the entries, the RVQ and LSTM kernels launched once per call."""
    runners = {d: CodecRunner(d) for d in ("cpu", "cuda")}
    wav = torch.randn(2, 36000, generator=torch.Generator().manual_seed(9))
    lat, codes = {}, {}
    for d, r in runners.items():
        with torch.no_grad(), full_f32():
            lat[d] = r.codec.encoder(wav.to(d)[..., None]).cpu()
        rvq_encode.launches = lstm_recurrence.launches = 0
        lstm_recurrence_t.launches = 0
        codes[d] = r.encode(wav).cpu()
        if d == "cuda":
            assert rvq_encode.launches == 1 and (
                lstm_recurrence.launches + lstm_recurrence_t.launches == 2)
    assert codes["cuda"].shape == (2, 8, 113)
    scale = max(1.0, lat["cpu"].abs().max().item())
    torch.testing.assert_close(lat["cuda"], lat["cpu"], atol=ENC_TOL * scale,
                               rtol=0)
    assert (codes["cuda"] != codes["cpu"]).float().mean() <= RVQ_MAX_DIFFER
