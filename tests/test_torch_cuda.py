"""The CUDA kernels and the port's path on an NVIDIA GPU.

Each kernel against its plain PyTorch version on the card, the wrappers'
checks, and a small synthesis on the card against the same synthesis on
the CPU.  The kernels have no CPU mode, so every test here needs a card
(marker ``gpu``) and skips without one.  The card's machine has no jax,
so run them there without ``tests/conftest.py`` (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from prompt_tts_tpu.config import Config, ModelConfig
from prompt_tts_tpu_torch.models.unet1d import cross_attn_sites
from prompt_tts_tpu_torch.ops.attention import attention_plain
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_plain,
)
from prompt_tts_tpu_torch.pipeline import (
    Synthesizer, full_f32, latents_to_codes,
)

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
