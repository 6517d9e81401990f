"""The CUDA kernels and the port's path on an NVIDIA GPU.

Each kernel against its plain PyTorch version on the card, the wrappers'
checks, and a small synthesis on the card against the same synthesis on
the CPU.  The kernels have no CPU mode, so every test here needs a card
(marker ``gpu``) and skips without one.  The card's machine has no jax,
so run them there without ``tests/conftest.py`` (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prompt_tts_tpu_torch import aot
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D, cross_attn_sites
from prompt_tts_tpu_torch.ops.attention import (
    attention_bwd_plain, attention_plain, flash_attention_plain,
)
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
from prompt_tts_tpu_torch.ops.cuda.attention_bwd import (
    LAUNCHES_PER_CALL, attention_bwd,
)
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_plain, lstm_recurrence_t,
    lstm_recurrence_t_plain,
)
from prompt_tts_tpu_torch.ops.cuda.resnet import (
    TILES, TILES_F32, _launch as resnet_launch, fused_resnet_block,
    fused_resnet_block_plain, pack_resnet_weights, packed_tensors,
    split_planes,
)
from prompt_tts_tpu_torch.ops.resnet import (
    resnet_block, resnet_block_plain,
)
from prompt_tts_tpu_torch.ops.cuda.rvq import (
    CLUSTERS, RvqPlan, _launch as rvq_launch, index_contract, rvq_encode,
    rvq_encode_plain, split_tf32,
)
from prompt_tts_tpu_torch.pipeline import (
    CodecRunner, Synthesizer, full_f32, latents_to_codes, random_init_,
)
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.train.step import make_loss_fn, make_train_step

pytestmark = pytest.mark.gpu

# f32 kernel vs f32 plain: the same math, f32 sums in another order.
ATTN_TOL_F32 = 2e-5
# bf16 kernel (tensor cores) vs flash_attention_plain, which rounds where
# it rounds (f32 scores and statistics, the unnormalised p to bf16 for PV):
# both round the output to bf16, so they may sit one ulp apart (2^-7
# relative); the kernel rounds p at its running max and rescales later, and
# sums in another order, which moves O(1) outputs by up to ~1e-3.
ATTN_ATOL_BF16, ATTN_RTOL_BF16 = 2e-3, 2.0 ** -7
# ... and against the f32 plain version of the same bf16 inputs, the
# overall accuracy: p rounded to bf16 (2^-9 relative, random over keys)
# and the output's rounding, in relative Frobenius norm.
FRO_RTOL_BF16 = 1e-2
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
RESNET_TOL_F32_DEEP = 4e-6   # relative; chip_smoke.py states why
# The bf16 kernel vs fused_resnet_block_plain, which rounds a, h, a2 and the
# output where the kernel does: GroupNorm statistics in the last f32 bits
# and f32 sums in another order can move a value across a bf16 rounding
# boundary, |err| <= FUSED_ATOL_BF16 + FUSED_RTOL_BF16 |ref|: one ulp of
# the output, plus 2^-8 for such a flip in a, h or a2 carried through a
# product.
FUSED_RTOL_BF16, FUSED_ATOL_BF16 = 2.0 ** -7, 2.0 ** -8
# Synthesis on the card against the CPU, f32 (TF32 off): latents the
# model-level 5e-4 contract, the wav decoded from the same codes the
# codec's 1e-5 decode contract.
LATENT_TOL, WAV_TOL = 5e-4, 1e-5
# Attention backward, f32 kernel vs the f32 plain backward of the same
# inputs, per output, |err| <= BWD_TOL * (1 + max|ref|): f32 sums in
# another order (delta = rowsum(do*o) and do.v^T cancel to ~1e-6 where
# p = 1).  The bf16 kernel vs attention_bwd_plain on the bf16 tensors, which
# rounds p and ds*scale to bf16 where the kernel does: dq, dk, dv are
# rounded to bf16 on both sides (one ulp apart at most, 2^-7 relative), and
# a p or ds whose two f32 values straddle a bf16 rounding boundary moves a
# term by a bf16 ulp: BWD_ATOL_BF16 of max|ref| absolute.  dbias is f32 on
# both sides (BWD_TOL); every output is also held to FRO_RTOL_BF16 of the
# f32 plain backward in relative Frobenius norm (plus BWD_TOL's absolute
# floor per element, for outputs that are rounding noise, as dq and dk with
# a single key).
BWD_TOL = 2e-5
BWD_ATOL_BF16 = 2.0 ** -8
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


def _assert_fro_close(got, ref, atol=0.0):
    """Relative Frobenius error of ``got`` against the f32 ``ref`` within
    FRO_RTOL_BF16, with ``atol`` an absolute floor per element."""
    err = (got.float() - ref.float()).norm().item()
    limit = (FRO_RTOL_BF16 * ref.float().norm().item()
             + atol * ref.numel() ** 0.5)
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_kernel_matches_plain(dev, D, dtype):
    """Ragged Tq/Tk (one key, one row, tails of 63/65/113/550).  f32 against
    the f32 plain version; bf16 (the tensor-core kernel) against the plain
    version that rounds where it rounds, and against f32 in norm."""
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
            torch.testing.assert_close(
                out.float(), flash_attention_plain(q, k, v, bias).float(),
                atol=ATTN_ATOL_BF16, rtol=ATTN_RTOL_BF16)
            _assert_fro_close(out, ref)


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
        "16-byte aligned": (_misaligned(q.bfloat16()), k.bfloat16(),
                            v.bfloat16(), None),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            flash_attention(*args)
    assert flash_attention.launches == before + 2


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary: the kernels' 16-byte copies cannot take it."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    start = (-buf.data_ptr() // t.element_size()) % 8 + 1
    out = buf[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def test_attention_dtype_picks_the_kernel(dev):
    """bf16 runs the bf16 tensor-core kernels, f32 the 3 x TF32 ones,
    forward and backward, as the profiler names them: no option chooses."""
    from torch.profiler import ProfilerActivity, profile
    cases = {dtype: _bwd_case(dev, 2, 70, 45, 2, 64, dtype, True)
             for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    names = {}
    for dtype, (q, k, v, bias, o, lse, do) in cases.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(8, device=dev).add_(1.0)   # the profile's first kernel
            flash_attention(q, k, v, bias)
            attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.name for e in prof.events()
                                if "attn_" in e.name)
    assert all(n in names[torch.float32] for n in (
        "attn_fwd_tf32_kernel", "attn_bwd_dq_tf32_kernel",
        "attn_bwd_dkv_tf32_kernel")), names
    assert all(n in names[torch.bfloat16] for n in (
        "attn_fwd_tc_kernel", "attn_bwd_dq_tc_kernel",
        "attn_bwd_dkv_tc_kernel")), names
    assert "_tc_" not in names[torch.float32], names
    assert "_tf32_" not in names[torch.bfloat16], names


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
    """B = 9 pads the kernel's 4-row batch tile to 12 rows; B = 32, the
    encoder's batch, fills its 32-row chunk; H = 32 leaves most of the 64
    slices of H without a column."""
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


def _lstm_pair(dev, schedule, T, B, H, seed=3):
    """(kernel output, plain output, the kernel run again) of one schedule
    on x_proj and w_hh made from one seed."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(T, B, 4 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 4 * H, generator=g, device=dev) * H ** -0.5
    if schedule == "step":
        fn, plain = lstm_recurrence, lstm_recurrence_plain
    else:
        fn, plain, w = lstm_recurrence_t, lstm_recurrence_t_plain, \
            w.t().contiguous()
    with full_f32():
        out, again, ref = fn(x, w), fn(x, w), plain(x, w)
    torch.cuda.synchronize()
    return out, ref, again


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("schedule", ["step", "persistent"])
def test_lstm_kernels_over_900_steps(dev, schedule, B):
    """The codec's T = 900 at H = 512: the persistent grid barrier and the
    step kernels' programmatic dependent launches only show a fault over
    many steps.  Within LSTM_TOL of the plain version, and the same bits
    twice (fixed summation order, no atomics on data)."""
    out, ref, again = _lstm_pair(dev, schedule, 900, B, 512)
    torch.testing.assert_close(out, ref, atol=LSTM_TOL, rtol=0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("B,H", [(6, 512), (9, 64), (20, 512), (100, 512)])
@pytest.mark.parametrize("schedule", ["step", "persistent"])
def test_lstm_kernels_ragged_batches(dev, schedule, B, H):
    """Each tile layout the kernels have: B = 6 (8 rows of 4 x 4 tiles, a
    warp a tile), B = 9 at a small H (16 rows of 8 x 8 tiles, two warps a
    tile), B = 20 (24 rows: 6 tiles, 6 of the 8 warps); B = 100, four
    chunks of 32 rows inside each step, the last of 4."""
    out, ref, again = _lstm_pair(dev, schedule, 50, B, H)
    torch.testing.assert_close(out, ref, atol=LSTM_TOL, rtol=0)
    assert torch.equal(out, again)


def test_lstm_plan_matches_the_kernels(dev):
    """lstm_plan's shared memory is what the kernels lay out; the step
    kernel runs at the largest H its rule accepts at B = 32 (576), and the
    wrapper refuses the next (580) before launching."""
    from prompt_tts_tpu_torch.ops.cuda.lstm import _lib, _lib_t, lstm_plan
    for B, H in ((1, 32), (4, 512), (9, 64), (32, 512), (100, 512),
                 (32, 576), (4, 1436)):
        assert _lib().ptts_lstm_smem_bytes(B, H) == \
            lstm_plan("step", B, H)["smem"]
        assert _lib_t().ptts_lstm_t_smem_bytes(B, H) == \
            lstm_plan("persistent", B, H)["smem"]
    out, ref, _ = _lstm_pair(dev, "step", 20, 32, 576)
    torch.testing.assert_close(out, ref, atol=LSTM_TOL, rtol=0)
    x = torch.zeros(2, 32, 4 * 580, device=dev)
    before = lstm_recurrence.launches
    with pytest.raises(ValueError, match="two CTAs an SM"):
        lstm_recurrence(x, torch.zeros(580, 4 * 580, device=dev))
    assert lstm_recurrence.launches == before


def test_lstm_t_refuses_a_grid_that_cannot_be_resident(dev):
    """H = 2048: 4H x H f32 is 64 MB of W_hh, more than every SM's shared
    memory together, so the 512 CTAs of 4 units (160 KB each at B = 1, one
    an SM) cannot all be resident.  The wrapper raises rather than launching
    a grid barrier that deadlocks."""
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


def _assert_fused_close(out, ref):
    err = (out.float() - ref.float()).abs()
    limit = FUSED_ATOL_BF16 + FUSED_RTOL_BF16 * ref.float().abs()
    assert bool((err <= limit).all()), (err - limit).max().item()


@pytest.mark.parametrize("T,cin,cout", [(113, 768, 768), (113, 1536, 768),
                                        (225, 768, 768), (225, 1280, 768),
                                        (225, 1536, 768)])
def test_resnet_bf16_kernel_at_the_deep_levels(dev, T, cin, cout):
    """The UNet's deep levels at CFG's batch of 8 (batch boundaries inside
    the grid, ragged T tiles, the skip concatenations' 1x1 shortcut):
    against the plain version that rounds where the kernel rounds, and
    against the module arithmetic."""
    block, x, temb = _resnet_case(dev, 8, T, cin, cout, torch.bfloat16)
    with torch.no_grad(), full_f32():
        tp = block.time_emb_proj(F.silu(temb))
        out = resnet_block(block, x, temb)
        fused = fused_resnet_block_plain(x, tp, block.kernel_weights, 32,
                                         block.norm1.norm.eps)
        ref = resnet_block_plain(block, x, tp)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (8, T, cout)
    _assert_fused_close(out, fused)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RESNET_TOL_BF16 * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("B,T,cin,cout", [(3, 150, 192, 320),
                                          (2, 70, 320, 320)])
def test_resnet_bf16_kernel_every_tile(dev, tiles, B, T, cin, cout):
    """Every tile shape the rule may pick, on ragged shapes: T no tile
    multiple, Cout no multiple of 128 or 256, groups of 6 and 10 channels
    (straddling the 8-channel vectors and the 64-channel slabs), the 1x1
    and the identity shortcut."""
    block, x, temb = _resnet_case(dev, B, T, cin, cout, torch.bfloat16)
    before = fused_resnet_block.launches
    with torch.no_grad(), full_f32():
        tp = block.time_emb_proj(F.silu(temb))
        out = resnet_launch(x, tp, block.kernel_weights, 32,
                            block.norm1.norm.eps, tiles)
        fused = fused_resnet_block_plain(x, tp, block.kernel_weights, 32,
                                         block.norm1.norm.eps)
    torch.cuda.synchronize()
    assert fused_resnet_block.launches == before + 1
    _assert_fused_close(out, fused)


def test_resnet_bf16_kernel_is_deterministic_with_a_shortcut(dev):
    """The bf16 path at B=8 with the 1x1 shortcut: the same bits twice."""
    block, x, temb = _resnet_case(dev, 8, 225, 1536, 768, torch.bfloat16)
    with torch.no_grad():
        a = resnet_block(block, x, temb)
        b = resnet_block(block, x, temb)
    assert torch.equal(a, b)


def test_resnet_kernel_is_deterministic(dev):
    """No atomics: GN2's partial sums are reduced in a fixed order."""
    block, x, temb = _resnet_case(dev, 8, 900, 512, 256, torch.bfloat16)
    with torch.no_grad():
        a = resnet_block(block, x, temb)
        b = resnet_block(block, x, temb)
    assert torch.equal(a, b)


def _assert_f32_close(out, ref):
    err = (out - ref).abs().max().item()
    assert err <= RESNET_TOL_F32 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("T,cin,cout", [(113, 768, 768), (113, 1536, 768),
                                        (225, 1536, 768), (900, 256, 256),
                                        (900, 512, 256)])
def test_resnet_f32_kernel_at_batch_32(dev, T, cin, cout):
    """``cli.evaluate``'s batch of 32 in f32 (3 x TF32 on the tensor cores,
    the 128 x 128 tile): the deep levels with the 1536 -> 768 shortcut and
    T = 900, against the module arithmetic (TF32 off) and against
    fused_resnet_block_plain on the same packed weights."""
    block, x, temb = _resnet_case(dev, 32, T, cin, cout, torch.float32)
    before = fused_resnet_block.launches
    with torch.no_grad(), full_f32():
        tp = block.time_emb_proj(F.silu(temb))
        out = resnet_block(block, x, temb)
        fused = fused_resnet_block_plain(x, tp, block.kernel_weights, 32,
                                         block.norm1.norm.eps)
        ref = resnet_block_plain(block, x, tp)
    torch.cuda.synchronize()
    assert fused_resnet_block.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (32, T, cout)
    _assert_f32_close(out, ref)
    _assert_f32_close(out, fused)


@pytest.mark.parametrize("T", [113, 225])
def test_resnet_f32_kernel_deepest_k_against_f64(dev, T):
    """The f32 kernel at the deepest K (Cin = 1536 -> 768, the 1x1
    shortcut) and B = 32 against the block in f64, within
    RESNET_TOL_F32_DEEP of max(1, max |ref|).  The tensor cores truncate
    each k8 step's sum into the accumulator, so the kernel folds a partial
    accumulator into an f32 total every kFold stages (csrc/resnet.cu): on
    an H100, 6.6e-7 and 7.6e-7 of max |ref| on chip_smoke.py's inputs.
    One accumulator over the K loop reads 1.6e-5 and 2.0e-5, which misses
    this limit and passes RESNET_TOL_F32."""
    block, x, temb = _resnet_case(dev, 32, T, 1536, 768, torch.float32)
    with torch.no_grad():
        tp = block.time_emb_proj(F.silu(temb))
        out = resnet_block(block, x, temb)
        ref = resnet_block_plain(copy.deepcopy(block).double(), x.double(),
                                 tp.double())
    rel = ((out.double() - ref).abs().max().item()
           / max(1.0, ref.abs().max().item()))
    assert rel <= RESNET_TOL_F32_DEEP, rel


@pytest.mark.parametrize("tiles", TILES_F32)
@pytest.mark.parametrize("B,T,cin,cout", [(3, 150, 192, 320),
                                          (2, 70, 320, 320),
                                          (2, 37, 128, 96)])
def test_resnet_f32_kernel_every_tile(dev, tiles, B, T, cin, cout):
    """Every f32 tile shape on ragged shapes: T no tile multiple, Cout =
    320 or 96 (no multiple of 64 or 128), groups of 6 and 10 channels
    straddling the 32-channel boxes of a K step and the 4-channel vectors
    of the activation pass, the 1x1 and the identity shortcut."""
    block, x, temb = _resnet_case(dev, B, T, cin, cout, torch.float32)
    before = fused_resnet_block.launches
    with torch.no_grad(), full_f32():
        tp = block.time_emb_proj(F.silu(temb))
        out = resnet_launch(x, tp, block.kernel_weights, 32,
                            block.norm1.norm.eps, tiles)
        fused = fused_resnet_block_plain(x, tp, block.kernel_weights, 32,
                                         block.norm1.norm.eps)
    torch.cuda.synchronize()
    assert fused_resnet_block.launches == before + 1
    _assert_f32_close(out, fused)


def test_resnet_f32_kernel_is_deterministic_with_a_shortcut(dev):
    """The f32 path at B=8 with the 1x1 shortcut: the same bits twice."""
    block, x, temb = _resnet_case(dev, 8, 225, 1536, 768, torch.float32)
    with torch.no_grad():
        a = resnet_block(block, x, temb)
        b = resnet_block(block, x, temb)
    assert torch.equal(a, b)


def test_resnet_f32_packed_weights_are_tf32_rna_planes(dev):
    """The f32 path packs its weights as their TF32 planes only (``hi =
    rna(w)``, ``lo = rna(w - hi)``, the low 13 bits zero), with the bits
    ``split_tf32`` gives on the CPU: from the module's weights of a block
    with a shortcut, and on values whose dropped 13 bits are a tie (0x1000)
    or just either side of one, of both signs and over the exponents."""
    block, _, _ = _resnet_case(dev, 1, 8, 64, 32, torch.float32)
    packed = block.kernel_weights
    for name, w in (("w1", block.conv1.conv.weight.permute(2, 0, 1)),
                    ("w2", block.conv2.conv.weight.permute(2, 0, 1)),
                    ("ws", block.conv_shortcut.conv.weight[..., 0])):
        got = packed[name]
        want = torch.stack(split_tf32(w.detach().cpu().contiguous()))
        assert got.shape == want.shape, name
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), name
        assert not bool((got.view(torch.int32) & 0x1FFF).any()), name
    g = torch.Generator().manual_seed(1)
    bits = torch.randint(0x0A000000, 0x74000000, (3, 4096), generator=g,
                         dtype=torch.int64)   # |x| from 1e-32 to 1e32
    low = torch.tensor([0x1000, 0x0FFF, 0x1001])[:, None]
    bits = ((bits & ~0x1FFF) | low).flatten()
    sign = torch.randint(0, 2, bits.shape, generator=g) << 31
    x = (bits | sign).to(torch.int32).view(torch.float32)
    got = split_planes(x.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32),
                       torch.stack(split_tf32(x)).view(torch.int32))


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
        with pytest.raises(ValueError, match="not in"):   # no f32 64 x 128
            resnet_launch(x, tp, packed, 32, 1e-5, (64, 128))
    assert fused_resnet_block.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_all_masked_keys(dev, dtype):
    """Classifier-free guidance's null text masks every key of the text
    encoder's self-attention (a bias of -1e4 on all 550).  The bias shifts
    every score alike, so the kernel (f32 scores) gives the softmax of the
    unmasked scores, held to BWD_TOL_ALL_MASKED: the scores sit at -1e4,
    where an f32 ulp is ~1e-3.  f32 against the f32 plain version; bf16
    against flash_attention_plain (f32 scores too, p rounded to bf16 as the
    kernel rounds it), and against f32 in norm.  (attention_plain on bf16
    adds the bias in bf16, whose ulp at 1e4 is 64, so every score rounds to
    -1e4 and its rows are uniform.)"""
    q, k, v, _ = _qkv(dev, 2, 550, 550, 12, 64, dtype, False)
    bias = torch.full((2, 1, 1, 550), -1e4, device=dev)
    out = flash_attention(q, k, v, bias)
    ref = attention_plain(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=BWD_TOL_ALL_MASKED, rtol=0)
    else:
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q, k, v, bias).float(),
            atol=BWD_TOL_ALL_MASKED, rtol=ATTN_RTOL_BF16)
        _assert_fro_close(out, ref)


def test_lstm_wrapper_checks(dev):
    x = torch.zeros(5, 2, 88, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        lstm_recurrence(x, torch.zeros(22, 88, device=dev))
    with pytest.raises(ValueError, match="multiple of 4"):
        lstm_recurrence_t(x, torch.zeros(88, 22, device=dev))
    with pytest.raises(ValueError, match="float32"):
        lstm_recurrence(x.double(), torch.zeros(22, 88, device=dev).double())
    x = torch.zeros(5 * 2 * 96 + 1, device=dev)[1:].view(5, 2, 96)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lstm_recurrence(x, torch.zeros(24, 96, device=dev))


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


def _assert_bwd_close(got, args, tol=BWD_TOL):
    """The kernel's (dq, dk, dv, dbias) against the plain backward of
    ``args`` (q, k, v, o, do, bias): f32 against f32; bf16 against the plain
    version on the bf16 tensors (it rounds p and ds*scale where the kernel
    does), and against the f32 plain backward in norm."""
    q, k, v, o, do, bias = args
    f32 = attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)), bias)
    bf16 = q.dtype == torch.bfloat16
    ref = attention_bwd_plain(q, k, v, o, do, bias) if bf16 else f32
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, ref, f32):
        if a is None:
            continue
        assert torch.isfinite(a).all(), name
        top = b.float().abs().max().item()
        atol, rtol = tol * (1.0 + top), 0.0
        if bf16 and name != "dbias":
            atol, rtol = atol + BWD_ATOL_BF16 * top, ATTN_RTOL_BF16
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)
        if bf16:
            _assert_fro_close(a, c, BWD_TOL * (1.0 + top))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_bwd_kernel_matches_plain(dev, D, dtype):
    """Ragged Tq/Tk (one key, one row, tails of 63/65/113/550)."""
    for Tq, Tk, masked in ((1, 1, False), (63, 65, True), (113, 550, False),
                           (130, 7, True), (200, 70, True)):
        q, k, v, bias, o, lse, do = _bwd_case(dev, 2, Tq, Tk, 3, D, dtype,
                                              masked)
        got = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=masked)
        torch.cuda.synchronize()
        for t, like in zip(got[:3], (q, k, v)):
            assert t.dtype == dtype and t.shape == like.shape
        if masked:
            assert got[3].shape == bias.shape
        _assert_bwd_close(got, (q, k, v, o, do, bias))


# the local heads of tensor parallelism over 2 ranks: the UNet's 8 heads
# split into 4 (head dim 32/64/96 at 900/450/225/113 frames, and the
# cross-attention over 550 text tokens), the text encoder's 12 into 6
# (64, 550 tokens, masked)
TP2_LOCAL = ((900, 900, 4, 32, False), (450, 550, 4, 64, False),
             (225, 225, 4, 96, False), (113, 550, 4, 96, False),
             (550, 550, 6, 64, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,H,D,masked", TP2_LOCAL)
def test_attention_kernels_at_tp2_local_heads(dev, Tq, Tk, H, D, masked,
                                              dtype):
    """Kernels #1 and #2 at tp 2's local head counts, B=2, against their
    plain versions as the ragged cases hold them."""
    q, k, v, bias, o, lse, do = _bwd_case(dev, 2, Tq, Tk, H, D, dtype,
                                          masked)
    ref = attention_plain(q.float(), k.float(), v.float(), bias)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ref, atol=ATTN_TOL_F32, rtol=0)
    else:
        torch.testing.assert_close(
            o.float(), flash_attention_plain(q, k, v, bias).float(),
            atol=ATTN_ATOL_BF16, rtol=ATTN_RTOL_BF16)
        _assert_fro_close(o, ref)
    got = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=masked)
    torch.cuda.synchronize()
    for t, like in zip(got[:3], (q, k, v)):
        assert t.dtype == dtype and t.shape == like.shape
    _assert_bwd_close(got, (q, k, v, o, do, bias))


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
    _assert_bwd_close(got, (q, k, v, o, do, bias), BWD_TOL_ALL_MASKED)
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
        "16-byte aligned": (q.bfloat16(), k.bfloat16(), v.bfloat16(),
                            _misaligned(o.bfloat16()), do.bfloat16(), bias,
                            lse),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            attention_bwd(*args)
    with pytest.raises(ValueError, match="without a bias"):
        attention_bwd(q, k, v, o, do, None, lse, need_dbias=True)
    assert attention_bwd.launches == before + 2 * LAUNCHES_PER_CALL


# f32 (3 x TF32) shapes: ragged tails, a Tk that is no multiple of 8 (the
# transposed tiles' key order within 8-key groups), and at B=8, H=8 a grid
# on which D = 64 and 96 take two warpgroups a CTA.
TF32_SHAPES = ((2, 63, 65), (2, 130, 7), (2, 113, 550), (2, 9, 13),
               (8, 300, 300))


def _tf32_bias(dev, B, Tk):
    """Batch row 0 keeps its first (Tk + 1) // 2 keys, the last row none (an
    empty text), the rows between all of theirs."""
    bias = torch.zeros(B, 1, 1, Tk, device=dev)
    bias[0, ..., (Tk + 1) // 2:] = -1e4
    bias[-1] = -1e4
    return bias


@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_tf32_kernels_match_plain(dev, D):
    """The f32 forward (with and without the lse) and backward, 3 x TF32 on
    the tensor cores, against the plain versions: the output the same bits
    with and without the lse, the lse within 1e-5 of the f64 log-sum-exp,
    the rows with keys ATTN_TOL_F32 and BWD_TOL, the all-masked row
    BWD_TOL_ALL_MASKED."""
    for B, Tq, Tk in TF32_SHAPES:
        q, k, v, _ = _qkv(dev, B, Tq, Tk, 3 if B == 2 else 8, D,
                          torch.float32, False)
        bias = _tf32_bias(dev, B, Tk)
        o, lse = flash_attention(q, k, v, bias, return_lse=True)
        assert torch.equal(o, flash_attention(q, k, v, bias))
        ref = attention_plain(q, k, v, bias)
        s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) \
            / D ** 0.5 + bias.double()
        lse_err = (lse.double() - torch.logsumexp(s64, dim=-1)).abs()
        assert lse_err[:-1].max() <= 1e-5, (B, Tq, Tk, lse_err.max())
        torch.testing.assert_close(o[:-1], ref[:-1], atol=ATTN_TOL_F32,
                                   rtol=0)
        torch.testing.assert_close(o[-1:], ref[-1:],
                                   atol=BWD_TOL_ALL_MASKED, rtol=0)
        do = torch.randn(q.shape, device=dev)
        got = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
        ref_g = attention_bwd_plain(q, k, v, o, do, bias)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref_g):
            assert torch.isfinite(a).all(), name
            top = b[:-1].abs().max().item()
            torch.testing.assert_close(a[:-1], b[:-1],
                                       atol=BWD_TOL * (1.0 + top), rtol=0,
                                       msg=f"{name} B={B} {Tq}/{Tk}")
            torch.testing.assert_close(
                a[-1:], b[-1:], rtol=0, msg=f"{name} all masked",
                atol=BWD_TOL_ALL_MASKED * (1.0 + b[-1:].abs().max().item()))


@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_attention_bwd_tf32_is_deterministic(dev, D):
    """The f32 backward's two launches, no atomics, and with two
    warpgroups a fixed order for their partial sums: the same bits every
    run."""
    q, k, v, bias, o, lse, do = _bwd_case(dev, 8, 300, 300, 8, D,
                                          torch.float32, True)
    a = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    b = attention_bwd(q, k, v, o, do, bias, lse, need_dbias=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_attention_tf32_refuses_misaligned_rows(dev):
    """The f32 kernels copy rows in 16-byte pieces too: a view whose data
    starts one float past a 16-byte boundary raises, forward and
    backward, and launches nothing."""
    q, k, v, bias, o, lse, do = _bwd_case(dev, 2, 16, 24, 2, 32,
                                          torch.float32, True)
    before = (flash_attention.launches, attention_bwd.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(_misaligned(q), k, v, bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, _misaligned(v), bias, return_lse=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_bwd(q, k, v, o, _misaligned(do), bias, lse)
    assert (flash_attention.launches, attention_bwd.launches) == before


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


def _rvq_kernel_check(x, cb, bm, cluster):
    """The kernel at the launch shape (bm, cluster), twice: the same bits,
    and the index contract against the plain version."""
    plan = RvqPlan(bm, cluster, 0)
    got = rvq_launch(x, cb, plan)
    again = rvq_launch(x, cb, plan)
    with full_f32():
        ref = rvq_encode_plain(x, cb)
    torch.cuda.synchronize()
    B, T, _ = x.shape
    assert got.shape == (B, cb.shape[0], T) and torch.equal(got, again)
    r = index_contract(x, cb, got, ref)
    assert r["violations"] == 0, (bm, cluster, r)
    assert r["differ"] <= RVQ_MAX_DIFFER * B * T + 1, (bm, cluster, r)
    return got


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("N", [900, 225, 28800])
def test_rvq_kernel_every_cluster_size(dev, N, cluster):
    """Every cluster size at both tile heights (64 and 128 vectors a CTA),
    at the prompt encode's N (4 x 225 and 1 x 225) and the encode slice's
    (32 x 900), K = 1024, 8 layers: twice for the same bits."""
    x, cb = _rvq_inputs(dev, 1, N, 8, seed=N + cluster)
    for bm in (64, 128):
        _rvq_kernel_check(x, cb, bm, cluster)


def test_rvq_kernel_first_index_wins_across_the_cluster(dev):
    """Duplicated codes in different CTAs' code ranges: 5 and 1000 (ranks 0
    and 7 at 8 CTAs, 0 and 1 at 2), 127 and 128 (ranks 0 and 1 at 8 CTAs,
    neighbouring tiles without a cluster): the lower index wins at every
    launch shape."""
    x, cb = _rvq_inputs(dev, 1, 200, 2, seed=4)
    cb[:, 1000] = cb[:, 5]
    cb[:, 128] = cb[:, 127]
    x[0, :20] = cb[0, 5]
    x[0, 20:40] = cb[0, 127]
    for bm in (64, 128):
        for cluster in CLUSTERS:
            got = _rvq_kernel_check(x, cb, bm, cluster)
            assert (got[0, 0, :20] == 5).all(), (bm, cluster)
            assert (got[0, 0, 20:40] == 127).all(), (bm, cluster)


@pytest.mark.parametrize("N", [1, 65, 129, 1000])
def test_rvq_kernel_ragged_last_tile(dev, N):
    """A last tile of 1, 1 or 65, 1 and 8 or 40 vectors (at 64 and 128 a
    CTA), with and without a cluster; T = N / 5 where 5 divides N, so the
    output's [B, n_q, T] indexing crosses batch rows inside a tile."""
    B = 5 if N % 5 == 0 else 1
    x, cb = _rvq_inputs(dev, B, N // B, 4, seed=N)
    for bm in (64, 128):
        for cluster in (1, 8):
            _rvq_kernel_check(x, cb, bm, cluster)


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


# The UNet's optional variants at the card's small widths: the Fourier time
# embedding, the avg-pool downsample, the conv-transpose upsample (48 ->
# 24 -> 12 -> 6 frames and exactly back) and the "timestep" class
# embedding, which runs the labels through the Fourier projection too.
VARIANT_CFG = dataclasses.replace(
    CARD_CFG, time_embedding_type="fourier", downsample_avg_pool=True,
    upsample_conv_transpose=True, class_embed_type="timestep")
# a whole bf16 UNet forward on the kernels against their plain versions in
# relative Frobenius norm: the resnet kernel's bf16 tolerance for one block
# (it rounds h once where the module rounds it twice) over the forward
UNET_FRO_BF16 = RESNET_TOL_BF16
# the bf16 decode against the f32 decode of the same codes, relative
# Frobenius: bf16 activations and weights through 15 conv layers (1.1e-2
# on the CPU)
CODEC_BF16_FRO = 3e-2


def _plain_unet(monkeypatch):
    """The UNet's attention and resnet blocks on their plain versions
    (flash_attention_plain, what the bf16 kernel computes; the blocks'
    module arithmetic) until the test ends."""
    from prompt_tts_tpu_torch.models import unet1d
    from prompt_tts_tpu_torch.ops.cuda import attention as cuda_attention

    def resnet(block, x, temb):
        return resnet_block_plain(block, x, block.time_emb_proj(F.silu(temb)))
    monkeypatch.setattr(cuda_attention, "flash_attention",
                        lambda q, k, v, bias=None: flash_attention_plain(
                            q, k, v, bias))
    monkeypatch.setattr(unet1d, "resnet_block", resnet)


def _variant_inputs(dev, B=2):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(B, VARIANT_CFG.sample_size, 8, generator=g)
    ctx = torch.randn(B, VARIANT_CFG.cmu_seq_len,
                      VARIANT_CFG.cross_attention_dim, generator=g)
    t = torch.tensor([7, 900])
    labels = torch.tensor([3, 500])
    return x, t, ctx, labels


def test_variant_unet_on_card_matches_cpu(dev):
    """f32 (TF32 off), the same weights and inputs: the card's kernels
    against the CPU's plain versions to the model contract."""
    from prompt_tts_tpu_torch.models.unet1d import UNet1DCondition
    cpu = UNet1DCondition(VARIANT_CFG)
    random_init_(cpu, torch.Generator().manual_seed(0))
    card = UNet1DCondition(VARIANT_CFG, device=dev)
    card.load_state_dict(cpu.state_dict())
    x, t, ctx, labels = _variant_inputs(dev)
    flash_attention.launches = fused_resnet_block.launches = 0
    with torch.no_grad(), full_f32():
        want = cpu.eval()(x, t, ctx, class_labels=labels)
        got = card.eval()(x.to(dev), t.to(dev), ctx.to(dev),
                          class_labels=labels.to(dev)).cpu()
    n_res = sum(isinstance(m, ResnetBlock1D) for m in card.modules())
    assert flash_attention.launches == 2 * len(list(
        cross_attn_sites(VARIANT_CFG)))
    assert fused_resnet_block.launches == n_res
    torch.testing.assert_close(got, want, atol=LATENT_TOL, rtol=0)


def test_variant_unet_bf16_kernels_match_plain(dev, monkeypatch):
    from prompt_tts_tpu_torch.models.unet1d import UNet1DCondition
    unet = UNet1DCondition(VARIANT_CFG, device=dev)
    random_init_(unet, torch.Generator().manual_seed(0))
    cast_compute_(unet.eval(), torch.bfloat16)
    assert unet.time_proj.weight.dtype == torch.float32
    x, t, ctx, labels = (a.to(dev) for a in _variant_inputs(dev))
    with torch.no_grad():
        got = unet(x, t, ctx, class_labels=labels)
        _plain_unet(monkeypatch)
        want = unet(x, t, ctx, class_labels=labels)
    err = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert err <= UNET_FRO_BF16, err


def test_fourier_buffer_frozen_through_card_steps(dev, tmp_path):
    """bf16 ``Trainer`` steps on the card with weight decay: the Fourier
    buffer is bit-unchanged while the parameters move."""
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.train.loop import Trainer
    cfg = Config(model=VARIANT_CFG, train=TrainConfig(
        batch_size=2, learning_rate=1e-3, weight_decay=1e-2,
        lr_warmup_steps=0, lr_scheduler="constant"))
    ds = SyntheticDataset(4, frames=VARIANT_CFG.sample_size,
                          max_seq_length=VARIANT_CFG.cmu_seq_len)
    trainer = Trainer(cfg, ds, str(tmp_path), device=dev,
                      dtype=torch.bfloat16)
    before = trainer.model.unet.time_proj.weight.clone()
    lin = trainer.model.unet.time_embedding.linear_1.weight.detach().clone()
    batches = ds.batches(2)
    attention_bwd.launches = 0
    for _ in range(2):
        assert np.isfinite(float(trainer.train_step(next(batches))["loss"]))
    assert attention_bwd.launches > 0
    assert torch.equal(trainer.model.unet.time_proj.weight, before)
    assert not torch.equal(trainer.model.unet.time_embedding.linear_1.weight,
                           lin)


def test_bf16_decode_on_card(dev):
    """``CodecRunner.at_dtype(torch.bfloat16)`` on the card: f32 out, the
    LSTM kernel launched (its f32 contract kept), near the f32 decode of the
    same codes and the CPU's bf16 decode."""
    codes = torch.randint(0, 1024, (2, 8, 40),
                          generator=torch.Generator().manual_seed(1))
    cpu = CodecRunner("cpu")
    card = CodecRunner(dev)
    fast = card.at_dtype(torch.bfloat16)
    lstm_recurrence.launches = lstm_recurrence_t.launches = 0
    wav16 = fast.decode(codes.to(dev)).cpu()
    assert lstm_recurrence.launches + lstm_recurrence_t.launches == 2
    wav32 = card.decode(codes.to(dev)).cpu()
    cpu16 = cpu.at_dtype(torch.bfloat16).decode(codes)
    assert wav16.dtype == torch.float32 and torch.isfinite(wav16).all()
    for ref in (wav32, cpu16):
        err = ((wav16 - ref).norm() / ref.norm()).item()
        assert err <= CODEC_BF16_FRO, err


def _op_cases(dev):
    """(op, args, the eager wrapper's call) for each kernel's op on CUDA
    tensors, at small shapes the kernels take."""
    g = torch.Generator(dev).manual_seed(5)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _qkv(dev, 2, 37, 45, 2, 64, dtype, masked=True)
        cases.append(("flash_attention", (q, k, v, bias, False),
                      lambda q=q, k=k, v=v, b=bias: (
                          flash_attention(q, k, v, b),)))
        cases.append(("flash_attention", (q, k, v, None, True),
                      lambda q=q, k=k, v=v: flash_attention(
                          q, k, v, None, return_lse=True)))
    q, k, v, bias, o, lse, do = _bwd_case(dev, 2, 37, 45, 2, 64,
                                          torch.float32, True)
    for need in (False, True):
        cases.append(("attention_bwd", (q, k, v, o, do, bias, lse, need),
                      lambda n=need: attention_bwd(q, k, v, o, do, bias, lse,
                                                   need_dbias=n)[:3 + n]))
    x_proj = torch.randn(30, 4, 256, generator=g, device=dev)
    w_hh = 0.1 * torch.randn(64, 256, generator=g, device=dev)
    w_t = w_hh.t().contiguous()
    cases.append(("lstm_recurrence", (x_proj, w_hh),
                  lambda: (lstm_recurrence(x_proj, w_hh),)))
    cases.append(("lstm_recurrence_t", (x_proj, w_t),
                  lambda: (lstm_recurrence_t(x_proj, w_t),)))
    emb = torch.randn(2, 50, 128, generator=g, device=dev)
    cb = torch.randn(3, 128, 128, generator=g, device=dev)
    cases.append(("rvq_encode", (emb, cb), lambda: (rvq_encode(emb, cb),)))
    for dtype in (torch.float32, torch.bfloat16):
        block = ResnetBlock1D(64, 128, 32, groups=8).to(dev).eval()
        random_init_(block, torch.Generator().manual_seed(2))
        pk = pack_resnet_weights(block, dtype)
        x = torch.randn(2, 40, 64, generator=g, device=dev).to(dtype)
        tp = torch.randn(2, 128, generator=g, device=dev)
        cases.append(("fused_resnet_block",
                      (x, tp, *packed_tensors(pk), 8, 1e-5),
                      lambda x=x, tp=tp, pk=pk: (fused_resnet_block(
                          x, tp, pk, 8, 1e-5),)))
    return cases


def test_ops_on_the_card(dev):
    """Each kernel's ``ptts`` op on CUDA tensors: ``opcheck`` (schema, fake
    against the kernel's outputs, AOT dispatch), and the same bits as the
    eager wrapper, whose launcher it calls."""
    cases = _op_cases(dev)
    assert {c[0] for c in cases} == {
        "flash_attention", "attention_bwd", "lstm_recurrence",
        "lstm_recurrence_t", "rvq_encode", "fused_resnet_block"}
    for op, args, eager in cases:
        fn = getattr(torch.ops.ptts, op)
        torch.library.opcheck(fn.default, args)
        got, want = fn(*args), eager()
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), op


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aot_artifact_bit_equal_on_card(dev, tmp_path, dtype):
    """A small artifact exported, saved and loaded on the card gives the
    live Synthesizer's PCM and codes bit for bit (f32: under the same TF32
    scopes), launching each kernel as often."""
    synth = Synthesizer(config=Config(model=CARD_CFG), device=dev,
                        dtype=dtype, num_inference_steps=3)
    path = str(tmp_path / "card.ptts")
    aot.export_synthesis(synth, len(TEXTS), path, pcm16=True)
    prog = aot.SynthesisProgram(path)
    runs = []
    for run in (lambda: prog.synthesize(TEXTS, seed=1, return_codes=True),
                lambda: synth.synthesize(TEXTS, seed=1, pcm16=True,
                                         return_codes=True)):
        flash_attention.launches = fused_resnet_block.launches = 0
        lstm_recurrence_t.launches = 0
        out = run()
        runs.append((out, (flash_attention.launches,
                           fused_resnet_block.launches,
                           lstm_recurrence_t.launches)))
    (got, got_codes), art = runs[0]
    (want, want_codes), live = runs[1]
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_codes, want_codes)
    assert art == live and all(art), (art, live)
