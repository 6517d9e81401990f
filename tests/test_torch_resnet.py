"""The UNet resnet block: the PyTorch port against the JAX package.

The port's plain resnet block (``ops/resnet.py:resnet_block_plain``, the
CPU path of the fused kernel's dispatcher) is held against the JAX TPU
kernel ``fused_resnet_block`` in Pallas interpret mode and against the flax
``ResnetBlock1D``, on the same weights (a JAX param tree filled from a numpy
seed, converted with ``convert.py``) and inputs.  Tolerance 1e-4 absolute,
the JAX kernel test's own (``tests/test_pallas_kernels.py``): f32 on every
side; the TPU kernel takes GroupNorm's variance as E[x^2] - E[x]^2 where
flax and torch take two passes.

The CUDA kernel's plain version (``ops/cuda/resnet.py:
fused_resnet_block_plain``, on the packed weights, rounding where the
kernel rounds) is held to the JAX kernel in f32 and in bf16, and to the
module arithmetic in bf16; the kernel's tile rule, bf16 and f32, is checked
at every block shape of the flagship UNet.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.models.unet1d import ResnetBlock1D as JaxResnetBlock
from prompt_tts_tpu.ops.pallas.resnet import fused_resnet_block
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.models.layers import cast_compute_
from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
from prompt_tts_tpu_torch.ops.cuda.resnet import (
    SMS, TILES, TILES_F32, fused_resnet_block as cuda_resnet_block,
    fused_resnet_block_plain, pack_resnet_weights, resnet_tiles,
)
from prompt_tts_tpu_torch.ops.resnet import resnet_block, resnet_block_plain

TOL = 1e-4
GROUPS, TEMB = 8, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: under the suite's xdist workers, torch's OpenMP
    threads spin-wait on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=[(48, 32, 32), (48, 64, 32),
                                        (37, 64, 32)],
                ids=["T48-32-32", "T48-64-32", "T37-64-32"])
def case(request):
    """One block shape: inputs, the flax and Pallas outputs, and the port's
    block on the converted weights."""
    T, cin, cout = request.param
    rng = np.random.default_rng(T + cin)
    B = 2
    x = (rng.standard_normal((B, T, cin)) * 1.5
         + rng.standard_normal(cin)).astype(np.float32)
    temb = rng.standard_normal((B, TEMB)).astype(np.float32)
    m = JaxResnetBlock(out_channels=cout, groups=GROUPS)
    p = _fill(jax.eval_shape(m.init, jax.random.PRNGKey(0), x, temb)["params"],
              rng)
    ref = m.apply({"params": p}, x, temb)
    tp = jax.nn.silu(temb) @ p["time_emb_proj"]["kernel"] + p[
        "time_emb_proj"]["bias"]
    kw = {}
    if cin != cout:
        kw = dict(shortcut_w=p["conv_shortcut"]["conv"]["kernel"][0],
                  shortcut_b=p["conv_shortcut"]["conv"]["bias"])
    with pltpu.force_tpu_interpret_mode():
        fused = fused_resnet_block(
            x, tp, p["norm1"]["norm"]["scale"], p["norm1"]["norm"]["bias"],
            p["conv1"]["conv"]["kernel"], p["conv1"]["conv"]["bias"],
            p["norm2"]["norm"]["scale"], p["norm2"]["norm"]["bias"],
            p["conv2"]["conv"]["kernel"], p["conv2"]["conv"]["bias"],
            groups=GROUPS, **kw)
    port = ResnetBlock1D(cin, cout, TEMB, groups=GROUPS)
    port.load_state_dict(model_state_from_jax(
        jax.tree.map(np.asarray, p)), strict=True)
    port.eval()
    return dict(x=torch.from_numpy(x), temb=torch.from_numpy(temb),
                tp=torch.from_numpy(np.array(tp)), ref=np.asarray(ref),
                fused=np.asarray(fused), port=port, p=p, kw=kw)


def test_plain_matches_flax_block(case):
    with torch.no_grad():
        out = resnet_block_plain(case["port"], case["x"], case["tp"])
    np.testing.assert_allclose(out.numpy(), case["ref"], atol=TOL, rtol=0)


def test_plain_matches_pallas_kernel_interpret(case):
    with torch.no_grad():
        out = resnet_block_plain(case["port"], case["x"], case["tp"])
    np.testing.assert_allclose(out.numpy(), case["fused"], atol=TOL, rtol=0)


def test_dispatcher_runs_the_plain_version_on_the_cpu(case):
    """CPU tensors: the plain version, no kernel launch, same numbers; a
    cast for inference packs no kernel weights off the card."""
    before = cuda_resnet_block.launches
    with torch.no_grad():
        block = cast_compute_(case["port"], torch.float32)
        assert block.kernel_weights is None
        out = resnet_block(block, case["x"], case["temb"])
        ref = resnet_block_plain(block, case["x"], block.time_emb_proj(
            F.silu(case["temb"])))
    assert cuda_resnet_block.launches == before
    assert torch.equal(out, ref)


def test_dispatcher_keeps_autograd_when_a_gradient_is_needed(case):
    """Training needs gradients: the module arithmetic under autograd, the
    same as the module's forward."""
    block = case["port"]
    x = case["x"].clone().requires_grad_()
    out = block(x, case["temb"])
    out.square().sum().backward()
    assert x.grad is not None and block.conv1.conv.weight.grad is not None
    np.testing.assert_allclose(out.detach().numpy(), case["ref"], atol=TOL,
                               rtol=0)
    block.zero_grad(set_to_none=True)


# The bf16 kernel's plain version against the JAX kernel in bf16 (Pallas
# interpret mode), both on the same bf16 inputs and bf16-representable
# weights, rounding a, h, a2 and the output at the same points: their
# GroupNorm statistics differ in the last f32 bits (the TPU kernel's f32
# E[x^2] - E[x]^2, here f64 two-pass), which can move a value across a bf16
# rounding boundary: one ulp of the output (2^-7 relative) plus 2^-8
# absolute for such a flip carried through a product.  (Bit-equal today.)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -8
# ... and against the module arithmetic (``resnet_block_plain``), which
# rounds conv1's output and then h + temb (two roundings) where the kernel
# rounds once: the card's kernel-vs-plain tolerance, max |err| <= tol *
# max(1, max |ref|) (tests/test_torch_cuda.py, chip_smoke.py).
RESNET_TOL_BF16 = 3e-2


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=[(48, 32, 32), (48, 64, 32),
                                        (37, 64, 32)],
                ids=["T48-32-32", "T48-64-32", "T37-64-32"])
def case_bf16(request):
    """The same block shapes in bf16: the JAX kernel on weights rounded to
    bf16, and the port's block on the same weights."""
    T, cin, cout = request.param
    rng = np.random.default_rng(T + cin + 1)
    x = _bf16((rng.standard_normal((2, T, cin)) * 1.5
               + rng.standard_normal(cin)).astype(np.float32))
    temb = rng.standard_normal((2, TEMB)).astype(np.float32)
    m = JaxResnetBlock(out_channels=cout, groups=GROUPS)
    p = jax.tree.map(_bf16, _fill(jax.eval_shape(
        m.init, jax.random.PRNGKey(0), x, temb)["params"], rng))
    tp = _bf16(jax.nn.silu(temb) @ p["time_emb_proj"]["kernel"]
               + p["time_emb_proj"]["bias"])
    kw = {}
    if cin != cout:
        kw = dict(shortcut_w=p["conv_shortcut"]["conv"]["kernel"][0],
                  shortcut_b=p["conv_shortcut"]["conv"]["bias"])
    with pltpu.force_tpu_interpret_mode():
        fused = fused_resnet_block(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(tp, jnp.bfloat16),
            p["norm1"]["norm"]["scale"], p["norm1"]["norm"]["bias"],
            p["conv1"]["conv"]["kernel"], p["conv1"]["conv"]["bias"],
            p["norm2"]["norm"]["scale"], p["norm2"]["norm"]["bias"],
            p["conv2"]["conv"]["kernel"], p["conv2"]["conv"]["bias"],
            groups=GROUPS, **kw)
    port = ResnetBlock1D(cin, cout, TEMB, groups=GROUPS)
    port.load_state_dict(model_state_from_jax(p), strict=True)
    port = cast_compute_(port.eval(), torch.bfloat16)
    return dict(x=torch.from_numpy(x).bfloat16(), tp=torch.from_numpy(tp),
                fused=np.asarray(jnp.asarray(fused, jnp.float32)), port=port)


def test_fused_plain_matches_pallas_kernel_interpret(case):
    """f32: the kernel's plain version on the packed weights against the
    JAX kernel, at the file's 1e-4."""
    port = case["port"]
    with torch.no_grad():
        out = fused_resnet_block_plain(
            case["x"], case["tp"], pack_resnet_weights(port, torch.float32),
            GROUPS, port.norm1.norm.eps)
    np.testing.assert_allclose(out.numpy(), case["fused"], atol=TOL, rtol=0)


def test_fused_plain_matches_pallas_kernel_interpret_bf16(case_bf16):
    port = case_bf16["port"]
    with torch.no_grad():
        out = fused_resnet_block_plain(
            case_bf16["x"], case_bf16["tp"],
            pack_resnet_weights(port, torch.bfloat16), GROUPS,
            port.norm1.norm.eps)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), case_bf16["fused"],
                               atol=BF16_ATOL, rtol=BF16_RTOL)


def test_fused_plain_matches_module_plain_bf16(case_bf16):
    port = case_bf16["port"]
    with torch.no_grad():
        out = fused_resnet_block_plain(
            case_bf16["x"], case_bf16["tp"],
            pack_resnet_weights(port, torch.bfloat16), GROUPS,
            port.norm1.norm.eps)
        ref = resnet_block_plain(port, case_bf16["x"],
                                 case_bf16["tp"].bfloat16())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RESNET_TOL_BF16 * max(1.0, ref.float().abs().max().item())


def test_wrapper_runs_the_kernels_plain_version_on_the_cpu(case):
    """A CPU tensor: the wrapper computes fused_resnet_block_plain and
    launches nothing."""
    port = case["port"]
    packed = pack_resnet_weights(port, torch.float32)
    before = cuda_resnet_block.launches
    with torch.no_grad():
        out = cuda_resnet_block(case["x"], case["tp"], packed, GROUPS,
                                port.norm1.norm.eps)
        ref = fused_resnet_block_plain(case["x"], case["tp"], packed, GROUPS,
                                       port.norm1.norm.eps)
    assert cuda_resnet_block.launches == before
    assert torch.equal(out, ref)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,dtype", [
    *(pytest.param(B, torch.bfloat16, id=str(B)) for B in (1, 4, 8, 32)),
    *(pytest.param(B, torch.float32, id=f"f32-{B}") for B in (1, 4, 8, 32))])
def test_resnet_tiles_at_every_unet_shape(B, dtype):
    """At every block shape of the flagship UNet: a tile the kernel has (BM
    a multiple of wgmma's 64 rows, one or two warpgroups; BN a multiple of
    64, one 128-byte TMA row of K a box) among the dtype's candidates
    (f32: 128 x 128 or 64 x 64), whose grid fills at least half the card's
    SMs with no larger candidate doing so, or, where no candidate's grid
    does, the candidate with the most CTAs (the rule PERF.md states)."""
    from prompt_tts_tpu_torch.config import ModelConfig
    shapes = _chip_smoke().resnet_shapes(ModelConfig())
    assert len(shapes) == 22
    tiles = TILES_F32 if dtype == torch.float32 else TILES
    assert set(tiles) <= set(TILES)
    for _, T, cin, cout in shapes:
        bm, bn = resnet_tiles(B, T, cin, cout, dtype)
        assert (bm, bn) in tiles and bm in (64, 128) and bn in (64, 128)

        def ctas(t):
            return B * -(-T // t[0]) * -(-cout // t[1])
        if 2 * ctas((bm, bn)) < SMS:
            assert all(2 * ctas(t) < SMS for t in tiles)
            assert ctas((bm, bn)) == max(ctas(t) for t in tiles)
        else:   # no larger tile fills half the SMs
            for t in tiles[:tiles.index((bm, bn))]:
                assert 2 * ctas(t) < SMS
    if B == 32:   # cli.evaluate's batch: the largest tile everywhere
        assert {resnet_tiles(B, T, cin, cout, dtype)
                for _, T, cin, cout in shapes} == {(128, 128)}


_REFUSALS = {
    "dtype": ("not supported", lambda x, tp, pk: (x.half(), tp, pk["f32"], 8)),
    "packed-dtype": ("the packed weights",
                     lambda x, tp, pk: (x, tp, pk["bf16"], 8)),
    "cin": ("do not fit",
            lambda x, tp, pk: (x[..., :32].contiguous(), tp, pk["f32"], 8)),
    "temb": ("temb_proj", lambda x, tp, pk: (x, tp[:1], pk["f32"], 8)),
    "groups": ("7 groups", lambda x, tp, pk: (x, tp, pk["f32"], 7)),
}


@pytest.mark.parametrize("case_name", list(_REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case_name):
    """The wrapper's checks hold on the CPU too, before any plain version
    runs: a dtype the kernel lacks, weights packed for another dtype or
    input width, a time-embedding projection of the wrong shape, groups
    that do not divide the channels."""
    match, make = _REFUSALS[case_name]
    block = ResnetBlock1D(64, 32, TEMB, groups=GROUPS)
    packed = {"f32": pack_resnet_weights(block, torch.float32),
              "bf16": pack_resnet_weights(block, torch.bfloat16)}
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(0))
    tp = torch.zeros(2, 32)
    x, tp, pk, groups = make(x, tp, packed)
    before = cuda_resnet_block.launches
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        cuda_resnet_block(x, tp, pk, groups, 1e-5)
    assert cuda_resnet_block.launches == before
