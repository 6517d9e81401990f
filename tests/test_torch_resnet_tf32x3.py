"""The f32 resnet kernel's arithmetic, 3 x TF32, against JAX's resnet block.

The f32 path of the CUDA resnet kernel (``csrc/resnet.cu``) runs both k3
convolutions and the 1x1 shortcut on the tensor cores in TF32: each operand
is split as ``hi = rna(x)``, ``lo = rna(x - hi)`` (``cvt.rna.tf32.f32``;
the weights once, when they are packed, the activations ``a = silu(GN1(x))``
and ``a2 = silu(GN2(h))`` and ``x`` as the activation pass writes them), and
a product is ``hi.lo + lo.hi + hi.hi`` with f32 accumulation.  Here that
arithmetic (``ops/cuda/resnet.py:fused_resnet_block_tf32x3``, on the packed
weights' TF32 planes) is held against the JAX TPU kernel
``fused_resnet_block`` in Pallas interpret mode and against the flax
``ResnetBlock1D``, on the same numpy-seeded weights and inputs, at the
kernel's f32 tolerance, 1e-4 (``tests/test_torch_resnet.py``).  A single
TF32 product misses it: that is why the kernel takes three.  The kernel
itself is held to its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

from prompt_tts_tpu.models.unet1d import ResnetBlock1D as JaxResnetBlock
from prompt_tts_tpu.ops.pallas.resnet import fused_resnet_block
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
from prompt_tts_tpu_torch.ops.cuda import resnet as cuda_resnet
from prompt_tts_tpu_torch.ops.cuda.resnet import (
    fused_resnet_block_tf32x3, pack_resnet_weights,
)
from prompt_tts_tpu_torch.ops.cuda.rvq import tf32_rna

TOL = 1e-4
GROUPS, TEMB = 8, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tier-1 shares the cores among its workers."""
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


# T no multiple of the kernel's tiles (37), the 1x1 shortcut (64 -> 32) and
# the identity (32 -> 32), 8 groups of 4 or 8 channels.
@pytest.fixture(scope="module", params=[(48, 32, 32), (48, 64, 32),
                                        (37, 64, 32)],
                ids=["T48-32-32", "T48-64-32", "T37-64-32"])
def case(request):
    """One block shape: the flax and Pallas outputs, and the port's block
    on the same weights, packed for the f32 kernel."""
    T, cin, cout = request.param
    rng = np.random.default_rng(T + cin + 16)
    x = (rng.standard_normal((2, T, cin)) * 1.5
         + rng.standard_normal(cin)).astype(np.float32)
    temb = rng.standard_normal((2, TEMB)).astype(np.float32)
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
    return dict(x=torch.from_numpy(x), tp=torch.from_numpy(np.array(tp)),
                ref=np.asarray(ref), fused=np.asarray(fused),
                packed=pack_resnet_weights(port, torch.float32), port=port,
                eps=port.norm1.norm.eps)


def _tf32x3(case):
    with torch.no_grad():
        return fused_resnet_block_tf32x3(case["x"], case["tp"],
                                         case["packed"], GROUPS,
                                         case["eps"]).numpy()


def test_tf32x3_matches_pallas_kernel_interpret(case):
    np.testing.assert_allclose(_tf32x3(case), case["fused"], atol=TOL, rtol=0)


def test_tf32x3_matches_flax_block(case):
    np.testing.assert_allclose(_tf32x3(case), case["ref"], atol=TOL, rtol=0)


def test_packed_planes_are_the_weights_split(case):
    """The f32 ``w1``, ``w2`` and ``ws`` are packed as ``[2, ...]`` only:
    hi with the low 13 bits zero, rounded to nearest; lo the remainder
    rounded the same way; hi + lo within 2^-21 of the module's weight
    (relative)."""
    packed, port = case["packed"], case["port"]
    sc = port.conv_shortcut
    for name, w in (("w1", port.conv1.conv.weight.permute(2, 0, 1)),
                    ("w2", port.conv2.conv.weight.permute(2, 0, 1)),
                    ("ws", None if sc is None else sc.conv.weight[..., 0])):
        planes = packed[name]
        if w is None:
            assert planes is None
            continue
        w = w.detach()
        assert planes.shape == (2, *w.shape) and planes.dtype == torch.float32
        assert not bool((planes.view(torch.int32) & 0x1FFF).any())
        hi, lo = planes
        assert torch.equal(hi, tf32_rna(w))
        assert torch.equal(lo, tf32_rna(w - hi))
        assert bool(((hi + lo - w).abs() <= 2.0 ** -21 * w.abs()).all())


def test_one_tf32_product_misses_the_contract(case):
    """The same arithmetic with one TF32 product (each operand rounded once)
    misses 1e-4 against the JAX kernel."""
    def mm1(a, w):   # w's hi plane is rna(w)
        return tf32_rna(a) @ w[0].t()

    with torch.no_grad():
        out = cuda_resnet._fused(case["x"], case["tp"], case["packed"],
                                 GROUPS, case["eps"], mm1).numpy()
    err = float(np.abs(out - case["fused"]).max())
    assert err > TOL, err
