"""The UNet resnet block: the PyTorch port against the JAX package.

The port's plain resnet block (``ops/resnet.py:resnet_block_plain``, the
CPU path of the fused kernel's dispatcher) is held against the JAX TPU
kernel ``fused_resnet_block`` in Pallas interpret mode and against the flax
``ResnetBlock1D``, on the same weights (a JAX param tree filled from a numpy
seed, converted with ``convert.py``) and inputs.  Tolerance 1e-4 absolute,
the JAX kernel test's own (``tests/test_pallas_kernels.py``): f32 on every
side; the TPU kernel takes GroupNorm's variance as E[x^2] - E[x]^2 where
flax and torch take two passes.
"""

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
    fused_resnet_block as cuda_resnet_block,
)
from prompt_tts_tpu_torch.ops.resnet import resnet_block, resnet_block_plain

TOL = 1e-4
GROUPS, TEMB = 8, 16


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
                fused=np.asarray(fused), port=port)


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
