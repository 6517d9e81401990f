"""The port's ancestral DDPM sampler against ``prompt_tts_tpu/diffusion/
ddpm.py``.

JAX draws step i's noise as ``normal(split(rng, T)[i], x.shape)``; the
same draws are injected into the port's ``ddpm_sample(noise=...)``.  Over
the full 1,000-step linear schedule, with the oracle and the ``0.05 * x``
denoisers of ``tests/test_diffusion.py``, the final latents agree to 1e-5
(f32 on both sides; the port's coefficients are f64 rounded to f32, JAX's
f32 arithmetic).  The sampler is held on the JAX schedule's own tables:
the port's ``linear_schedule`` (``torch.linspace`` and ``torch.cumprod``,
the diffusers construction) is up to 2.4e-7 away from JAX's in
``alphas_cumprod``, which the ``0.05 * x`` denoiser's x0 estimate at high
t amplifies past 1e-5; the oracle also runs on the port's own schedule.
Then the tiny UNet at ``linear_schedule(50)`` to the model-level 5e-4, and
no noise at t = 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.diffusion.ddpm import ddpm_sample as jax_ddpm
from prompt_tts_tpu.diffusion.schedule import linear_schedule as jax_schedule
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.convert import model_state_from_jax
from prompt_tts_tpu_torch.diffusion.ddpm import ddpm_sample, ddpm_tables
from prompt_tts_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, linear_schedule,
)
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker

SAMPLER_TOL = 1e-5
MODEL_TOL = 5e-4

CFG = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
           attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
           sample_size=48, layers_per_block=1, unet_num_heads=4,
           text_encoder_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(rng, T, shape):
    keys = jax.random.split(rng, T)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.normal(k, shape, jnp.float32))
         for k in keys]))


def _as_port(sched) -> DiffusionSchedule:
    """The JAX schedule's tables as the port's schedule."""
    return DiffusionSchedule(*(torch.from_numpy(np.array(a)) for a in (
        sched.betas, sched.alphas, sched.alphas_cumprod)))


@pytest.fixture(scope="module")
def oracle_case():
    js = jax_schedule()
    x0_true = jnp.clip(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 8))
                       * 0.5, -1.0, 1.0)
    x_T = jax.random.normal(jax.random.PRNGKey(6), x0_true.shape)
    rng = jax.random.PRNGKey(7)
    return dict(js=js, x0=x0_true, x_T=x_T, rng=rng,
                noise=_jax_draws(rng, 1000, x_T.shape))


def _oracle(acp, x0, xp):
    def eps(x, t):
        a = acp[t].reshape(-1, 1, 1)
        return (x - xp.sqrt(a) * x0) / xp.sqrt(1.0 - a)
    return eps


@pytest.mark.parametrize("denoiser,tables", [("oracle", "jax"),
                                             ("oracle", "port"),
                                             ("linear", "jax")])
def test_ddpm_matches_jax_with_injected_noise(oracle_case, denoiser, tables):
    c = oracle_case
    js = c["js"]
    if denoiser == "oracle":
        jfn = _oracle(js.alphas_cumprod, c["x0"], jnp)
    else:
        def jfn(x, t):
            return 0.05 * x
    want = np.asarray(jax_ddpm(jfn, js, c["x_T"], rng=c["rng"]))

    sched = _as_port(js) if tables == "jax" else linear_schedule()
    if denoiser == "oracle":
        fn = _oracle(sched.alphas_cumprod,
                     torch.from_numpy(np.asarray(c["x0"])), torch)
    else:
        def fn(x, t):
            return 0.05 * x
    got = ddpm_sample(fn, sched, torch.from_numpy(np.asarray(c["x_T"])),
                      noise=c["noise"]).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SAMPLER_TOL, rtol=0)
    if denoiser == "oracle":    # the sampler lands near the oracle's x0
        np.testing.assert_allclose(got, np.asarray(c["x0"]), atol=0.15)


def test_tiny_unet_matches_jax():
    """The tiny single-speaker UNet over a fixed text context, 50 steps."""
    rng = np.random.default_rng(0)
    jcfg = JaxModelConfig(**CFG)
    jmodel = JaxTTS(jcfg)
    B, S, T = 2, CFG["cmu_seq_len"], CFG["sample_size"]
    ids = rng.integers(1, 149, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 12:] = 0
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, T, 8)), jnp.zeros((B,), jnp.int32),
                            jnp.asarray(ids), jnp.asarray(mask))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    js = jax_schedule(50)
    x_T = rng.standard_normal((B, T, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jfn(x, t):
        return jmodel.apply(params, x, t, jnp.asarray(ids),
                            jnp.asarray(mask))
    want = np.asarray(jax.jit(lambda x: jax_ddpm(jfn, js, x, rng=key))(
        jnp.asarray(x_T)))

    model = TTSSingleSpeaker(ModelConfig(**CFG))
    model.load_state_dict(model_state_from_jax(params), strict=True)
    model.eval()
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        ctx = model.encode_text(tids, tmask)
        got = ddpm_sample(lambda x, t: model.denoise(x, t, ctx),
                          linear_schedule(50), torch.from_numpy(x_T),
                          noise=_jax_draws(key, 50, x_T.shape)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


def test_no_noise_at_t0():
    """The last step (t = 0) adds no noise: its draw does not matter, and
    the tables' noise scale is 0 there (positive elsewhere)."""
    sched = linear_schedule(20)
    x_T = torch.randn((2, 5, 8), generator=torch.Generator().manual_seed(0))
    noise = torch.randn((20, 2, 5, 8),
                        generator=torch.Generator().manual_seed(1))
    loud = noise.clone()
    loud[-1] = 1e6

    def fn(x, t):
        return 0.1 * x
    a = ddpm_sample(fn, sched, x_T, noise=noise)
    b = ddpm_sample(fn, sched, x_T, noise=loud)
    assert torch.equal(a, b)
    sigma = ddpm_tables(sched)[4]
    assert sigma[0] == 0.0 and (sigma[1:] > 0).all()
    c = ddpm_sample(fn, sched, x_T, noise=noise * 2)
    assert not torch.equal(a, c)


def test_generator_draws_and_noise_shape():
    sched = linear_schedule(10)
    x_T = torch.zeros((1, 3, 8))

    def fn(x, t):
        return 0.1 * x
    a = ddpm_sample(fn, sched, x_T, generator=torch.Generator().manual_seed(4))
    b = ddpm_sample(fn, sched, x_T, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.dtype == torch.float32
    with pytest.raises(ValueError, match="noise shape"):
        ddpm_sample(fn, sched, x_T, noise=torch.zeros((9, 1, 3, 8)))
