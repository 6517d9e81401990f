"""The schedule's helpers and ``cli.convert_codec --torch_dir``.

``velocity_target``, ``predict_x0_from_eps`` and ``snr`` of
``prompt_tts_tpu_torch/diffusion/schedule.py`` against the JAX package's
(``prompt_tts_tpu/diffusion/schedule.py``) on the same tables, inputs and
timesteps, 1e-6.  The port builds its tables as diffusers does (JAX's
``alphas_cumprod`` is up to 2.4e-7 away, ``ROADMAP.md`` §3), so both sides
get JAX's tables here.  Then ``cli.convert_codec --torch_dir`` on the
directories ``transformers.EncodecModel(EncodecConfig()).save_pretrained``
writes offline, with safetensors and as ``pytorch_model.bin``: the state
dict bit-equal to ``--torch_state`` on the same weights.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prompt_tts_tpu.diffusion import schedule as jax_schedule
from prompt_tts_tpu_torch import diffusion
from prompt_tts_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, predict_x0_from_eps, snr, velocity_target,
)

TOL = 1e-6


@pytest.fixture(scope="module")
def tables():
    jsched = jax_schedule.linear_schedule()
    sched = DiffusionSchedule(*(torch.from_numpy(np.asarray(t))
                                for t in (jsched.betas, jsched.alphas,
                                          jsched.alphas_cumprod)))
    rng = np.random.default_rng(0)
    x0, eps = (rng.standard_normal((4, 48, 8)).astype(np.float32)
               for _ in range(2))
    t = np.array([0, 17, 500, 999], np.int32)
    return jsched, sched, x0, eps, t


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_velocity_target_is_jax(tables):
    jsched, sched, x0, eps, t = tables
    _close(velocity_target(sched, torch.from_numpy(x0),
                           torch.from_numpy(eps), torch.from_numpy(t)),
           jax_schedule.velocity_target(jsched, jnp.asarray(x0),
                                        jnp.asarray(eps), jnp.asarray(t)))
    assert diffusion.velocity_target is velocity_target


def test_predict_x0_from_eps_is_jax(tables):
    jsched, sched, x0, eps, t = tables
    x_t = jax_schedule.add_noise(jsched, jnp.asarray(x0), jnp.asarray(eps),
                                 jnp.asarray(t))
    got = predict_x0_from_eps(sched, torch.from_numpy(np.asarray(x_t)),
                              torch.from_numpy(eps), torch.from_numpy(t))
    _close(got, jax_schedule.predict_x0_from_eps(jsched, x_t,
                                                 jnp.asarray(eps),
                                                 jnp.asarray(t)))
    # and the forward process inverted gives x0 back
    np.testing.assert_allclose(got.numpy(), x0, atol=1e-3, rtol=0)


@pytest.mark.parametrize("t", [[0, 1, 999], 250])
def test_snr_is_jax(tables, t):
    jsched, sched = tables[:2]
    t = np.asarray(t, np.int32)
    got = snr(sched, torch.from_numpy(t))
    want = np.asarray(jax_schedule.snr(jsched, jnp.asarray(t)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)


@pytest.fixture(scope="module")
def encodec_dirs(tmp_path_factory):
    """``save_pretrained`` of a seeded ``EncodecModel(EncodecConfig())``
    with safetensors and as ``pytorch_model.bin``, and its state dict
    ``torch.save``d."""
    transformers = pytest.importorskip("transformers")
    out = tmp_path_factory.mktemp("encodec")
    torch.manual_seed(0)
    model = transformers.EncodecModel(transformers.EncodecConfig()).eval()
    with torch.no_grad():
        for layer in model.quantizer.layers:
            layer.codebook.embed.normal_()
    model.save_pretrained(str(out / "st"))
    model.save_pretrained(str(out / "bin"), safe_serialization=False)
    torch.save(model.state_dict(), str(out / "sd.pt"))
    return out


@pytest.mark.parametrize("layout, file", [("st", "model.safetensors"),
                                          ("bin", "pytorch_model.bin")])
def test_convert_codec_torch_dir(encodec_dirs, tmp_path, layout, file):
    """``--torch_dir`` reads the directory's weights file and writes the
    state dict ``--torch_state`` writes from the same weights, bit for
    bit."""
    from prompt_tts_tpu_torch.cli.convert_codec import main
    assert (encodec_dirs / layout / file).exists()
    got = main(["--torch_dir", str(encodec_dirs / layout), "--out",
                str(tmp_path / "a.pt")])
    want = main(["--torch_state", str(encodec_dirs / "sd.pt"), "--out",
                 str(tmp_path / "b.pt")])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    saved = torch.load(tmp_path / "a.pt", weights_only=True)
    assert all(torch.equal(saved[k], want[k]) for k in want)


def test_convert_codec_torch_dir_refuses_an_empty_dir(tmp_path):
    from prompt_tts_tpu_torch.cli.convert_codec import main
    with pytest.raises(SystemExit, match="no model.safetensors"):
        main(["--torch_dir", str(tmp_path), "--out",
              str(tmp_path / "x.pt")])
