"""The UNet's optional variants in the port against the JAX package.

A port counterpart of each case of ``tests/test_unet_variants.py``, held
against the JAX function on carried weights (a JAX param tree filled from a
numpy seed, loaded with ``convert.model_state_from_jax``): the
conv-transpose upsample (whose JAX kernel ``[k, in, out]`` is applied
flipped, another layout than the codec's), the avg-pool downsample, the
frozen random-Fourier time embedding and the four class-embedding modes.
Then a tiny UNet with all three structural variants and a class mode, and
``TTSSingleSpeaker`` on that config, to the model contract; the Fourier
buffer through ``Trainer`` steps with weight decay, accumulation and the
EMA, and a checkpoint; the round trip port -> JAX -> port; a JAX tree
without ``class_embedding``; and the reference export's refusal.
"""

import numpy as np
import pytest
import torch

import jax

from prompt_tts_tpu.config import ModelConfig as JaxModelConfig
from prompt_tts_tpu.models import TTSSingleSpeaker as JaxTTS
from prompt_tts_tpu.models import UNet1DCondition as JaxUNet
from prompt_tts_tpu.models.embeddings import (
    GaussianFourierProjection as JaxFourier,
)
from prompt_tts_tpu.models.export import (
    export_reference_state_dict as jax_export_tree,
)
from prompt_tts_tpu.models.unet1d import Downsample1D as JaxDownsample
from prompt_tts_tpu.models.unet1d import Upsample1D as JaxUpsample
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.convert import (
    load_model_state_, model_state_from_jax, model_state_to_jax,
)
from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
from prompt_tts_tpu_torch.models.embeddings import GaussianFourierProjection
from prompt_tts_tpu_torch.models.export import export_tree
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.models.unet1d import (
    AvgPoolDownsample1D, ConvTransposeUpsample1D, UNet1DCondition,
)
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.loop import Trainer

# the model contract (ARCHITECTURE.md "Numerics contracts"), f32 both sides
TOL = 5e-4
# one layer in f32: the same products, summed in another order
LAYER_TOL = 1e-5

TINY = dict(
    block_out_channels=(32, 64), cross_attention_dim=64,
    attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=16,
    sample_size=24, layers_per_block=1, unet_num_heads=4,
    down_block_types=("CrossAttnDownBlock1D", "DownBlock1D"),
    up_block_types=("UpBlock1D", "CrossAttnUpBlock1D"))
B = 2
ALL_VARIANTS = dict(time_embedding_type="fourier", downsample_avg_pool=True,
                    upsample_conv_transpose=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """A param tree of ``shapes`` from ``rng``: lecun-scaled kernels,
    non-trivial biases and norm scales, unit-normal tables and Fourier
    weights."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x if name == "bias" else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(cfg, seed=0, n=B):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((n, cfg.sample_size, cfg.in_channels),
                                 dtype=np.float32)
    ctx = rng.standard_normal((n, cfg.cmu_seq_len, cfg.cross_attention_dim),
                              dtype=np.float32)
    return sample, np.array([3, 250, 40, 999][:n], np.int32), ctx


def _pair(overrides, labels=None, seed=0):
    """The JAX UNet on ``TINY | overrides`` (initialised with
    ``class_labels`` when given, so flax creates ``class_embedding``), its
    filled params and outputs, and the port's UNet on the carried weights
    with its outputs, in two halves of B.  With ``labels`` the inputs'
    halves are the same, at the labels and at zero labels.  (Every case runs
    at one batch: JAX's eager ops compile once a shape.)"""
    jcfg = JaxModelConfig(**TINY, **overrides)
    model = JaxUNet(jcfg)
    sample, t, ctx = _inputs(jcfg, seed, 2 * B)
    kw = {}
    if labels is not None:
        sample, t, ctx = (np.concatenate([a[:B], a[:B]])
                          for a in (sample, t, ctx))
        kw["class_labels"] = np.concatenate([labels, np.zeros_like(labels)])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, t,
                            ctx, **kw)
    params = _fill(shapes, np.random.default_rng(seed + 1))
    out = np.asarray(model.apply(params, sample, t, ctx, **kw))
    port = UNet1DCondition(ModelConfig(**TINY, **overrides))
    port.load_state_dict(model_state_from_jax(params), strict=True)
    args = [torch.from_numpy(a) for a in (sample, t, ctx)]
    with torch.no_grad():
        pout = port(*args, **{k: torch.from_numpy(v)
                              for k, v in kw.items()}).numpy()
    return dict(model=model, params=params, port=port, args=args,
                jax=np.split(out, len(out) // B),
                port_out=np.split(pout, len(pout) // B))


def _held(pair):
    for got, want in zip(pair["port_out"], pair["jax"]):
        assert got.shape == (B, TINY["sample_size"], 8)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


class TestConvTransposeUpsample:
    def test_matches_jax_upsample1d(self):
        """The port's ``ConvTransposeUpsample1D`` on a JAX kernel carried by
        ``convert`` equals JAX's ``Upsample1D(use_conv_transpose=True)``;
        the codec's layout rule (``[k, out, in]``) or an unflipped kernel
        would not (the kernel is not symmetric in in/out or in k)."""
        C, T = 6, 10
        rng = np.random.default_rng(0)
        kernel = rng.standard_normal((4, C, C)).astype(np.float32) / 5
        bias = rng.standard_normal(C).astype(np.float32)
        x = rng.standard_normal((B, T, C)).astype(np.float32)
        want = np.asarray(JaxUpsample(C, 2 * T, use_conv_transpose=True)
                          .apply({"params": {"kernel": kernel, "bias": bias}},
                                 x))
        up = ConvTransposeUpsample1D(C)
        up.load_state_dict(
            {k.split(".", 1)[1]: v for k, v in model_state_from_jax(
                {"upsample": {"kernel": kernel, "bias": bias}}).items()})
        with torch.no_grad():
            got = up(torch.from_numpy(x), 2 * T).numpy()
            wrong = [up.__class__(C) for _ in range(2)]
            wrong[0].weight.copy_(torch.from_numpy(
                kernel.transpose(2, 1, 0).copy()))          # codec layout
            wrong[1].weight.copy_(torch.from_numpy(
                kernel[::-1].transpose(1, 2, 0).copy()))    # flipped over k
            for m in wrong:
                m.bias.copy_(torch.from_numpy(bias))
            bad = [m(torch.from_numpy(x), 2 * T).numpy() for m in wrong]
        np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=0)
        for b in bad:
            assert np.abs(b - want).max() > 100 * LAYER_TOL
        with pytest.raises(AssertionError, match="exactly 2x"):
            up(torch.from_numpy(x), 2 * T + 1)

    def test_in_unet(self):
        _held(_pair(dict(upsample_conv_transpose=True)))


class TestAvgPoolDownsample:
    def test_matches_jax_avg_pool(self):
        x = np.random.default_rng(1).standard_normal((B, 12, 6)).astype(
            np.float32)
        want = np.asarray(JaxDownsample(channels=6, use_conv=False)
                          .apply({}, x))
        got = AvgPoolDownsample1D(6)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        ref = torch.nn.AvgPool1d(2, 2)(torch.from_numpy(x).transpose(1, 2))
        np.testing.assert_allclose(got, ref.transpose(1, 2).numpy(),
                                   atol=1e-6, rtol=0)

    def test_channel_change_asserts(self):
        with pytest.raises(AssertionError, match="cannot change channels"):
            AvgPoolDownsample1D(8)(torch.zeros(1, 12, 6))

    def test_in_unet(self):
        _held(_pair(dict(downsample_avg_pool=True)))


class TestGaussianFourierTimeEmbedding:
    @pytest.mark.parametrize("flip", [True, False])
    def test_matches_jax(self, flip):
        """Phases of thousands of radians: f32 in JAX's order, so only the
        cos/sin may differ (by an ulp)."""
        E = 16
        t = np.array([0.0, 1.0, 17.0, 999.0], np.float32)
        mod = JaxFourier(E, flip_sin_to_cos=flip)
        params = mod.init(jax.random.PRNGKey(0), t)
        want = np.asarray(mod.apply(params, t))
        port = GaussianFourierProjection(E, flip_sin_to_cos=flip)
        port.weight.copy_(torch.from_numpy(
            np.array(params["params"]["weight"])))
        got = port(torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        # bf16 timesteps' features are still computed in f32
        got16 = port(torch.from_numpy(t).to(torch.bfloat16))
        assert got16.dtype == torch.float32

    def test_weight_gets_no_gradient(self):
        """A buffer, as torch registers it (``requires_grad=False``): no
        parameter, no gradient."""
        unet = UNet1DCondition(ModelConfig(time_embedding_type="fourier",
                                           **TINY))
        names = [n for n, _ in unet.named_parameters()]
        assert "time_proj.weight" not in names
        assert "time_proj.weight" in unet.state_dict()
        sample, t, ctx = (torch.from_numpy(a) for a in _inputs(unet.config))
        unet(sample, t, ctx).square().mean().backward()
        assert not unet.time_proj.weight.requires_grad
        assert unet.time_proj.weight.grad is None

    def test_weight_frozen_through_trainer_steps(self, tmp_path):
        """Three ``Trainer`` steps at lr 1e-2 with weight decay 1e-2, under
        accumulation of 2 and an EMA: the Fourier buffer is bit-unchanged,
        the EMA copies it, and the checkpoint saves and restores it."""
        mcfg = ModelConfig(time_embedding_type="fourier",
                           **dict(TINY, cmu_seq_len=32))
        cfg = Config(model=mcfg, train=TrainConfig(
            learning_rate=1e-2, weight_decay=1e-2, lr_warmup_steps=0,
            lr_scheduler="constant", batch_size=B, ema_decay=0.9,
            gradient_accumulation_steps=2))
        ds = SyntheticDataset(8, frames=mcfg.sample_size,
                              max_seq_length=mcfg.cmu_seq_len)
        trainer = Trainer(cfg, ds, str(tmp_path / "log"),
                          ckpt_dir=str(tmp_path / "ck"), device="cpu")
        before = trainer.model.unet.time_proj.weight.clone()
        other = dict(trainer.model.named_parameters())[
            "unet.time_embedding.linear_1.weight"].detach().clone()
        batches = trainer.dataset.batches(B)
        for _ in range(3):
            m = trainer.train_step(next(batches))
            assert np.isfinite(float(m["loss"]))
        after = trainer.model.unet.time_proj.weight
        assert torch.equal(after, before)
        assert trainer.state.update_count == 1
        assert not torch.equal(dict(trainer.model.named_parameters())[
            "unet.time_embedding.linear_1.weight"], other)
        assert "unet.time_proj.weight" not in trainer.state.names
        trainer.global_step = 3
        trainer.save()
        mgr = CheckpointManager(str(tmp_path / "ck"))
        for ema in (False, True):
            state, _ = mgr.read_model_state(ema=ema)
            assert torch.equal(state["unet.time_proj.weight"], before)
        trainer.model.unet.time_proj.weight.zero_()
        trainer.restore_latest()
        assert torch.equal(trainer.model.unet.time_proj.weight, before)

    def test_in_unet(self):
        p = _pair(dict(time_embedding_type="fourier"))
        _held(p)
        c0 = TINY["block_out_channels"][0]
        assert p["port"].time_embedding.linear_1.weight.shape == (2 * c0,
                                                                   2 * c0)
        sample, _, ctx = (a[:B] for a in p["args"])
        with torch.no_grad():
            other = p["port"](sample, torch.tensor([500, 999]), ctx).numpy()
        assert not np.allclose(other, p["port_out"][0])


class TestClassEmbedVariants:
    def _run(self, overrides, labels):
        p = _pair(overrides, labels=labels)
        _held(p)
        # labels condition the output
        assert not np.allclose(p["port_out"][0], p["port_out"][1])
        return p

    def test_num_class_embeds_table(self):
        p = self._run(dict(num_class_embeds=10), np.array([3, 7], np.int32))
        assert p["port"].class_embedding.weight.shape == (
            10, 4 * TINY["block_out_channels"][0])

    def test_timestep_class_embed(self):
        self._run(dict(class_embed_type="timestep"),
                  np.array([1, 400], np.int32))

    def test_identity_class_embed(self):
        """The raw vector is added: the same as the ``class_emb`` hook."""
        dim = 4 * TINY["block_out_channels"][0]
        labels = np.random.default_rng(5).standard_normal(
            (B, dim)).astype(np.float32)
        p = self._run(dict(class_embed_type="identity"), labels)
        with torch.no_grad():
            hook = p["port"](*(a[:B] for a in p["args"]),
                             class_emb=torch.from_numpy(labels))
        np.testing.assert_allclose(p["port_out"][0], hook.numpy(),
                                   atol=1e-6, rtol=0)

    def test_projection_class_embed(self):
        labels = np.random.default_rng(6).standard_normal(
            (B, 12)).astype(np.float32)
        self._run(dict(class_embed_type="projection",
                       projection_class_embeddings_input_dim=12), labels)

    def test_projection_requires_input_dim(self):
        with pytest.raises(ValueError, match="projection_class_embeddings"):
            ModelConfig(class_embed_type="projection", **TINY)

    def test_labels_without_config_raise(self):
        unet = UNet1DCondition(ModelConfig(**TINY))
        sample, t, ctx = (torch.from_numpy(a) for a in _inputs(unet.config))
        with pytest.raises(ValueError, match="no class embedding"):
            unet(sample, t, ctx, class_labels=torch.tensor([1, 2]))


# every structural variant at once, and a class mode that runs the labels
# through the Fourier time_proj
FULL = dict(ALL_VARIANTS, class_embed_type="timestep")
LABELS = np.array([2, 600], np.int32)


@pytest.fixture(scope="module")
def full_pair():
    return _pair(FULL, labels=LABELS, seed=3)


def test_full_variant_unet_matches_jax(full_pair):
    _held(full_pair)


def test_full_variant_tts_matches_jax():
    """``TTSSingleSpeaker`` on the all-variant config (no labels: the TTS
    model passes none), text encoder included."""
    jcfg = JaxModelConfig(**TINY, **ALL_VARIANTS)
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 149, (2 * B, jcfg.cmu_seq_len)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 10:] = 0
    sample, t, _ = _inputs(jcfg, 4, 2 * B)
    model = JaxTTS(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, t,
                            ids, mask)
    params = _fill(shapes, rng)
    want = np.asarray(model.apply(params, sample, t, ids, mask))
    port = TTSSingleSpeaker(ModelConfig(**TINY, **ALL_VARIANTS)).eval()
    port.load_state_dict(model_state_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (sample, t, ids, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the round trip port -> JAX -> port of the whole model, bit-equal
    state = port.state_dict()
    back = model_state_from_jax(model_state_to_jax(state, port.config))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_round_trip_of_a_variant_tree_is_bit_equal(full_pair):
    """Port -> JAX -> port, bit for bit, with the leaves JAX names:
    ``unet/time_proj/weight``, ``unet/class_embedding/linear_{1,2}/*`` and
    ``unet/up_0/upsample/{kernel,bias}``; the JAX tree runs in JAX."""
    port_tts = TTSSingleSpeaker(ModelConfig(**TINY, **FULL))
    port_tts.unet.load_state_dict(full_pair["port"].state_dict())
    state = port_tts.state_dict()
    tree = model_state_to_jax(state, port_tts.config)
    unet = tree["params"]["unet"]
    assert unet["time_proj"]["weight"].shape == (32,)
    assert set(unet["class_embedding"]) == {"linear_1", "linear_2"}
    assert unet["up_0"]["upsample"]["kernel"].shape == (4, 64, 64)
    # the JAX kernel layout is the one JAX built
    np.testing.assert_array_equal(
        unet["up_0"]["upsample"]["kernel"],
        np.asarray(full_pair["params"]["params"]["up_0"]["upsample"]
                   ["kernel"]))
    back = model_state_from_jax(tree)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    sample, t, ctx = (a.numpy() for a in full_pair["args"])
    out = full_pair["model"].apply(
        {"params": unet}, sample, t, ctx,
        class_labels=np.concatenate([LABELS, 0 * LABELS]))
    np.testing.assert_array_equal(np.asarray(out)[:B], full_pair["jax"][0])


def test_jax_tree_without_class_embedding_loads():
    """A JAX tree made without labels has no ``class_embedding`` (flax
    creates it on first use): ``load_model_state_`` takes it and keeps the
    port's own class embedding; strict loading names what is missing."""
    jcfg = JaxModelConfig(**TINY, num_class_embeds=10)
    model = JaxUNet(jcfg)
    sample, t, ctx = _inputs(jcfg, 0, 2 * B)
    params = _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), sample,
                                  t, ctx), np.random.default_rng(7))
    assert "class_embedding" not in params["params"]
    want = np.asarray(model.apply(params, sample, t, ctx))
    tts = TTSSingleSpeaker(ModelConfig(**TINY, num_class_embeds=10))
    own = tts.unet.class_embedding.weight.detach().clone()
    state = {f"unet.{k}": v for k, v in
             model_state_from_jax(params).items()}
    state.update({k: v for k, v in tts.state_dict().items()
                  if k.startswith("text_encoder.")})
    with pytest.raises(RuntimeError, match="class_embedding.weight"):
        tts.load_state_dict(state, strict=True)
    load_model_state_(tts, state)
    assert torch.equal(tts.unet.class_embedding.weight, own)
    with torch.no_grad():
        got = tts.unet(*(torch.from_numpy(a) for a in (sample, t, ctx)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("variant", [
    dict(time_embedding_type="fourier"),
    dict(num_class_embeds=10),
    dict(upsample_conv_transpose=True),
    dict(downsample_avg_pool=True)])
def test_export_refuses_a_variant_tree(variant):
    """The reference checkpoint has no such modules: the port's export
    raises naming the leftover paths, the same as JAX's export for the
    embeddings (JAX raises a ``KeyError`` for the conv-transpose upsample's
    missing ``conv`` leaf); the avg-pool downsample has no params and
    exports."""
    cfg = ModelConfig(**TINY, **variant)
    tts = TTSSingleSpeaker(cfg)
    tree = model_state_to_jax(tts.state_dict(), cfg)
    if variant.get("downsample_avg_pool"):
        assert set(export_tree(tree, cfg)) == set(
            jax_export_tree(tree, JaxModelConfig(**TINY, **variant)))
        return
    with pytest.raises(ValueError, match="no reference-checkpoint") as err:
        export_tree(tree, cfg)
    if variant.get("upsample_conv_transpose"):
        assert "['unet/up_0/upsample/bias', 'unet/up_0/upsample/kernel']" \
            in str(err.value)
        with pytest.raises(KeyError, match="unet/up_0/upsample/conv"):
            jax_export_tree(tree, JaxModelConfig(**TINY, **variant))
        return
    with pytest.raises(ValueError) as jerr:
        jax_export_tree(tree, JaxModelConfig(**TINY, **variant))
    assert str(err.value) == str(jerr.value)
    assert ("time_proj" if "time_embedding_type" in variant
            else "class_embedding") in str(err.value)
