"""``--remat`` and ``--profile_steps`` in the port's trainer.

The remat step (each resnet block, spatial transformer and encoder layer
a non-reentrant ``torch.utils.checkpoint`` region) against the plain step
on the same model, batch and generator states, with the text encoder's
dropout at 0.1, for both families: the loss and every gradient bit for
bit (a block with dropout restores the global generators before its
recompute, so it draws the same masks).  The blocks it checkpoints, and
the model's own forwards back after the call.  Then ``cli.train --smoke
--remat`` logs the plain run's losses, and ``--profile_steps`` writes a
Chrome trace naming ``train_step``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from prompt_tts_tpu_torch.config import ModelConfig
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.pipeline import random_init_
from prompt_tts_tpu_torch.train.step import (
    _draws, make_loss_fn, remat_blocks,
)

CFG = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
           attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
           sample_size=48, layers_per_block=1, unet_num_heads=4,
           text_encoder_dropout=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, prompted, rng, B=2):
    b = {"codes": rng.uniform(-1, 1, (B, cfg.sample_size, 8)),
         "text_ids": rng.integers(1, 149, (B, cfg.cmu_seq_len)),
         "text_mask": np.ones((B, cfg.cmu_seq_len), np.int64)}
    b["text_mask"][0, 20:] = 0
    if prompted:
        b["prompt"] = rng.uniform(-1, 1, (B, cfg.prompt_frames, 8))
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype == np.float64
                                         else np.int64))
            for k, v in b.items()}


@pytest.mark.parametrize("prompted", [False, True])
def test_remat_loss_and_gradients_are_the_plain_bits(prompted):
    cfg = ModelConfig(**CFG, prompt_conditioning=prompted)
    model = (TTSPromptSpeaker if prompted else TTSSingleSpeaker)(cfg)
    random_init_(model, torch.Generator().manual_seed(0))
    model.train()
    batch = _batch(cfg, prompted, np.random.default_rng(1))
    out = {}
    for remat in (False, True):
        # the condition drop draws from the step's generator, dropout
        # from the global one: both from the same states
        loss_fn = make_loss_fn(model, linear_schedule(), 0.5, remat=remat)
        torch.manual_seed(7)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, torch.Generator().manual_seed(3))
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    assert set(out[False][1]) == set(out[True][1])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name
    # dropout is on: another draw gives another loss
    torch.manual_seed(8)
    other = make_loss_fn(model, linear_schedule(), 0.5, remat=True)(
        batch, torch.Generator().manual_seed(3))
    assert not torch.equal(other.detach(), out[True][0])


@pytest.mark.parametrize("prompted", [False, True])
def test_remat_checkpoints_each_block_then_restores_the_model(prompted):
    from prompt_tts_tpu_torch.models.layers import TransformerBlock
    from prompt_tts_tpu_torch.models.unet1d import (
        ResnetBlock1D, SpatialTransformer1D,
    )
    cfg = ModelConfig(**CFG, prompt_conditioning=prompted)
    model = (TTSPromptSpeaker if prompted else TTSSingleSpeaker)(cfg)
    blocks = remat_blocks(model)
    kinds = [type(m) for m in blocks]
    n_res = sum(isinstance(m, ResnetBlock1D) for m in model.modules())
    n_st = sum(isinstance(m, SpatialTransformer1D) for m in model.modules())
    n_layers = CFG["text_encoder_layers"] + (
        cfg.prompt_encoder_layers if prompted else 0)
    assert kinds.count(ResnetBlock1D) == n_res > 0
    assert kinds.count(SpatialTransformer1D) == n_st > 0
    assert kinds.count(TransformerBlock) == n_layers
    # the generators are restored only where a block draws: the text
    # encoder's layers (dropout 0.1), not the UNet's (no dropout)
    assert [m for m in blocks if _draws(m)] == [
        m for m in blocks if isinstance(m, TransformerBlock)
        and m in list(model.text_encoder.modules())]
    batch = _batch(cfg, prompted, np.random.default_rng(2))
    make_loss_fn(model, linear_schedule(), remat=True)(
        batch, torch.Generator().manual_seed(0)).backward()
    assert all("forward" not in vars(m) for m in blocks)


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f)
                if r["tag"] == "Loss/train"]


def test_cli_remat_and_profile_steps(tmp_path):
    """``--remat --profile_steps 1`` over two smoke epochs (4 steps): the
    losses of the plain run, and a trace of step 3 naming ``train_step``."""
    from prompt_tts_tpu_torch.cli import train as cli
    runs = {}
    for name, extra in (("plain", []),
                        ("remat", ["--remat", "--profile_steps", "1"])):
        log_dir = str(tmp_path / name)
        torch.manual_seed(0)
        trainer = cli.main(["--smoke", "--device", "cpu", "--epochs", "2",
                            "--log_dir", log_dir] + extra)
        assert trainer.global_step == 4
        runs[name] = _losses(log_dir)
    assert len(runs["plain"]) == 4
    assert runs["remat"] == runs["plain"]
    traces = glob.glob(str(tmp_path / "remat" / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 1
    assert not os.path.exists(tmp_path / "plain" / "trace")


def test_profile_steps_must_not_be_negative(tmp_path):
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.train.loop import Trainer
    cfg = Config(model=ModelConfig(**CFG))
    with pytest.raises(ValueError, match="profile_steps"):
        Trainer(cfg, SyntheticDataset(n=4, frames=48, max_seq_length=32),
                str(tmp_path), device="cpu", profile_steps=-1)
