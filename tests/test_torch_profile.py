"""``cli.profile`` and ``utils/mel`` of the port.

The cases of ``tests/test_profile.py`` on the port's CLI at the same tiny
config on the CPU: every stage reports FLOPs, a train step costs more than
a denoise step, the whole synthesis covers its two denoise steps and the
decode, an unknown stage is refused by name, and ``--time`` gives ``ms``
and ``pct_peak``.  The FLOP count itself: a kernel wrapper's recorded
operations are what ``FlopCounterMode`` counts of its plain version, so a
stage counts the same on the card.  Then ``log_mel`` and ``mel_distance``
against the JAX package's module, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from prompt_tts_tpu.utils import mel as jax_mel
from prompt_tts_tpu_torch.cli import profile as profile_cli
from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
from prompt_tts_tpu_torch.ops.cuda import opcount
from prompt_tts_tpu_torch.utils import mel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return Config(
        model=ModelConfig(
            block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
            attention_head_dim=32, text_encoder_layers=1,
            cmu_seq_len=64, sample_size=40, layers_per_block=1,
            unet_num_heads=4),
        train=TrainConfig(batch_size=2),
    )


def _run(tmp_path, capsys, extra):
    cfg_path = str(tmp_path / "cfg.json")
    _tiny_cfg().to_json(cfg_path)
    profile_cli.main(["--config_file", cfg_path, "--batch_size", "1",
                      "--num_inference_steps", "2", "--device", "cpu"]
                     + extra)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_default_stages_report_flops(tmp_path, capsys):
    res = _run(tmp_path, capsys, ["--train_batch_size", "1"])
    assert res["backend"] == "cpu" and res["batch_size"] == 1
    assert set(res["stages"]) == {"cond", "denoise", "decode", "train"}
    for name, row in res["stages"].items():
        assert row.get("gflop", 0) > 0, (name, row)
        assert row["peak_mib"] is None     # not measured off the card
    # a full train step (fwd+bwd) must cost more than one denoise fwd
    assert (res["stages"]["train"]["gflop"]
            > res["stages"]["denoise"]["gflop"])


def test_synth_stage_covers_whole_program(tmp_path, capsys):
    res = _run(tmp_path, capsys, ["--stages", "synth,denoise,decode"])
    stages = res["stages"]
    # the text->wav program contains 2 denoise steps + decode
    assert stages["synth"]["gflop"] >= (
        2 * stages["denoise"]["gflop"] + stages["decode"]["gflop"]) * 0.9


def test_unknown_stage_rejected(tmp_path):
    cfg_path = str(tmp_path / "cfg.json")
    _tiny_cfg().to_json(cfg_path)
    with pytest.raises(SystemExit, match="nope"):
        profile_cli.main(["--config_file", cfg_path, "--stages", "nope",
                          "--device", "cpu"])


@pytest.mark.parametrize("stages", ["cond,denoise", "train"])
def test_time_mode_reports_ms_and_pct_peak(tmp_path, capsys, stages):
    res = _run(tmp_path, capsys, ["--stages", stages, "--train_batch_size",
                                  "1", "--time", "--chain", "2"])
    for name in stages.split(","):
        row = res["stages"][name]
        assert row["ms"] > 0 and row["ms"] == row["ms"]   # not NaN
        assert row["pct_peak"] == pytest.approx(
            100 * row["gflop"] / row["ms"] / profile_cli.H100_BF16_TFLOPS)


def test_peak_default_is_the_h100_bf16_rate():
    assert profile_cli.parse_args([]).peak_tflops == 989.0
    assert profile_cli.parse_args([]).device == "cuda"


def _plain_flops(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_kernel_formulas_are_what_the_counter_sees_on_the_cpu():
    """Each plain version (what a wrapper runs on a CPU tensor) counts the
    operations its kernel's formula records on the card: the LSTM's gate
    arithmetic aside, which the counter does not count."""
    from prompt_tts_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_plain,
    )
    from prompt_tts_tpu_torch.ops.cuda.lstm import lstm_recurrence_plain
    from prompt_tts_tpu_torch.ops.cuda.rvq import rvq_encode_plain
    g = torch.Generator().manual_seed(0)
    B, Tq, Tk, H, D = 2, 9, 7, 3, 32
    q, o, do = (torch.randn(B, Tq, H, D, generator=g) for _ in range(3))
    k, v = (torch.randn(B, Tk, H, D, generator=g) for _ in range(2))
    assert _plain_flops(lambda: attention_plain(q, k, v)) == \
        opcount.attention_fwd(B, Tq, Tk, H, D)
    assert _plain_flops(lambda: attention_bwd_plain(q, k, v, o, do)) == \
        opcount.attention_bwd(B, Tq, Tk, H, D)
    T, Hl = 5, 16
    x = torch.randn(T, B, 4 * Hl, generator=g)
    w = torch.randn(Hl, 4 * Hl, generator=g)
    assert _plain_flops(lambda: lstm_recurrence_plain(x, w)) == \
        opcount.lstm(T, B, Hl) - 10 * T * B * Hl
    emb = torch.randn(B, T, 128, generator=g)
    cb = torch.randn(3, 64, 128, generator=g)
    assert _plain_flops(lambda: rvq_encode_plain(emb, cb)) == \
        opcount.rvq_encode(B * T, 3, 64, 128)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resnet_formula_is_the_blocks_convolutions(cin, cout):
    from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
    from prompt_tts_tpu_torch.ops.resnet import resnet_block
    block = ResnetBlock1D(cin, cout, 64, groups=8).eval()
    x = torch.randn(2, 12, cin)
    temb = torch.randn(2, 64)
    proj = _plain_flops(lambda: block.time_emb_proj(temb))
    with torch.no_grad():
        got = _plain_flops(lambda: resnet_block(block, x, temb))
    assert got - proj == opcount.resnet_block(2, 12, cin, cout)


def test_kernel_ops_sums_what_is_recorded_inside():
    opcount.record(5)                   # nothing open: dropped
    with opcount.KernelOps() as outer:
        opcount.record(3)
        with opcount.KernelOps() as inner:
            opcount.record(4)
    opcount.record(7)
    assert (outer.total, inner.total) == (7, 4)


@pytest.mark.parametrize("sr,n", [(24000, 24000), (22050, 5000)])
def test_mel_is_the_jax_module(sr, n):
    rng = np.random.default_rng(sr)
    a = rng.standard_normal(n).astype(np.float32) * 0.3
    b = a + 0.01 * rng.standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(mel.log_mel(a, sr), jax_mel.log_mel(a, sr))
    np.testing.assert_array_equal(mel.mel_filterbank(sr, 1024),
                                  jax_mel.mel_filterbank(sr, 1024))
    for ord_ in (1, 2):
        assert mel.mel_distance(a, b, sr, ord_) == \
            jax_mel.mel_distance(a, b, sr, ord_)
    # shorter than one FFT frame: refused by name (the JAX module indexes
    # past the end and raises IndexError)
    with pytest.raises(ValueError, match="shorter than one FFT frame"):
        mel.log_mel(np.zeros(1000, np.float32))
    assert mel.log_mel(np.zeros(1024, np.float32)).shape == (1, 80)


def test_new_modules_run_without_jax(tmp_path):
    """A process that imports this slice's modules and runs the profile
    CLI's cheapest stage loads no module of jax, flax, optax or the JAX
    package."""
    import subprocess
    import sys
    cfg_path = str(tmp_path / "cfg.json")
    _tiny_cfg().to_json(cfg_path)
    code = (
        "import sys\n"
        "import prompt_tts_tpu_torch.cli.evaluate\n"
        "import prompt_tts_tpu_torch.cli.export_checkpoint\n"
        "import prompt_tts_tpu_torch.data.streaming\n"
        "import prompt_tts_tpu_torch.diffusion.ddpm\n"
        "import prompt_tts_tpu_torch.models.export\n"
        "import prompt_tts_tpu_torch.utils.mel\n"
        "from prompt_tts_tpu_torch.cli.profile import main\n"
        f"main(['--config_file', {cfg_path!r}, '--stages', 'cond',"
        " '--batch_size', '1', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'prompt_tts_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
