"""Drive the PyTorch port once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:
  1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the build of every CUDA kernel from ``prompt_tts_tpu_torch/csrc``.
  2. kernel: each kernel against its plain PyTorch version on the card at
     the shapes the synthesis path gives it (max abs error against a stated
     tolerance, kernel and plain times by CUDA events).
  3. small: the port's synthesis on the card against the same synthesis on
     the CPU (plain versions): the full-width model at batch 1 and 2 DDIM
     steps, plus the codec, f32.
  4. slice: ``python -m prompt_tts_tpu_torch.cli.synthesize`` at the
     flagship ``ModelConfig()`` width, 4 requests, DDIM-50, bf16 denoiser,
     f32 decode, random seeded weights; checks the WAVs and codes and that
     the path launched every kernel, then times a warm repeat.
Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises (non-zero exit); without CUDA it exits non-zero
before any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# one request's window: ModelConfig().sample_size 900 frames at 75 Hz
AUDIO_S = 12.0
SAMPLE_RATE = 24000
N_REQUESTS = 4
STEPS = 50

# Tolerances, kernel vs plain on the same inputs.
# f32 attention: same math, f32 sums in another order over <= 900 keys.
ATTN_TOL_F32 = 2e-5
# bf16 attention: the plain version stores bf16 scores and bf16
# probabilities, the kernel keeps both in f32; outputs |o| <~ 4 are bf16
# (ulp 1.6e-2 at 2..4), so a couple of ulps.
ATTN_TOL_BF16 = 3e-2
# LSTM: f32 both sides, gate sums in another order, 900 steps of a
# contractive recurrence.
LSTM_TOL = 1e-5

# The attention calls of one flagship UNet forward by shape class:
# (Tq, head_dim, transformers at that depth); each transformer makes one
# self- and one cross-attention call (cross: Tk = 550 text tokens).
UNET_ATTN = ((900, 32, 5), (450, 64, 5), (225, 96, 5), (113, 96, 1))
TEXT_LEN, TEXT_HEADS, TEXT_HEAD_DIM, TEXT_LAYERS = 550, 12, 64, 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def phase_card():
    import torch
    from prompt_tts_tpu_torch.ops.cuda import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    for name in ("attention", "lstm"):
        _build.load(name)
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds)})
    return smi


def phase_kernels(smi):
    """Each kernel against its plain version; returns per-kernel summaries."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_plain
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence, lstm_recurrence_plain,
    )
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    B = N_REQUESTS
    cases = []   # (label, Tq, Tk, H, D, masked, calls per UNet forward)
    for T, D, n in UNET_ATTN:
        cases.append((f"self T={T} D={D}", T, T, 8, D, False, n))
        cases.append((f"cross T={T} Tk={TEXT_LEN} D={D}", T, TEXT_LEN, 8, D,
                      False, n))
    cases.append((f"text T={TEXT_LEN} D={TEXT_HEAD_DIM} masked", TEXT_LEN,
                  TEXT_LEN, TEXT_HEADS, TEXT_HEAD_DIM, True, 0))
    attn_err, per_forward = 0.0, []   # bf16 (calls, ms, plain_ms)
    with torch.no_grad():
        for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                           (torch.bfloat16, ATTN_TOL_BF16)):
            for label, Tq, Tk, H, D, masked, n in cases:
                q = torch.randn(B, Tq, H, D, generator=g, device=dev).to(dtype)
                k = torch.randn(B, Tk, H, D, generator=g, device=dev).to(dtype)
                v = torch.randn(B, Tk, H, D, generator=g, device=dev).to(dtype)
                bias = None
                if masked:   # padded text: request i keeps 550 >> i tokens
                    keep = torch.arange(Tk, device=dev)[None, :] < (
                        Tk >> torch.arange(B, device=dev))[:, None]
                    bias = ((1.0 - keep.float()) * -1e4)[:, None, None, :]
                out = flash_attention(q, k, v, bias)
                ref = attention_plain(q, k, v, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ms = cuda_ms(lambda: flash_attention(q, k, v, bias), 20)
                plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bias), 20)
                ok = bool(torch.isfinite(out).all()) and err <= tol
                emit({"phase": "kernel", "kernel": "attention", "case": label,
                      "dtype": str(dtype).split(".")[-1], "B": B,
                      "max_abs_err": err, "tol": tol, "ms": ms,
                      "plain_ms": plain_ms, "ok": ok, "card": smi})
                if not ok:
                    raise AssertionError(f"attention {label} {dtype}: max abs "
                                         f"err {err} > {tol}")
                attn_err = max(attn_err, err)
                if dtype == torch.bfloat16:   # the slice's denoiser dtype
                    per_forward.append((n, ms, plain_ms))
    # one UNet forward's 32 attention calls: each class's time x its calls
    attn = {"max_abs_err": attn_err,
            "ms": sum(n * ms for n, ms, _ in per_forward),
            "plain_ms": sum(n * p for n, _, p in per_forward)}

    with torch.no_grad():
        T, H = 900, 512
        x = torch.randn(T, B, 4 * H, generator=g, device=dev) * 0.5
        w = torch.randn(H, 4 * H, generator=g, device=dev) * H ** -0.5
        out = lstm_recurrence(x, w)
        ref = lstm_recurrence_plain(x, w)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = cuda_ms(lambda: lstm_recurrence(x, w), 3)
        plain_ms = cuda_ms(lambda: lstm_recurrence_plain(x, w), 3)
        ok = bool(torch.isfinite(out).all()) and err <= LSTM_TOL
        emit({"phase": "kernel", "kernel": "lstm", "case":
              f"T={T} B={B} H={H}", "dtype": "float32",
              "max_abs_err": err, "tol": LSTM_TOL, "ms": ms,
              "plain_ms": plain_ms, "ok": ok, "card": smi})
        if not ok:
            raise AssertionError(f"lstm: max abs err {err} > {LSTM_TOL}")
    lstm = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return attn, lstm


def phase_small(smi):
    """The full-width model at batch 1 and 2 DDIM steps, f32: the card's
    kernels against the CPU's plain versions, same weights and inputs."""
    import torch
    from prompt_tts_tpu_torch.pipeline import Synthesizer, latents_to_codes
    # latents: the model-level 5e-4 contract (f32 both sides).  wav from the
    # same codes: cuDNN's f32 algorithms against the CPU's direct
    # convolutions through 15 layers; 1e-4 on |wav| of order 1.
    lat_tol, wav_tol = 5e-4, 1e-4
    runs = {dev: Synthesizer(device=dev, dtype=torch.float32,
                             num_inference_steps=2) for dev in ("cpu", "cuda")}
    ids, mask = runs["cpu"].tokenizer.encode_batch(
        ["The quick brown fox jumps over the lazy dog."])
    x_T = torch.randn((1, 900, 8), generator=torch.Generator().manual_seed(7))
    out = {}
    for dev, synth in runs.items():
        t0 = time.perf_counter()
        lat = synth.denoise_latents(x_T.to(dev),
                                    torch.as_tensor(ids, device=dev),
                                    torch.as_tensor(mask, device=dev))
        out[dev] = lat.cpu()
        out[dev + "_s"] = time.perf_counter() - t0
    codes = latents_to_codes(out["cpu"])
    wav_cpu = runs["cpu"].codec_runner.decode(codes)
    wav_gpu = runs["cuda"].codec_runner.decode(codes.cuda()).cpu()
    lat_err = (out["cuda"] - out["cpu"]).abs().max().item()
    wav_err = (wav_gpu - wav_cpu).abs().max().item()
    # within the latent tolerance (5e-4 * 511.5 < 0.5) a code can only
    # round to its neighbour
    code_diff = (latents_to_codes(out["cuda"]) - codes).abs()
    flips = (code_diff > 0).float().mean().item()
    ok = (lat_err <= lat_tol and wav_err <= wav_tol
          and code_diff.max().item() <= 1
          and bool(torch.isfinite(wav_gpu).all()))
    emit({"phase": "small", "what": "ModelConfig() B=1 DDIM-2 f32 + codec, "
          "cuda vs cpu", "latent_max_abs_err": lat_err, "latent_tol": lat_tol,
          "code_flip_share": flips, "wav_max_abs_err": wav_err,
          "wav_tol": wav_tol, "max_abs_wav": wav_cpu.abs().max().item(),
          "cuda_denoise_s": out["cuda_s"], "cpu_denoise_s": out["cpu_s"],
          "ok": ok, "card": smi})
    if not ok:
        raise AssertionError("card synthesis disagrees with the CPU")
    del runs


def phase_slice(smi):
    """The CLI at full width; returns the launches it made."""
    import wave
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.lstm import lstm_recurrence
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    texts = ["Hello from the port.", "Printing, in the only sense with "
             "which we are at present concerned.", "One two three four.",
             "The quick brown fox jumps over the lazy dog."]
    with tempfile.TemporaryDirectory() as tmp:
        argv = sum((["--text", t] for t in texts), []) + [
            "--out", os.path.join(tmp, "smoke.wav"), "--steps", str(STEPS),
            "--device", "cuda", "--dtype", "bf16", "--seed", "0"]
        flash_attention.launches = 0
        lstm_recurrence.launches = 0
        t0 = time.perf_counter()
        paths, wavs, codes = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {"attention": flash_attention.launches,
                    "lstm": lstm_recurrence.launches}
        files = []
        for p in paths:
            with wave.open(p, "rb") as w:
                files.append((w.getframerate(), w.getnframes()))
    n_samples = int(AUDIO_S * SAMPLE_RATE)
    want = {"attention": TEXT_LAYERS + 32 * STEPS, "lstm": 2}
    checks = {
        "wav_files": files == [(SAMPLE_RATE, n_samples)] * N_REQUESTS,
        "wav_shape": wavs.shape == (N_REQUESTS, n_samples),
        "wav_finite": bool(np.isfinite(wavs).all()),
        "codes_shape": codes.shape == (N_REQUESTS, 8, 900),
        "codes_range": bool(codes.min() >= 0 and codes.max() <= 1023),
        "launches": launches == want,
    }
    emit({"phase": "slice", "what": f"cli.synthesize ModelConfig() "
          f"{N_REQUESTS} requests DDIM-{STEPS} bf16 + f32 decode",
          "checks": checks, "launches": launches, "want_launches": want,
          "cli_wall_s": cli_s, "max_abs_wav": float(np.abs(wavs).max()),
          "code_min": int(codes.min()), "code_max": int(codes.max()),
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")

    # steady state: the same batch on a built, warmed Synthesizer
    synth = Synthesizer(device="cuda", dtype=torch.bfloat16,
                        num_inference_steps=STEPS)
    synth.synthesize(texts)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        synth.synthesize(texts)      # returns host numpy: synchronized
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[1]
    emit({"phase": "slice_warm", "what": f"Synthesizer.synthesize "
          f"{N_REQUESTS} x {AUDIO_S:.0f} s, DDIM-{STEPS} bf16 + f32 decode",
          "wall_s": times, "median_wall_s": wall,
          "x_realtime": N_REQUESTS * AUDIO_S / wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from prompt_tts_tpu_torch.pipeline import full_f32

    smi = phase_card()
    with full_f32():
        attn, lstm = phase_kernels(smi)
    phase_small(smi)
    launches = phase_slice(smi)
    emit({"kernels": [
        {"name": "attention_fwd", "route": "cuda",
         "source": "prompt_tts_tpu_torch/csrc/attention.cu",
         "replaces": "prompt_tts_tpu/ops/pallas/attention.py:103",
         "launches": launches["attention"], **attn},
        {"name": "lstm_recurrence", "route": "cuda",
         "source": "prompt_tts_tpu_torch/csrc/lstm.cu",
         "replaces": "prompt_tts_tpu/ops/pallas/lstm.py:81",
         "launches": launches["lstm"], **lstm},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
