"""Drive the PyTorch port once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:
  1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the build of every CUDA kernel from ``prompt_tts_tpu_torch/csrc`` (one
     ``nvcc`` per source, all at once).
  2. kernel: each kernel against its plain PyTorch version on the card at
     the shapes its path gives it (max abs error against a stated
     tolerance; kernel, plain and library times by CUDA events; the least
     time the card could take, from the bytes and operations of the call).
     The attention backward runs last: checked at B=4, then timed at the
     batch the train slice used (32 unless it did not fit).
  3. small: the port's synthesis on the card against the same synthesis on
     the CPU (plain versions): the full-width model at batch 1 and 2 DDIM
     steps, plus the codec, f32.
  4. slice: ``python -m prompt_tts_tpu_torch.cli.synthesize`` at the
     flagship ``ModelConfig()`` width, 4 requests, DDIM-50, bf16 denoiser,
     f32 decode, random seeded weights; checks the WAVs and codes and that
     the path launched every kernel, then times a warm repeat.
  5. train_small: one f32 train step of the full-width model at batch 1,
     dropout off, on the card (kernels) and on the CPU (plain versions),
     same weights, batch, noise and timesteps: loss, gradient norm and
     every gradient compared.
  6. train_slice: ``python -m prompt_tts_tpu_torch.cli.train`` at
     ``ModelConfig()``, bf16 over f32 parameters, batch 32, on a synthetic
     code tar this script writes: 2 epochs (4 steps) with checkpoints, then
     ``--resume`` for a third epoch; checks the losses, the resume, the
     launches of both attention kernels and the parameters' dtype, then
     times warm steps and profiles one.
Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises (non-zero exit); without CUDA it exits non-zero
before any result.
"""

import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time

# one request's window: ModelConfig().sample_size 900 frames at 75 Hz
AUDIO_S = 12.0
SAMPLE_RATE = 24000
N_REQUESTS = 4
STEPS = 50
# the flagship trainer's batch (tools/configs/flagship_chiprun.json); the
# train slice steps down to 16, then 8, only if it does not fit
TRAIN_BATCHES = (32, 16, 8)
TRAIN_UTTERANCES = 64

# Tolerances, kernel vs plain on the same inputs.
# f32 attention: same math, f32 sums in another order over <= 900 keys.
ATTN_TOL_F32 = 2e-5
# bf16 attention: the plain version stores bf16 scores and bf16
# probabilities, the kernel keeps both in f32; outputs |o| <~ 4 are bf16
# (ulp 1.6e-2 at 2..4), so a couple of ulps.
ATTN_TOL_BF16 = 3e-2
# Attention backward against the f32 plain backward of the same inputs, per
# output (dq, dk, dv, dbias): |err| <= BWD_TOL * (1 + max|ref|) -- f32 sums
# in another order; for bf16 inputs, plus BWD_RTOL_BF16 * |ref| on dq, dk,
# dv, which the kernel rounds to bf16 once (half an ulp is 2^-9 relative).
BWD_TOL = 2e-5
BWD_RTOL_BF16 = 4e-3
# LSTM: f32 both sides, gate sums in another order, 900 steps of a
# contractive recurrence.
LSTM_TOL = 1e-5
# One f32 train step, card vs CPU, TF32 off: the loss to 1e-4 (the model's
# outputs agree to its 5e-4 contract and the MSE averages them), the global
# gradient norm and every gradient tensor to 1e-3 in relative L2.  A tensor
# whose gradient is zero in exact arithmetic (a bias in front of a
# GroupNorm) is rounding noise on both sides, held below 1e-6 of the norm.
TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL, ZERO_GRAD = 1e-4, 1e-3, 1e-6

# Least time for a call: bytes moved (each input read once, each output
# written once) over the memory rate, and operations over the peak rate of
# the inputs' type (NVIDIA's H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# The attention calls of one flagship UNet forward by shape class:
# (Tq, head_dim, transformers at that depth); each transformer makes one
# self- and one cross-attention call (cross: Tk = 550 text tokens).
UNET_ATTN = ((900, 32, 5), (450, 64, 5), (225, 96, 5), (113, 96, 1))
TEXT_LEN, TEXT_HEADS, TEXT_HEAD_DIM, TEXT_LAYERS = 550, 12, 64, 4
# attention calls per forward (and per train step): 32 UNet + 4 text
ATTN_CALLS = 2 * sum(n for _, _, n in UNET_ATTN) + TEXT_LAYERS

TEXTS = ["Hello from the port.", "Printing, in the only sense with which "
         "we are at present concerned.", "One two three four.",
         "The quick brown fox jumps over the lazy dog."]


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


def bound(flops, nbytes, dtype):
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flop": flops, "bytes": nbytes}


def attn_cases():
    """(label, Tq, Tk, H, D, masked, calls per forward) of the path."""
    cases = []
    for T, D, n in UNET_ATTN:
        cases.append((f"self T={T} D={D}", T, T, 8, D, False, n))
        cases.append((f"cross T={T} Tk={TEXT_LEN} D={D}", T, TEXT_LEN, 8, D,
                      False, n))
    cases.append((f"text T={TEXT_LEN} D={TEXT_HEAD_DIM} masked", TEXT_LEN,
                  TEXT_LEN, TEXT_HEADS, TEXT_HEAD_DIM, True, TEXT_LAYERS))
    return cases


def attn_inputs(g, B, Tq, Tk, H, D, masked, dtype):
    import torch
    dev = torch.device("cuda")
    q = torch.randn(B, Tq, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Tk, H, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Tk, H, D, generator=g, device=dev).to(dtype)
    bias = None
    if masked:   # padded text: request i keeps Tk >> i tokens
        keep = torch.arange(Tk, device=dev)[None, :] < (
            Tk >> torch.arange(B, device=dev))[:, None]
        bias = ((1.0 - keep.float()) * -1e4)[:, None, None, :]
    return q, k, v, bias


def sdpa(q, k, v, bias):
    """The library call for the same attention, on [B,H,T,D] views."""
    import torch.nn.functional as F
    mask = None if bias is None else bias.to(q.dtype)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask).transpose(1, 2)


def phase_card():
    import torch
    from prompt_tts_tpu_torch.ops.cuda import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_all(("attention", "attention_bwd", "lstm"))
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds)})
    return smi


def phase_attention_fwd(smi):
    """The forward kernel against its plain version at B=4, f32 and bf16;
    returns the bf16 sums over one UNet forward's 32 calls."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_plain
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    g = torch.Generator("cuda").manual_seed(0)
    B = N_REQUESTS
    err_all = 0.0
    unet = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
            "bytes": 0}
    with torch.no_grad():
        for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                           (torch.bfloat16, ATTN_TOL_BF16)):
            for label, Tq, Tk, H, D, masked, n in attn_cases():
                q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked, dtype)
                out = flash_attention(q, k, v, bias)
                ref = attention_plain(q, k, v, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ms = cuda_ms(lambda: flash_attention(q, k, v, bias), 20)
                plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bias), 20)
                lib_ms = cuda_ms(lambda: sdpa(q, k, v, bias), 20)
                size = q.element_size()
                flop = 4 * B * H * Tq * Tk * D
                nbytes = size * 2 * B * H * D * (Tq + Tk) + (
                    0 if bias is None else 4 * B * Tk)
                ok = bool(torch.isfinite(out).all()) and err <= tol
                dname = str(dtype).split(".")[-1]
                emit({"phase": "kernel", "kernel": "attention_fwd",
                      "case": label, "dtype": dname, "B": B,
                      "max_abs_err": err, "tol": tol, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      **bound(flop, nbytes, dname), "ok": ok, "card": smi})
                if not ok:
                    raise AssertionError(f"attention {label} {dtype}: max abs "
                                         f"err {err} > {tol}")
                err_all = max(err_all, err)
                if dtype == torch.bfloat16 and not masked:
                    # the synthesis slice's denoiser dtype, UNet calls only
                    for key, t in (("ms", ms), ("plain_ms", plain_ms),
                                   ("library_ms", lib_ms)):
                        unet[key] += n * t
                    unet["flop"] += n * flop
                    unet["bytes"] += n * nbytes
    # one UNet forward's 32 attention calls, bf16, B=4
    b = bound(unet.pop("flop"), unet.pop("bytes"), "bfloat16")
    return {"max_abs_err": err_all, **unet, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "unit": "one UNet forward's 32 calls, bf16, B=4"}


def _bwd_errors(got, ref, dtype):
    """Max abs error per output and whether each is within tolerance."""
    import torch
    errs, ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if a is None:
            continue
        diff = (a.float() - b.float()).abs()
        limit = BWD_TOL * (1.0 + b.abs().max())
        if dtype == torch.bfloat16 and name != "dbias":
            limit = limit + BWD_RTOL_BF16 * b.float().abs()
        errs[name] = diff.max().item()
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            (diff <= limit).all())
    return errs, ok


def phase_attention_bwd(smi, train_batch):
    """The backward kernel against the f32 plain backward at B=4 (f32 and
    bf16 inputs), then timed at the training batch in bf16 over one train
    step's 36 calls: kernel, plain, and the library's backward (SDPA
    through autograd)."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_bwd_plain
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    g = torch.Generator("cuda").manual_seed(1)
    err_all = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, Tq, Tk, H, D, masked, n in attn_cases():
            q, k, v, bias = attn_inputs(g, N_REQUESTS, Tq, Tk, H, D, masked,
                                        dtype)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            o, lse = flash_attention(q, k, v, bias, return_lse=True)
            got = attention_bwd(q, k, v, o, do, bias, lse,
                                need_dbias=masked)
            ref = attention_bwd_plain(q.float(), k.float(), v.float(),
                                      o.float(), do.float(), bias)
            torch.cuda.synchronize()
            errs, ok = _bwd_errors(got, ref, dtype)
            emit({"phase": "kernel", "kernel": "attention_bwd",
                  "case": label, "dtype": dname, "B": N_REQUESTS,
                  "max_abs_err": errs, "tol": BWD_TOL,
                  "rtol": BWD_RTOL_BF16 if dtype == torch.bfloat16 else 0.0,
                  "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"attention_bwd {label} {dname}: {errs}")
            err_all = max(err_all, *errs.values())
            del q, k, v, do, o, lse, got, ref

    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "fwd_lse_ms": 0.0, "flop": 0, "bytes": 0}
    B, dtype = train_batch, torch.bfloat16
    for label, Tq, Tk, H, D, masked, n in attn_cases():
        q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked, dtype)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        o, lse = flash_attention(q, k, v, bias, return_lse=True)
        fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, bias,
                                                 return_lse=True), 10)
        ms = cuda_ms(lambda: attention_bwd(q, k, v, o, do, bias, lse,
                                           need_dbias=masked), 10)
        plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, o, do, bias),
                           3)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves, bias)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 10)
        size = q.element_size()
        # recomputed scores, dv, dp, dq, dk: five [Tq,Tk,D] products
        flop = 10 * B * H * Tq * Tk * D
        # q, o, do in and dq out; k, v in and dk, dv out; the f32 lse in;
        # the bias in and its gradient out where it is masked
        nbytes = (size * 4 * B * H * D * (Tq + Tk) + 4 * B * H * Tq
                  + (8 * B * Tk if masked else 0))
        b = bound(flop, nbytes, "bfloat16")
        emit({"phase": "kernel_time", "kernel": "attention_bwd",
              "case": label, "dtype": "bfloat16", "B": B, "calls": n,
              "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "fwd_lse_ms": fwd_ms, **b, "card": smi})
        for key, t in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("fwd_lse_ms", fwd_ms)):
            step[key] += n * t
        step["flop"] += n * flop
        step["bytes"] += n * nbytes
        del q, k, v, do, o, lse, leaves, out
        torch.cuda.empty_cache()
    b = bound(step.pop("flop"), step.pop("bytes"), "bfloat16")
    return {"max_abs_err": err_all, **step, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "unit": f"one train step's {ATTN_CALLS} calls, bf16, B={B}"}


def phase_lstm(smi):
    import torch
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence, lstm_recurrence_plain,
    )
    g = torch.Generator("cuda").manual_seed(2)
    T, B, H = 900, N_REQUESTS, 512
    with torch.no_grad():
        x = torch.randn(T, B, 4 * H, generator=g, device="cuda") * 0.5
        w = torch.randn(H, 4 * H, generator=g, device="cuda") * H ** -0.5
        out = lstm_recurrence(x, w)
        ref = lstm_recurrence_plain(x, w)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = cuda_ms(lambda: lstm_recurrence(x, w), 3)
        plain_ms = cuda_ms(lambda: lstm_recurrence_plain(x, w), 3)
        # cuDNN's LSTM on x_proj as its input: w_ih = identity, zero biases,
        # the same w_hh; it does one extra [4H,4H] input projection
        lib = torch.nn.LSTM(4 * H, H, device="cuda")
        lib.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lib.weight_hh_l0.copy_(w.t())
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()
        lib_out = lib(x)[0]
        lib_err = (lib_out - ref).abs().max().item()
        lib_ms = cuda_ms(lambda: lib(x), 3)
    ok = bool(torch.isfinite(out).all()) and err <= LSTM_TOL
    flop = T * B * (2 * H * 4 * H + 10 * H)
    nbytes = 4 * (T * B * 4 * H + H * 4 * H + T * B * H)
    b = bound(flop, nbytes, "float32")
    emit({"phase": "kernel", "kernel": "lstm", "case": f"T={T} B={B} H={H}",
          "dtype": "float32", "max_abs_err": err, "tol": LSTM_TOL, "ms": ms,
          "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_max_abs_err": lib_err,
          "library_note": "cuDNN nn.LSTM with w_ih = I: one extra 4Hx4H "
                          "input projection", **b, "ok": ok, "card": smi})
    if not ok:
        raise AssertionError(f"lstm: max abs err {err} > {LSTM_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "unit": f"one layer, T={T} B={B} H={H}"}


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
    ids, mask = runs["cpu"].tokenizer.encode_batch(TEXTS[3:])
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
    """The synthesis CLI at full width; returns the launches it made."""
    import wave
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    from prompt_tts_tpu_torch.ops.cuda.lstm import lstm_recurrence
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    with tempfile.TemporaryDirectory() as tmp:
        argv = sum((["--text", t] for t in TEXTS), []) + [
            "--out", os.path.join(tmp, "smoke.wav"), "--steps", str(STEPS),
            "--device", "cuda", "--dtype", "bf16", "--seed", "0"]
        flash_attention.launches = 0
        attention_bwd.launches = 0
        lstm_recurrence.launches = 0
        t0 = time.perf_counter()
        paths, wavs, codes = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {"attention_fwd": flash_attention.launches,
                    "attention_bwd": attention_bwd.launches,
                    "lstm": lstm_recurrence.launches}
        files = []
        for p in paths:
            with wave.open(p, "rb") as w:
                files.append((w.getframerate(), w.getnframes()))
    n_samples = int(AUDIO_S * SAMPLE_RATE)
    want = {"attention_fwd": TEXT_LAYERS + 32 * STEPS, "attention_bwd": 0,
            "lstm": 2}
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
    synth.synthesize(TEXTS)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        synth.synthesize(TEXTS)      # returns host numpy: synchronized
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[1]
    emit({"phase": "slice_warm", "what": f"Synthesizer.synthesize "
          f"{N_REQUESTS} x {AUDIO_S:.0f} s, DDIM-{STEPS} bf16 + f32 decode",
          "wall_s": times, "median_wall_s": wall,
          "x_realtime": N_REQUESTS * AUDIO_S / wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})
    return launches


def phase_train_small(smi):
    """One f32 train step of the full-width model at batch 1, dropout off:
    card (kernels) against CPU (plain versions)."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import ModelConfig, TrainConfig
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import (
        LAUNCHES_PER_CALL, attention_bwd,
    )
    from prompt_tts_tpu_torch.pipeline import random_init_
    from prompt_tts_tpu_torch.train.state import TrainState
    from prompt_tts_tpu_torch.train.step import make_loss_fn
    cfg = dataclasses.replace(ModelConfig(), text_encoder_dropout=0.0)
    assert cfg.dropout == 0.0
    tcfg = TrainConfig(batch_size=1, learning_rate=1e-4, lr_warmup_steps=0)
    rng = np.random.default_rng(3)
    ids, mask = Tokenizer(max_len=cfg.cmu_seq_len).encode_batch(TEXTS[1:2])
    codes = rng.integers(0, 1024, (1, cfg.sample_size, 8))
    batch = {"codes": torch.from_numpy(
                 (codes * (2 / 1023) - 1).astype(np.float32)),
             "text_ids": torch.from_numpy(ids),
             "text_mask": torch.from_numpy(mask)}
    inputs = {"noise": torch.from_numpy(rng.standard_normal(
                  (1, cfg.sample_size, 8)).astype(np.float32)),
              "timesteps": torch.tensor([421])}
    weights = TTSSingleSpeaker(cfg)
    random_init_(weights, torch.Generator().manual_seed(0))
    res, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = TTSSingleSpeaker(cfg, device=dev)
        model.load_state_dict(weights.state_dict())
        state = TrainState(model, tcfg, num_training_steps=10)
        loss_fn = make_loss_fn(model, linear_schedule(device=dev))
        model.train()
        flash_attention.launches = attention_bwd.launches = 0
        t0 = time.perf_counter()
        loss = loss_fn({k: t.to(dev) for k, t in batch.items()},
                       **{k: t.to(dev) for k, t in inputs.items()})
        loss.backward()
        # a copy: the clip below scales the gradients in place
        grads[dev] = {n: p.grad.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()}
        norm = state.apply_gradients()
        res[dev] = {"loss": loss.item(), "grad_norm": norm.item(),
                    "step_s": time.perf_counter() - t0,
                    "attention_fwd": flash_attention.launches,
                    "attention_bwd": attention_bwd.launches}
        del model, state, loss
    gc.collect()
    torch.cuda.empty_cache()
    gn = res["cpu"]["grad_norm"]
    worst, worst_name, zero = 0.0, None, 0
    for n, ref in grads["cpu"].items():
        err = (grads["cuda"][n] - ref).norm().item()
        if ref.norm().item() <= ZERO_GRAD * gn:
            zero += 1
            rel = err / (ZERO_GRAD * gn)     # must stay <= 1
        else:
            rel = err / ref.norm().item() / TRAIN_GRAD_RTOL
        if rel > worst:
            worst, worst_name = rel, n
    checks = {
        "loss": abs(res["cuda"]["loss"] - res["cpu"]["loss"])
        <= TRAIN_LOSS_TOL,
        "grad_norm": abs(res["cuda"]["grad_norm"] - gn)
        <= TRAIN_GRAD_RTOL * gn,
        "grads": worst <= 1.0,
        "finite": all(np.isfinite(res["cuda"][k]) for k in ("loss",
                                                           "grad_norm")),
        "launches": (res["cuda"]["attention_fwd"] == ATTN_CALLS
                     and res["cuda"]["attention_bwd"]
                     == LAUNCHES_PER_CALL * ATTN_CALLS),
    }
    emit({"phase": "train_small", "what": "ModelConfig() B=1 f32 dropout "
          "off, one train step, cuda vs cpu", "cuda": res["cuda"],
          "cpu": res["cpu"], "loss_tol": TRAIN_LOSS_TOL,
          "grad_rtol": TRAIN_GRAD_RTOL,
          "worst_grad_err_over_tol": worst, "worst_grad": worst_name,
          "zero_grad_tensors": zero, "checks": checks, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"train_small checks failed: {checks}")


def write_code_tar(path, n, frames, seed=0):
    """A code tar in generate_codes' layout: <id>.npy [8, frames] codes,
    <id>.txt, <id>.len.txt."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 1024, (8, frames)).astype(np.int64))
            add(tf, f"utt{i:03d}.npy", buf.getvalue())
            add(tf, f"utt{i:03d}.txt", TEXTS[i % len(TEXTS)].encode())
            add(tf, f"utt{i:03d}.len.txt", str(frames).encode())


def _logged(log_dir, tag):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def _kernel_class(name):
    for cls, pat in (("attention_fwd", r"attn_fwd"),
                     ("attention_bwd", r"attn_bwd"),
                     ("conv", r"fprop|dgrad|wgrad|conv|cudnn|nchwToNhwc|"
                              r"nhwcToNchw"),
                     ("gemm", r"gemm|nvjet|xmma|cutlass|sm90_"),
                     ("norm", r"norm|Norm|welford"),
                     ("optimizer", r"adam|Adam|multi_tensor")):
        if re.search(pat, name):
            return cls
    return "other"


def profile_step(step):
    """Device time by kernel class of one train step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, kernels, top = {}, 0, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us <= 0 or getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        kernels += e.count
        top.append((us / 1e3, e.count, e.key[:80]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "kernels": kernels,
            "idle_share": 1 - busy / (wall * 1e3) if wall > 0 else None,
            "by_class_ms": by_class, "top": top[:12]}


def phase_train_slice(smi):
    """The train CLI at full width; returns the launches of its runs and
    the batch it used."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import (
        LAUNCHES_PER_CALL, attention_bwd,
    )
    from prompt_tts_tpu_torch.ops.cuda.lstm import lstm_recurrence

    def counts():
        return {"attention_fwd": flash_attention.launches,
                "attention_bwd": attention_bwd.launches,
                "lstm": lstm_recurrence.launches}

    def zero():
        flash_attention.launches = attention_bwd.launches = 0
        lstm_recurrence.launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        tar = os.path.join(tmp, "codes.tar")
        write_code_tar(tar, TRAIN_UTTERANCES, 900)
        ckpt, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        trainer = None
        for batch in TRAIN_BATCHES:
            argv = ["--data_file", tar, "--log_dir", logs, "--ckpt_dir", ckpt,
                    "--bf16", "--batch_size", str(batch), "--log_every", "1",
                    "--device", "cuda"]
            zero()
            try:
                t0 = time.perf_counter()
                trainer = cli.main(argv + ["--epochs", "2"])
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                break
            except torch.cuda.OutOfMemoryError as e:
                emit({"phase": "train_slice_batch", "batch": batch,
                      "fits": False, "error": str(e)[:200], "card": smi})
                trainer = None
                gc.collect()
                torch.cuda.empty_cache()
                for d in (ckpt, logs):
                    shutil.rmtree(d, ignore_errors=True)
        if trainer is None:
            raise AssertionError("the train slice fits at no batch >= 8")
        run1 = counts()
        steps1 = trainer.global_step
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        zero()
        t0 = time.perf_counter()
        trainer = cli.main(argv + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        run2 = counts()
        losses = _logged(logs, "Loss/train")
        norms = _logged(logs, "grad_norm")
        saved = trainer.ckpt.all_steps()
        per_epoch = TRAIN_UTTERANCES // batch
        want1 = {"attention_fwd": ATTN_CALLS * 2 * per_epoch,
                 "attention_bwd": LAUNCHES_PER_CALL * ATTN_CALLS * 2
                 * per_epoch, "lstm": 0}
        want2 = {k: v // 2 for k, v in want1.items()}
        params = list(trainer.model.parameters())
        checks = {
            "steps": steps1 == 2 * per_epoch
            and trainer.global_step == 3 * per_epoch,
            "resumed_at": min(s for s in losses if s > steps1) == steps1 + 1,
            "logged": sorted(losses) == list(range(1, 3 * per_epoch + 1)),
            "finite": all(np.isfinite(v) for v in list(losses.values())
                          + list(norms.values())),
            "checkpoints": saved[-1] == 3 * per_epoch,
            "launches": run1 == want1 and run2 == want2,
            "f32_master": all(p.dtype == torch.float32 for p in params) and
            all(trainer.state.optimizer.state[p]["exp_avg"].dtype
                == torch.float32 for p in params),
        }
        emit({"phase": "train_slice", "what": f"cli.train ModelConfig() "
              f"--bf16 --batch_size {batch}, {TRAIN_UTTERANCES} utterances "
              f"x 900 frames: 2 epochs, then --resume to 3",
              "checks": checks, "launches_first": run1, "want_first": want1,
              "launches_resume": run2, "want_resume": want2,
              "loss": losses, "grad_norm": norms, "checkpoints": saved,
              "first_run_s": first_s, "resume_run_s": resume_s,
              "card": smi})
        if not all(checks.values()):
            raise AssertionError(f"train slice checks failed: {checks}")

        # warm steps on the same trainer: median wall of a synchronised step
        dev_batch = trainer._to_device(next(trainer.dataset.batches(batch)))

        def step():
            trainer._step_fn(dev_batch, trainer.generator)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        emit({"phase": "train_warm", "what": f"train step ModelConfig() bf16 "
              f"B={batch}", "step_s": times,
              "median_step_s": statistics.median(times),
              "examples_per_s": batch / statistics.median(times),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "card": smi})
        emit({"phase": "train_profile", "what": f"one train step B={batch}",
              **profile_step(step), "card": smi})
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return {k: run1[k] + run2[k] for k in run1}, batch


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from prompt_tts_tpu_torch.pipeline import full_f32

    smi = phase_card()
    with full_f32():
        fwd = phase_attention_fwd(smi)
        lstm = phase_lstm(smi)
    synth = phase_slice(smi)
    with full_f32():
        phase_small(smi)
        phase_train_small(smi)
    train, batch = phase_train_slice(smi)
    with full_f32():
        bwd = phase_attention_bwd(smi, batch)
    launches = {k: synth[k] + train[k] for k in synth}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the paths never ran: {launches}")
    paths = {k: {"synthesize": synth[k], "train": train[k]} for k in synth}
    emit({"kernels": [
        {"name": "attention_fwd", "route": "cuda",
         "source": "prompt_tts_tpu_torch/csrc/attention.cu",
         "replaces": "prompt_tts_tpu/ops/pallas/attention.py:103",
         "launches": launches["attention_fwd"],
         "launches_by_path": paths["attention_fwd"], **fwd},
        {"name": "attention_bwd", "route": "cuda",
         "source": "prompt_tts_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "prompt_tts_tpu/ops/pallas/attention_bwd.py:151",
         "launches": launches["attention_bwd"],
         "launches_by_path": paths["attention_bwd"], **bwd},
        {"name": "lstm_recurrence", "route": "cuda",
         "source": "prompt_tts_tpu_torch/csrc/lstm.cu",
         "replaces": "prompt_tts_tpu/ops/pallas/lstm.py:81",
         "launches": launches["lstm"], "launches_by_path": paths["lstm"],
         **lstm},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
