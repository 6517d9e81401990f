"""Drive the PyTorch port once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:
  1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the build of all six CUDA kernels from ``prompt_tts_tpu_torch/csrc``
     (one ``nvcc`` per source, all at once).
  2. kernel: each kernel against its plain PyTorch version on the card at
     the shapes its path gives it (max abs error against a stated
     tolerance; kernel, plain and library times by CUDA events; the least
     time the card could take, from the bytes and operations of the call).
     The attention forward also on the prompt path's inputs (CFG's null
     text with every key masked, cross-attention over 550 + 32 keys, the
     prompt encoder's calls); both LSTM schedules at the decoder's B=4, the
     encoder's B=32 and the prompt encode's T=225; the fused resnet block at
     every block shape of one UNet forward (bf16 at B=8, f32 at B=1); the
     RVQ encode inside the encode slice (its inputs are that slice's
     latents); the attention backward last: checked at B=4, then timed,
     with the forward, at the batch the train slice used.
  3. small: the port's synthesis on the card against the same synthesis on
     the CPU (plain versions): the full-width model at batch 1 and 2 DDIM
     steps, plus the codec, f32.
  4. slice: ``python -m prompt_tts_tpu_torch.cli.synthesize`` at the
     flagship ``ModelConfig()`` width, 4 requests, DDIM-50, bf16 denoiser,
     f32 decode, random seeded weights; checks the WAVs and codes and that
     the path launched every kernel, then times a warm repeat.
  4b. prompt_slice: the same CLI with a prompt-conditioned config this
     script writes (``ModelConfig(prompt_conditioning=True)``), a 3 s voice
     prompt at 22.05 kHz (resampled), 4 requests, DPM-Solver++ 25 steps,
     CFG 3, bf16; checks the WAVs, codes and launches, times a warm repeat
     and profiles it; then a warm codec encode and decode in the LSTM
     schedule the CLI did not take.
  4c. prompt_small: the full-width prompt model, f32, batch 1, DPM-2, CFG
     3, on the card (kernels) against the CPU (plain versions), same
     weights, x_T and prompt codes.
  5. encode_small: a 2 x 1.5 s f32 encode through the full-width codec on
     the card and on the CPU: latents and codes compared.
  6. train_small: one f32 train step of the full-width model at batch 1,
     dropout off, on the card (kernels) and on the CPU (plain versions),
     same weights, batch, noise and timesteps: loss, gradient norm and
     every gradient compared.
  7. encode_slice: ``python -m prompt_tts_tpu_torch.cli.generate_codes
     --batch_size 32`` on a wav tar this script writes (64 utterances of
     2-12 s at 22.05 kHz, with transcripts): checks the code tar and that
     the path launched the RVQ and LSTM kernels; then the RVQ kernel's
     index contract and times on the slice's latents and on normal vectors,
     and a warm ``CodecRunner.encode`` of 32 x 12 s timed by CUDA events.
  8. train_slice: ``python -m prompt_tts_tpu_torch.cli.train`` at
     ``ModelConfig()``, bf16 over f32 parameters, batch 32, on the code tar
     the encode slice wrote: 2 epochs (4 steps) with checkpoints, then
     ``--resume`` for a third epoch; checks the losses, the resume, the
     launches of both attention kernels and the parameters' dtype, then
     times warm steps and profiles one.  Audio -> codes -> training, all
     on the card.
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

# the card the encode phases drive (a name, so they can be rehearsed on
# the CPU with the plain versions)
DEVICE = "cuda"
# one request's window: ModelConfig().sample_size 900 frames at 75 Hz
AUDIO_S = 12.0
SAMPLE_RATE = 24000
N_REQUESTS = 4
STEPS = 50
# the flagship trainer's batch (tools/configs/flagship_chiprun.json); the
# train slice steps down to 16, then 8, only if it does not fit
TRAIN_BATCHES = (32, 16, 8)
# the encode slice's wav tar, which the train slice then trains on:
# LJSpeech's rate, 2-12 s clips, generate_codes' default batch
ENCODE_UTTERANCES, ENCODE_SR, ENCODE_BATCH = 64, 22050, 32
# the prompt slice: DPM-Solver++ steps, CFG scale, a 3 s voice prompt at
# LJSpeech's rate (resampled to 24 kHz: 225 frames, the config's
# prompt_frames)
PROMPT_STEPS, GUIDANCE, PROMPT_S = 25, 3.0, 3.0

# Tolerances, kernel vs plain on the same inputs.
# f32 attention: same math, f32 sums in another order over <= 900 keys.
ATTN_TOL_F32 = 2e-5
# bf16 attention: the plain version stores bf16 scores and bf16
# probabilities, the kernel keeps both in f32; outputs |o| <~ 4 are bf16
# (ulp 1.6e-2 at 2..4), so a couple of ulps.
ATTN_TOL_BF16 = 3e-2
# Rows whose keys are all masked (CFG's null text), kernel vs the f32 plain
# version of the same inputs: the scores sit at -1e4, where an f32 ulp is
# ~1e-3, so the two sides' probabilities differ by ~1e-3 relative; plus the
# bf16 output's rounding (|o| < 1: half an ulp <= 2e-3).
ATTN_TOL_ALL_MASKED = 5e-3
# Attention backward against the f32 plain backward of the same inputs, per
# output (dq, dk, dv, dbias): |err| <= BWD_TOL * (1 + max|ref|) -- f32 sums
# in another order; for bf16 inputs, plus BWD_RTOL_BF16 * |ref| on dq, dk,
# dv, which the kernel rounds to bf16 once (half an ulp is 2^-9 relative).
BWD_TOL = 2e-5
BWD_RTOL_BF16 = 4e-3
# LSTM (both schedules): f32 both sides, gate sums in another order, 900
# steps of a contractive recurrence.
LSTM_TOL = 1e-5
# Fused resnet block vs its plain version (the module arithmetic), max |err|
# <= tol * max(1, max |ref|).  f32: the same math, sums in another order,
# GroupNorm statistics as shifted sums (E[(x-K)^2] - E[x-K]^2, tiles
# combined in f64) where torch takes two passes: ~1e-6 relative.  bf16: the
# plain version rounds conv1's output and then h + temb (two roundings),
# the kernel rounds h once as the TPU kernel does; a bf16 ulp is 2^-8
# relative and the difference passes through GN2, conv2 and the output's
# own rounding.
RESNET_TOL_F32, RESNET_TOL_BF16 = 1e-4, 3e-2
# The codec decode in the two LSTM schedules on the same codes: f32, the
# 900-step recurrences differ by LSTM_TOL, then 15 conv layers.
SCHEDULE_WAV_TOL = 1e-4
# RVQ encode, kernel vs plain (cuBLAS, TF32 off): every vector whose
# indices differ is a near-tie in f64 at its first differing layer
# (prompt_tts_tpu_torch/ops/cuda/rvq.py:index_contract, 1e-5 of
# (|r| + |e|)^2), and at most this share of the vectors differ.
RVQ_MAX_DIFFER = 1e-3
# An f32 encode, card vs CPU: latents through 16 conv layers and the 2-layer
# LSTM, cuDNN's f32 algorithms against the CPU's: 1e-4 of
# max(1, max |latent|); the codes may then differ at RVQ_MAX_DIFFER.
ENC_TOL = 1e-4
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
# the prompt path: 32 prompt tokens join the text (cross Tk = 582); the
# prompt encoder's 2 self-attention blocks over the 225 -> 57 frame stem
# (8 heads x 96) and its pooling of 32 queries over them
PROMPT_TOKENS, PROMPT_T, PROMPT_BLOCKS = 32, 57, 2
# the kernels' launch counters, by name in the kernels line
KERNELS = ("attention_fwd", "attention_bwd", "lstm", "lstm_t", "rvq_encode",
           "resnet")

TEXTS = ["Hello from the port.", "Printing, in the only sense with which "
         "we are at present concerned.", "One two three four.",
         "The quick brown fox jumps over the lazy dog."]


def emit(obj):
    print(json.dumps(obj), flush=True)


def _counters():
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence, lstm_recurrence_t,
    )
    from prompt_tts_tpu_torch.ops.cuda.resnet import fused_resnet_block
    from prompt_tts_tpu_torch.ops.cuda.rvq import rvq_encode
    return dict(zip(KERNELS, (flash_attention, attention_bwd,
                              lstm_recurrence, lstm_recurrence_t, rvq_encode,
                              fused_resnet_block)))


def zero_counts():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for fn in _counters().values():
        fn.launches = 0


def counts():
    """Every kernel's launch count since the last :func:`zero_counts`."""
    return {k: fn.launches for k, fn in _counters().items()}


def want_counts(**kw):
    """The launches a path should make: ``kw`` by kernel, the rest 0; the
    ``lstm`` launches go to the kernel of the default schedule."""
    from prompt_tts_tpu_torch.codec.layers import DEFAULT_LSTM_SCHEDULE
    want = dict.fromkeys(KERNELS, 0)
    n = kw.pop("lstm", 0)
    want["lstm" if DEFAULT_LSTM_SCHEDULE == "step" else "lstm_t"] = n
    want.update(kw)
    return want


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
    _build.load_all(("attention", "attention_bwd", "lstm", "lstm_t",
                     "resnet", "rvq"))
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
    err_all = max(err_all, _attention_prompt_cases(smi))
    # one UNet forward's 32 attention calls, bf16, B=4
    b = bound(unet.pop("flop"), unet.pop("bytes"), "bfloat16")
    return {"max_abs_err": err_all, **unet, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "unit": "one UNet forward's 32 calls, bf16, B=4"}


def _attention_prompt_cases(smi):
    """The forward kernel on the prompt path's own inputs, f32 and bf16,
    against the plain version: CFG's null text (every one of the 550 keys
    masked), the UNet's cross-attention over 550 text + 32 prompt keys, and
    the prompt encoder's self-attention and pooling.  Checked, not timed.
    The all-masked rows are held against the f32 plain version of the same
    inputs at ATTN_TOL_ALL_MASKED: the bias shifts every score alike, so
    the kernel's f32 scores give the softmax of the unmasked scores, while
    the bf16 plain version adds the bias in bf16 (ulp 64 at 1e4), rounding
    every score to -1e4 (uniform rows).  Returns the largest error."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_plain
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    g = torch.Generator("cuda").manual_seed(11)
    B, Tk = 2 * N_REQUESTS, TEXT_LEN + PROMPT_TOKENS
    cases = [("null text, all keys masked", TEXT_LEN, TEXT_LEN, TEXT_HEADS,
              TEXT_HEAD_DIM, "all"),
             (f"cross T=900 Tk={Tk} D=32", 900, Tk, 8, 32, None),
             (f"cross T=113 Tk={Tk} D=96", 113, Tk, 8, 96, None),
             (f"prompt self T={PROMPT_T} D=96", PROMPT_T, PROMPT_T, 8, 96,
              None),
             (f"prompt pool T={PROMPT_TOKENS} Tk={PROMPT_T} D=96",
              PROMPT_TOKENS, PROMPT_T, 8, 96, None)]
    err_all = 0.0
    with torch.no_grad():
        for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                           (torch.bfloat16, ATTN_TOL_BF16)):
            for label, Tq, Tk_, H, D, mask in cases:
                q, k, v, _ = attn_inputs(g, B, Tq, Tk_, H, D, False, dtype)
                bias = (torch.full((B, 1, 1, Tk_), -1e4, device="cuda")
                        if mask == "all" else None)
                out = flash_attention(q, k, v, bias)
                if mask == "all":
                    case_tol = ATTN_TOL_ALL_MASKED
                    ref = attention_plain(q.float(), k.float(), v.float(),
                                          bias)
                else:
                    case_tol = tol
                    ref = attention_plain(q, k, v, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = bool(torch.isfinite(out).all()) and err <= case_tol
                emit({"phase": "kernel", "kernel": "attention_fwd",
                      "case": "prompt path: " + label,
                      "dtype": str(dtype).split(".")[-1], "B": B,
                      "max_abs_err": err, "tol": case_tol, "ok": ok,
                      "card": smi})
                if not ok:
                    raise AssertionError(f"attention {label} {dtype}: max "
                                         f"abs err {err} > {case_tol}")
                err_all = max(err_all, err)
    return err_all


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
    through autograd); and the forward kernel with the lse at the same
    calls: kernel, plain and SDPA forward.  Returns the backward's and the
    forward's sums."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_plain,
    )
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
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
           "bytes": 0}
    B, dtype = train_batch, torch.bfloat16
    for label, Tq, Tk, H, D, masked, n in attn_cases():
        q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked, dtype)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        o, lse = flash_attention(q, k, v, bias, return_lse=True)
        fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, bias,
                                                 return_lse=True), 10)
        fwd_plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bias), 3)
        fwd_lib_ms = cuda_ms(lambda: sdpa(q, k, v, bias), 10)
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
        # the forward with the lse: q, k, v in, o and the f32 lse out
        fwd_flop = 4 * B * H * Tq * Tk * D
        fwd_bytes = (size * 2 * B * H * D * (Tq + Tk) + 4 * B * H * Tq
                     + (4 * B * Tk if masked else 0))
        emit({"phase": "kernel_time", "kernel": "attention_fwd_lse",
              "case": label, "dtype": "bfloat16", "B": B, "calls": n,
              "ms": fwd_ms, "plain_ms": fwd_plain_ms,
              "library_ms": fwd_lib_ms,
              **bound(fwd_flop, fwd_bytes, "bfloat16"), "card": smi})
        for key, t in (("ms", fwd_ms), ("plain_ms", fwd_plain_ms),
                       ("library_ms", fwd_lib_ms)):
            fwd[key] += n * t
        fwd["flop"] += n * fwd_flop
        fwd["bytes"] += n * fwd_bytes
        for key, t in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("fwd_lse_ms", fwd_ms)):
            step[key] += n * t
        step["flop"] += n * flop
        step["bytes"] += n * nbytes
        del q, k, v, do, o, lse, leaves, out
        torch.cuda.empty_cache()
    b = bound(step.pop("flop"), step.pop("bytes"), "bfloat16")
    fb = bound(fwd.pop("flop"), fwd.pop("bytes"), "bfloat16")
    unit = f"one train step's {ATTN_CALLS} calls, bf16, B={B}"
    return ({"max_abs_err": err_all, **step, "bound_ms": b["bound_ms"],
             "bound_by": b["bound_by"], "unit": unit},
            {**fwd, "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
             "unit": unit + ", with the lse"})


def _lstm_case(smi, T, B, g):
    """Both LSTM kernels (the step schedule on w_hh [H,4H], the persistent
    one on w_hh_t [4H,H], the same weights) against their plain versions,
    timed beside cuDNN.  Returns a row for each."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence, lstm_recurrence_plain, lstm_recurrence_t,
        lstm_recurrence_t_plain, lstm_t_grid, UNITS_PER_CTA,
    )
    H = 512
    with torch.no_grad():
        x = torch.randn(T, B, 4 * H, generator=g, device="cuda") * 0.5
        w = torch.randn(H, 4 * H, generator=g, device="cuda") * H ** -0.5
        w_t = w.t().contiguous()
        # cuDNN's LSTM on x_proj as its input: w_ih = identity, zero biases,
        # the same w_hh; it does one extra [4H,4H] input projection
        lib = torch.nn.LSTM(4 * H, H, device="cuda")
        lib.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lib.weight_hh_l0.copy_(w_t)
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()
        lib_ms = cuda_ms(lambda: lib(x), 3)
        rows = {}
        for name, fn, plain, wt in (
                ("lstm", lstm_recurrence, lstm_recurrence_plain, w),
                ("lstm_t", lstm_recurrence_t, lstm_recurrence_t_plain, w_t)):
            out = fn(x, wt)
            ref = plain(x, wt)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ms = cuda_ms(lambda: fn(x, wt), 3)
            plain_ms = cuda_ms(lambda: plain(x, wt), 2)
            ok = bool(torch.isfinite(out).all()) and err <= LSTM_TOL
            flop = T * B * (2 * H * 4 * H + 10 * H)
            nbytes = 4 * (T * B * 4 * H + H * 4 * H + T * B * H)
            b = bound(flop, nbytes, "float32")
            extra = {}
            if name == "lstm_t":
                grid, max_ctas = lstm_t_grid(B, H)
                extra = {"units_per_cta": UNITS_PER_CTA, "grid": grid,
                         "max_resident_ctas": max_ctas}
            emit({"phase": "kernel", "kernel": name,
                  "case": f"T={T} B={B} H={H}", "dtype": "float32",
                  "max_abs_err": err, "tol": LSTM_TOL, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library_note": "cuDNN nn.LSTM with w_ih = I: one extra "
                                  "4Hx4H input projection", **extra, **b,
                  "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"{name} T={T} B={B}: max abs err {err} "
                                     f"> {LSTM_TOL}")
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b["bound_ms"],
                          "bound_by": b["bound_by"],
                          "unit": f"one layer, T={T} B={B} H={H}"}
    return rows


def phase_lstm(smi):
    """Both LSTM kernels at the decoder's batch (the synthesis slices' 4,
    T=900), at the encoder's (the encode slice's 32) and at the prompt
    encode's T=225, B=4.  Returns the step and persistent rows."""
    import torch
    g = torch.Generator("cuda").manual_seed(2)
    dec = _lstm_case(smi, 900, N_REQUESTS, g)
    enc = _lstm_case(smi, 900, ENCODE_BATCH, g)
    prompt = _lstm_case(smi, int(PROMPT_S * 75), N_REQUESTS, g)
    rows = {}
    for name in ("lstm", "lstm_t"):
        rows[name] = dict(dec[name], encoder_b32=enc[name],
                          prompt_encode=prompt[name])
    return rows["lstm"], rows["lstm_t"]


def resnet_shapes(cfg):
    """``(name, T, Cin, Cout)`` of every ResnetBlock1D of one UNet forward,
    in forward order, from the port's ``UNet1DCondition`` (built on the
    meta device) and the lengths its down path gives."""
    from prompt_tts_tpu_torch.models.unet1d import (
        ResnetBlock1D, UNet1DCondition,
    )
    unet = UNet1DCondition(cfg, device="meta")
    lens = [cfg.sample_size]
    for _ in cfg.block_out_channels[1:]:
        lens.append((lens[-1] + 1) // 2)     # k3 s2 p1
    shapes = []
    for name, m in unet.named_modules():
        if isinstance(m, ResnetBlock1D):
            block = name.split(".")[0]
            if block == "mid":
                T = lens[-1]
            elif block.startswith("down_"):
                T = lens[int(block[5:])]
            else:
                T = lens[len(lens) - 1 - int(block[3:])]
            shapes.append((name, T, m.conv1.conv.in_channels,
                           m.conv1.conv.out_channels))
    return shapes


def _resnet_block(cin, cout, dtype, g):
    """A ResnetBlock1D on the card with random weights, and non-trivial
    norm scales and biases."""
    import torch
    from prompt_tts_tpu_torch.models.layers import cast_compute_
    from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
    from prompt_tts_tpu_torch.pipeline import random_init_
    block = ResnetBlock1D(cin, cout, 1024)
    random_init_(block, g)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return cast_compute_(block.to("cuda").eval(), dtype)


def resnet_sequence(block, xc, tp):
    """The library-call yardstick: the block as torch's own calls in
    channels-first ``[B, C, T]`` (no layout copies), ``tp [B, Cout]``."""
    import torch.nn.functional as F
    n1, n2 = block.norm1.norm, block.norm2.norm
    c1, c2, sc = block.conv1.conv, block.conv2.conv, block.conv_shortcut
    dt = xc.dtype
    h = F.conv1d(F.silu(F.group_norm(xc, n1.num_groups, n1.weight.to(dt),
                                     n1.bias.to(dt), n1.eps)),
                 c1.weight, c1.bias, padding=1)
    h = h + tp[:, :, None]
    h = F.conv1d(F.silu(F.group_norm(h, n2.num_groups, n2.weight.to(dt),
                                     n2.bias.to(dt), n2.eps)),
                 c2.weight, c2.bias, padding=1)
    return h + (xc if sc is None else F.conv1d(xc, sc.conv.weight,
                                               sc.conv.bias))


def phase_resnet(smi):
    """The fused resnet block at every block shape of one flagship UNet
    forward: bf16 at B=8 (CFG's doubled batch of 4 requests; checked and
    timed: kernel, plain version, and the channels-first library sequence)
    and f32 at B=1 (checked).  Returns the bf16 sums over the forward."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.config import ModelConfig
    from prompt_tts_tpu_torch.ops.resnet import (
        resnet_block, resnet_block_plain,
    )
    shapes = resnet_shapes(ModelConfig())
    emit({"phase": "resnet_shapes", "blocks": len(shapes),
          "shapes": [list(t) for t in shapes]})
    g = torch.Generator().manual_seed(12)
    per_shape, err_all = {}, 0.0
    for _, T, cin, cout in shapes:
        if (T, cin, cout) in per_shape:
            continue
        row = {}
        for dtype, B, tol in ((torch.bfloat16, 2 * N_REQUESTS,
                               RESNET_TOL_BF16),
                              (torch.float32, 1, RESNET_TOL_F32)):
            block = _resnet_block(cin, cout, dtype, g)
            x = (torch.randn(B, T, cin, generator=g) * 1.5
                 + torch.randn(cin, generator=g)).to("cuda", dtype)
            temb = torch.randn(B, 1024, generator=g).to("cuda")
            with torch.no_grad():
                tp = block.time_emb_proj(F.silu(temb))
                out = resnet_block(block, x, temb)
                ref = resnet_block_plain(block, x, tp)
                torch.cuda.synchronize()
                scale = max(1.0, ref.float().abs().max().item())
                err = (out.float() - ref.float()).abs().max().item()
                ok = bool(torch.isfinite(out).all()) and err <= tol * scale
                dname = str(dtype).split(".")[-1]
                rec = {"max_abs_err": err, "tol": tol * scale}
                if dtype == torch.bfloat16:
                    xc = x.transpose(1, 2).contiguous()
                    rec["ms"] = cuda_ms(lambda: resnet_block(block, x, temb),
                                        20)
                    rec["plain_ms"] = cuda_ms(
                        lambda: resnet_block_plain(block, x, tp), 10)
                    rec["library_ms"] = cuda_ms(
                        lambda: resnet_sequence(block, xc, tp), 10)
                    w = 3 * cin * cout + 3 * cout * cout + (
                        cin * cout if cin != cout else 0)
                    rec.update(bound(2 * B * T * w,
                                     2 * (B * T * (cin + cout) + w),
                                     dname))
            emit({"phase": "kernel", "kernel": "resnet",
                  "case": f"T={T} Cin={cin} Cout={cout}", "dtype": dname,
                  "B": B, **rec, "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"resnet T={T} {cin}->{cout} {dname}: "
                                     f"max abs err {err} > {tol * scale}")
            err_all = max(err_all, err)
            if dtype == torch.bfloat16:
                row = rec
            del block, x, out, ref
        per_shape[(T, cin, cout)] = row
    unet = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
            "bytes": 0}
    for _, T, cin, cout in shapes:
        r = per_shape[(T, cin, cout)]
        for key in unet:
            unet[key] += r[key]
    b = bound(unet.pop("flop"), unet.pop("bytes"), "bfloat16")
    out = {"max_abs_err": err_all, **unet, "bound_ms": b["bound_ms"],
           "bound_by": b["bound_by"],
           "library_note": "the block as torch calls in channels-first "
                           "[B,C,T] (group_norm, silu, conv1d): no one call "
                           "computes it",
           "unit": f"one UNet forward's {len(shapes)} blocks, bf16, "
                   f"B={2 * N_REQUESTS}"}
    emit({"phase": "kernel_time", "kernel": "resnet", **out, "card": smi})
    return out


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
    from prompt_tts_tpu_torch.config import ModelConfig
    import wave
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    with tempfile.TemporaryDirectory() as tmp:
        argv = sum((["--text", t] for t in TEXTS), []) + [
            "--out", os.path.join(tmp, "smoke.wav"), "--steps", str(STEPS),
            "--device", "cuda", "--dtype", "bf16", "--seed", "0"]
        zero_counts()
        t0 = time.perf_counter()
        paths, wavs, codes = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = counts()
        files = []
        for p in paths:
            with wave.open(p, "rb") as w:
                files.append((w.getframerate(), w.getnframes()))
    n_samples = int(AUDIO_S * SAMPLE_RATE)
    n_res = len(resnet_shapes(ModelConfig()))
    want = want_counts(attention_fwd=TEXT_LAYERS + 32 * STEPS,
                       resnet=n_res * STEPS, lstm=2)
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


def prompt_config():
    """The prompt-conditioned flagship: ModelConfig() widths with
    prompt_conditioning (2-layer prompt encoder, 32 tokens, 225 frames)."""
    from prompt_tts_tpu_torch.config import ModelConfig
    return dataclasses.replace(ModelConfig(), prompt_conditioning=True)


def phase_prompt_slice(smi, tmp):
    """The synthesis CLI on the prompt family at full width; returns the
    launches it made and those of a warm codec encode + decode in the other
    LSTM schedule."""
    import wave
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.codec.layers import (
        DEFAULT_LSTM_SCHEDULE, LSTM_SCHEDULES,
    )
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    from prompt_tts_tpu_torch.utils.resample import resample
    from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav
    cfg = prompt_config()
    cfg_path = os.path.join(tmp, "prompt_config.json")
    Config(model=cfg).to_json(cfg_path)
    wav_path = os.path.join(tmp, "voice.wav")
    write_wav(wav_path, tone(np.random.default_rng(13),
                             int(PROMPT_S * ENCODE_SR)), ENCODE_SR)
    argv = sum((["--text", t] for t in TEXTS), []) + [
        "--out", os.path.join(tmp, "prompt.wav"), "--config_file", cfg_path,
        "--prompt_wav", wav_path, "--sampler", "dpm", "--steps",
        str(PROMPT_STEPS), "--guidance_scale", str(GUIDANCE), "--device",
        "cuda", "--dtype", "bf16", "--seed", "0"]
    zero_counts()
    t0 = time.perf_counter()
    paths, wavs, codes = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counts()
    files = []
    for p in paths:
        with wave.open(p, "rb") as w:
            files.append((w.getframerate(), w.getnframes()))
    n_samples = int(AUDIO_S * SAMPLE_RATE)
    n_res = len(resnet_shapes(cfg))
    # conditional + null branch: the text encoder and the prompt encoder
    # (self-attention blocks and pooling) twice; 32 UNet calls a step
    want = want_counts(
        attention_fwd=2 * (TEXT_LAYERS + PROMPT_BLOCKS + 1)
        + 32 * PROMPT_STEPS, resnet=n_res * PROMPT_STEPS, lstm=4,
        rvq_encode=1)
    checks = {
        "wav_files": files == [(SAMPLE_RATE, n_samples)] * N_REQUESTS,
        "wav_shape": wavs.shape == (N_REQUESTS, n_samples),
        "wav_finite": bool(np.isfinite(wavs).all()),
        "codes_shape": codes.shape == (N_REQUESTS, 8, 900),
        "codes_range": bool(codes.min() >= 0 and codes.max() <= 1023),
        "launches": launches == want,
    }
    emit({"phase": "prompt_slice", "what": f"cli.synthesize "
          f"ModelConfig(prompt_conditioning=True) {N_REQUESTS} requests, "
          f"{PROMPT_S:.0f} s prompt at {ENCODE_SR} Hz, DPM-{PROMPT_STEPS} "
          f"CFG {GUIDANCE} bf16 + f32 codec", "checks": checks,
          "launches": launches, "want_launches": want, "cli_wall_s": cli_s,
          "max_abs_wav": float(np.abs(wavs).max()), "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"prompt slice checks failed: {checks}")

    # steady state on a built Synthesizer, the CLI's prompt at 24 kHz
    audio, sr = read_wav(wav_path)
    prompt_wav = np.tile(resample(audio, sr, SAMPLE_RATE)[None, :, 0],
                         (N_REQUESTS, 1))
    synth = Synthesizer(config=Config(model=cfg), device="cuda",
                        dtype=torch.bfloat16,
                        num_inference_steps=PROMPT_STEPS, sampler="dpm",
                        guidance_scale=GUIDANCE)

    def run():
        return synth.synthesize(TEXTS, prompt_wav=prompt_wav,
                                return_codes=True)

    run()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, warm_codes = run()          # host numpy: synchronized
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    emit({"phase": "prompt_slice_warm", "what": f"Synthesizer.synthesize "
          f"{N_REQUESTS} x {AUDIO_S:.0f} s + a {PROMPT_S:.0f} s prompt, "
          f"DPM-{PROMPT_STEPS} CFG {GUIDANCE} bf16 + f32 codec",
          "wall_s": times, "median_wall_s": wall,
          "x_realtime": N_REQUESTS * AUDIO_S / wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})
    emit({"phase": "prompt_slice_profile", "what": "one warm prompt "
          "synthesize", **profile_step(run), "card": smi})

    # the RVQ kernel at the prompt encode's own shape, on its latents
    runner = synth.codec_runner
    rvq = prompt_rvq(smi, runner, prompt_wav)

    # the other LSTM schedule, by the explicit argument, on the same codec
    # and inputs: a warm encode of the prompt and a decode of the codes
    default = DEFAULT_LSTM_SCHEDULE
    other = next(s for s in LSTM_SCHEDULES if s != default)
    runner.encode(prompt_wav, lstm_schedule=other)
    runner.decode(warm_codes, lstm_schedule=other)
    torch.cuda.synchronize()
    zero_counts()
    codes_o = runner.encode(prompt_wav, lstm_schedule=other)
    wav_o = runner.decode(warm_codes, lstm_schedule=other)
    torch.cuda.synchronize()
    other_launches = counts()
    codes_d = runner.encode(prompt_wav)
    wav_d = runner.decode(warm_codes)
    wav_err = (wav_o - wav_d).abs().max().item()
    flips = (codes_o != codes_d).float().mean().item()
    want_o = dict.fromkeys(KERNELS, 0)
    want_o.update({"lstm" if other == "step" else "lstm_t": 4,
                   "rvq_encode": 1})
    checks = {"launches": other_launches == want_o,
              "wav": wav_err <= SCHEDULE_WAV_TOL,
              "code_flips": flips <= RVQ_MAX_DIFFER}
    emit({"phase": "codec_other_schedule", "what": f"warm CodecRunner.encode "
          f"of the prompt and .decode of the codes, lstm_schedule={other!r} "
          f"(the default is {default!r})",
          "launches": other_launches, "want_launches": want_o,
          "wav_max_abs_err_vs_default": wav_err, "wav_tol": SCHEDULE_WAV_TOL,
          "code_flip_share_vs_default": flips, "checks": checks,
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"the other LSTM schedule: {checks}")
    del synth, runner
    gc.collect()
    torch.cuda.empty_cache()
    return launches, other_launches, rvq


def prompt_rvq(smi, runner, prompt_wav):
    """The RVQ kernel against its plain version on the encoder latents of
    the prompt wavs ``[B, 225, 128]`` (a ragged last tile), by the index
    contract; prints each vector whose codes differ."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.rvq import (
        index_contract, rvq_encode, rvq_encode_plain,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32
    wav = torch.as_tensor(prompt_wav, device=DEVICE)
    with torch.no_grad(), full_f32():
        emb = runner.codec.encoder(wav[..., None]).contiguous()
        cb = runner.codec.codebooks[:8].detach()
        got = rvq_encode(emb, cb)
        ref = rvq_encode_plain(emb, cb)
        torch.cuda.synchronize()
        r = index_contract(emb, cb, got, ref)
    B, T, D = emb.shape
    r["ok"] = (r["violations"] == 0
               and r["differ"] <= RVQ_MAX_DIFFER * r["vectors"]
               and tuple(got.shape) == (B, cb.shape[0], T))
    ref = ref.to(got.device)
    differing = [{"b": b, "t": t, "kernel": got[b, :, t].tolist(),
                  "plain": ref[b, :, t].tolist()}
                 for b, t in (got != ref).any(1).nonzero().tolist()]
    emit({"phase": "kernel", "kernel": "rvq_encode", "case": "prompt latents",
          "shape": f"[{B}, {T}, {D}] x [{cb.shape[0]}, {cb.shape[1]}, {D}]",
          **r, "max_differ_share": RVQ_MAX_DIFFER,
          "differing_vectors": differing, "card": smi})
    if not r["ok"]:
        raise AssertionError(f"rvq_encode on the prompt latents: {r}")
    return r


def phase_prompt_small(smi):
    """The full-width prompt model at batch 1, DPM-2, CFG 3, f32: the
    card's kernels against the CPU's plain versions, same weights, x_T and
    prompt codes."""
    import torch
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer, latents_to_codes
    cfg = prompt_config()
    lat_tol = 5e-4      # the model-level contract, f32 both sides
    runs = {dev: Synthesizer(config=Config(model=cfg), device=dev,
                             dtype=torch.float32, num_inference_steps=2,
                             sampler="dpm", guidance_scale=GUIDANCE)
            for dev in ("cpu", "cuda")}
    ids, mask = runs["cpu"].tokenizer.encode_batch(TEXTS[3:])
    g = torch.Generator().manual_seed(7)
    x_T = torch.randn((1, cfg.sample_size, 8), generator=g)
    codes = torch.randint(0, 1024, (1, 8, cfg.prompt_frames), generator=g)
    out = {}
    for dev, synth in runs.items():
        t0 = time.perf_counter()
        lat = synth.denoise_latents(
            x_T.to(dev), torch.as_tensor(ids, device=dev),
            torch.as_tensor(mask, device=dev),
            synth.prompt_latents(prompt_codes=codes))
        out[dev] = lat.cpu()
        out[dev + "_s"] = time.perf_counter() - t0
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    code_diff = (latents_to_codes(out["cuda"])
                 - latents_to_codes(out["cpu"])).abs()
    ok = (err <= lat_tol and code_diff.max().item() <= 1
          and bool(torch.isfinite(out["cuda"]).all()))
    emit({"phase": "prompt_small", "what": "ModelConfig(prompt_conditioning"
          "=True) B=1 DPM-2 CFG 3 f32, cuda vs cpu",
          "latent_max_abs_err": err, "latent_tol": lat_tol,
          "code_flip_share": (code_diff > 0).float().mean().item(),
          "cuda_denoise_s": out["cuda_s"], "cpu_denoise_s": out["cpu_s"],
          "ok": ok, "card": smi})
    if not ok:
        raise AssertionError("card prompt synthesis disagrees with the CPU")
    del runs


def phase_encode_small(smi):
    """A 2 x 1.5 s f32 encode through the full-width codec (same seeded
    weights) on the card and on the CPU: latents and codes."""
    import torch
    from prompt_tts_tpu_torch.pipeline import CodecRunner
    runners = {d: CodecRunner(d) for d in ("cpu", DEVICE)}
    wav = torch.randn(2, 36000, generator=torch.Generator().manual_seed(9))
    lat, codes = {}, {}
    for d, r in runners.items():
        with torch.no_grad():
            lat[d] = r.codec.encoder(wav.to(d)[..., None]).cpu()
        codes[d] = r.encode(wav).cpu()
    scale = max(1.0, lat["cpu"].abs().max().item())
    err = (lat[DEVICE] - lat["cpu"]).abs().max().item()
    flips = (codes[DEVICE] != codes["cpu"]).float().mean().item()
    checks = {"latents": err <= ENC_TOL * scale,
              "codes_shape": tuple(codes[DEVICE].shape) == (2, 8, 113),
              "codes_range": bool(codes[DEVICE].min() >= 0
                                  and codes[DEVICE].max() <= 1023),
              "code_flips": flips <= RVQ_MAX_DIFFER}
    emit({"phase": "encode_small", "what": "EnCodec 24 kHz encode 2 x 1.5 s "
          "f32, cuda vs cpu", "latent_max_abs_err": err,
          "latent_tol": ENC_TOL * scale, "code_flip_share": flips,
          "checks": checks, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"encode_small checks failed: {checks}")


def tone(rng, n_s, sr=ENCODE_SR):
    """``n_s`` samples of a voice-like signal at ``sr``: a harmonic tone
    with vibrato, plus noise (f32)."""
    import numpy as np
    t = np.arange(n_s) / sr
    f0 = rng.uniform(90.0, 250.0) * (1 + 0.02 * np.sin(
        2 * np.pi * rng.uniform(4.0, 7.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    audio = sum(np.sin(k * phase) / k for k in range(1, 9))
    audio = 0.5 * audio / np.abs(audio).max()
    return (audio + 0.01 * rng.standard_normal(n_s)).astype(np.float32)


def write_wav_tar(path, n, seed=0):
    """A corpus tar as generate_codes takes it: ``wavs/<id>.wav`` (PCM16 at
    22.05 kHz, 2-12 s: a harmonic tone with vibrato, plus noise) and
    ``wavs/<id>.txt``.  Returns each clip's length in samples."""
    import numpy as np
    from prompt_tts_tpu_torch.utils.wav import write_wav
    rng = np.random.default_rng(seed)

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    lengths = {}
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            n_s = int(rng.uniform(2.0, 12.0) * ENCODE_SR)
            buf = io.BytesIO()
            write_wav(buf, tone(rng, n_s), ENCODE_SR)
            add(tf, f"wavs/utt{i:03d}.wav", buf.getvalue())
            add(tf, f"wavs/utt{i:03d}.txt", TEXTS[i % len(TEXTS)].encode())
            lengths[f"utt{i:03d}"] = n_s
    return lengths


def phase_rvq(smi, emb, cb):
    """The RVQ kernel against its plain version (cuBLAS, TF32 off) at
    ``[32, 900, 128] x [8, 1024, 128]``: on the encode slice's latents
    ``emb`` and on seeded normal vectors of the same shape, with the
    slice's codebooks ``cb``; then timed on the latents."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.rvq import (
        index_contract, rvq_encode, rvq_encode_plain,
    )
    n_q = cb.shape[0]
    B, T, D = emb.shape
    g = torch.Generator(DEVICE).manual_seed(10)
    normal = torch.randn(emb.shape, generator=g, device=DEVICE)
    res = {}
    for name, x in (("latents", emb), ("normal", normal)):
        got = rvq_encode(x, cb)
        ref = rvq_encode_plain(x, cb)
        torch.cuda.synchronize()
        r = index_contract(x, cb, got, ref)
        r["ok"] = (r["violations"] == 0
                   and r["differ"] <= RVQ_MAX_DIFFER * r["vectors"]
                   and tuple(got.shape) == (B, n_q, T))
        emit({"phase": "kernel", "kernel": "rvq_encode", "case": name,
              "shape": f"[{B}, {T}, {D}] x [{n_q}, {cb.shape[1]}, {D}]",
              **r, "max_differ_share": RVQ_MAX_DIFFER, "card": smi})
        if not r["ok"]:
            raise AssertionError(f"rvq_encode {name}: {r}")
        res[name] = r

    def cdist_loop(x):
        """The library-call comparator: the 8-layer cascade as cdist +
        argmin, gather and subtract (no one PyTorch call computes it)."""
        r = x.reshape(-1, D)
        for e in cb:
            idx = torch.cdist(r, e).argmin(-1)
            r = r - e[idx]

    ms = cuda_ms(lambda: rvq_encode(emb, cb), 20)
    plain_ms = cuda_ms(lambda: rvq_encode_plain(emb, cb), 5)
    lib_ms = cuda_ms(lambda: cdist_loop(emb), 5)
    K = cb.shape[1]
    flop = 2 * B * T * n_q * K * D
    nbytes = 4 * (B * T * D + n_q * K * D + B * n_q * T)
    b = bound(flop, nbytes, "float32")
    emit({"phase": "kernel_time", "kernel": "rvq_encode", "case": "latents",
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_note": "8 x (torch.cdist + argmin, gather, subtract)",
          **b, "card": smi})
    return {"max_abs_err": max(r["max_score_gap"] for r in res.values()),
            "max_abs_err_note": "largest f64 score gap between the kernel's "
                                "and the plain version's chosen codes",
            "differ": {k: r["differ"] for k, r in res.items()},
            "vectors": B * T, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "unit": f"one call, [{B}, {T}, {D}] x [{n_q}, {K}, {D}], f32"}


def phase_encode_slice(smi, tmp):
    """The encode CLI at batch 32 x 12 s; returns the launches it made, the
    RVQ kernel's summary and the code tar it wrote."""
    import math
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import generate_codes as cli
    from prompt_tts_tpu_torch.pipeline import CodecRunner, full_f32
    tar = os.path.join(tmp, "wavs.tar")
    lengths = write_wav_tar(tar, ENCODE_UTTERANCES)
    argv = ["--input_file", tar, "--batch_size", str(ENCODE_BATCH),
            "--device", DEVICE]
    zero_counts()
    t0 = time.perf_counter()
    out_file, n_items, seconds = cli.main(argv)
    cli_s = time.perf_counter() - t0
    launches = counts()
    n_batches = math.ceil(ENCODE_UTTERANCES / ENCODE_BATCH)
    want = want_counts(lstm=2 * n_batches,
                       rvq_encode=n_batches)
    max_samples = int(AUDIO_S * SAMPLE_RATE)
    with tarfile.open(out_file) as tf:
        got = {m.name: tf.extractfile(m).read() for m in tf.getmembers()}
    shapes_ok = range_ok = lens_ok = texts_ok = True
    for i, (stem, n_s) in enumerate(lengths.items()):
        codes = np.load(io.BytesIO(got.get(f"{stem}.npy", b"")))
        shapes_ok &= codes.shape == (8, 900) and codes.dtype == np.int64
        range_ok &= bool(codes.min() >= 0 and codes.max() <= 1023)
        # the resampler's output length, cut at the 12 s window
        n24 = min(math.ceil(n_s * SAMPLE_RATE / ENCODE_SR), max_samples)
        lens_ok &= got.get(f"{stem}.len.txt") == str(
            float(math.ceil(n24 / 320))).encode()
        texts_ok &= got.get(f"{stem}.txt") == TEXTS[i % len(TEXTS)].encode()
    checks = {"items": n_items == ENCODE_UTTERANCES == len(got) // 3,
              "codes_shape": shapes_ok, "codes_range": range_ok,
              "len_txt": lens_ok, "transcripts": texts_ok,
              "launches": launches == want}
    emit({"phase": "encode_slice", "what": f"cli.generate_codes "
          f"--batch_size {ENCODE_BATCH}, {ENCODE_UTTERANCES} wavs of 2-12 s "
          f"at {ENCODE_SR} Hz -> [8, 900] codes", "checks": checks,
          "launches": launches, "want_launches": want, "cli_wall_s": cli_s,
          **seconds, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"encode slice checks failed: {checks}")

    # the RVQ kernel on the slice's own latents: the first batch's wavs
    with tarfile.open(tar) as tf:
        wavs, _, _ = next(cli.iter_batches(tf, tf.getmembers(), ENCODE_BATCH,
                                           int(AUDIO_S)))
    runner = CodecRunner(DEVICE)
    wav = torch.from_numpy(wavs).to(DEVICE)
    with torch.no_grad(), full_f32():
        emb = runner.codec.encoder(wav[..., None]).contiguous()
        rvq = phase_rvq(smi, emb, runner.codec.codebooks[:8].detach())
    del emb

    # steady state: a warm encode of one batch, by CUDA events
    runner.encode(wav)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: runner.encode(wav), 3)
    emit({"phase": "encode_warm", "what": f"CodecRunner.encode "
          f"[{ENCODE_BATCH}, {max_samples}] f32 (TF32 off)", "device_ms": ms,
          "audio_s_per_device_s": ENCODE_BATCH * AUDIO_S / (ms / 1e3),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "host_read_resample_s": seconds["host_s"],
          "cli_encode_s": seconds["encode_s"], "card": smi})
    emit({"phase": "encode_profile", "what": f"one CodecRunner.encode "
          f"[{ENCODE_BATCH}, {max_samples}]",
          **profile_step(lambda: runner.encode(wav)), "card": smi})
    del runner, wav
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rvq, out_file


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


def _logged(log_dir, tag):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def _kernel_class(name):
    for cls, pat in (("attention_fwd", r"attn_fwd"),
                     ("attention_bwd", r"attn_bwd"),
                     ("lstm", r"lstm_step"),
                     ("lstm_t", r"lstm_t_kernel"),
                     ("resnet", r"gn_stats_kernel|conv_kernel<"),
                     ("rvq_encode", r"rvq_(prep|encode)"),
                     ("conv", r"fprop|dgrad|wgrad|conv|cudnn|nchwToNhwc|"
                              r"nhwcToNchw"),
                     ("gemm", r"gemm|nvjet|xmma|cutlass|sm90_"),
                     ("norm", r"norm|Norm|welford"),
                     ("optimizer", r"adam|Adam|multi_tensor")):
        if re.search(pat, name):
            return cls
    return "other"


def profile_step(step):
    """Device time by kernel class of one call of ``step``
    (torch.profiler)."""
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


def phase_train_slice(smi, tar):
    """The train CLI at full width on the code tar ``tar``; returns the
    launches of its runs and the batch it used."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        trainer = None
        for batch in TRAIN_BATCHES:
            argv = ["--data_file", tar, "--log_dir", logs, "--ckpt_dir", ckpt,
                    "--bf16", "--batch_size", str(batch), "--log_every", "1",
                    "--device", "cuda"]
            zero_counts()
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

        zero_counts()
        t0 = time.perf_counter()
        trainer = cli.main(argv + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        run2 = counts()
        losses = _logged(logs, "Loss/train")
        norms = _logged(logs, "grad_norm")
        saved = trainer.ckpt.all_steps()
        per_epoch = ENCODE_UTTERANCES // batch
        # training needs gradients: the resnet blocks take the module's
        # autograd path, never the inference kernel
        want1 = want_counts(attention_fwd=ATTN_CALLS * 2 * per_epoch,
                            attention_bwd=LAUNCHES_PER_CALL * ATTN_CALLS * 2
                            * per_epoch)
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
              f"--bf16 --batch_size {batch}, the encode slice's "
              f"{ENCODE_UTTERANCES} utterances x 900 frames: 2 epochs, then "
              f"--resume to 3",
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
        lstm, lstm_t = phase_lstm(smi)
        resnet = phase_resnet(smi)
    synth = phase_slice(smi)
    with tempfile.TemporaryDirectory() as tmp:
        prompt, other, prompt_rvq_res = phase_prompt_slice(smi, tmp)
    with full_f32():
        phase_small(smi)
        phase_prompt_small(smi)
        phase_encode_small(smi)
        phase_train_small(smi)
    with tempfile.TemporaryDirectory() as tmp:
        encode, rvq, codes_tar = phase_encode_slice(smi, tmp)
        train, batch = phase_train_slice(smi, codes_tar)
    rvq["differ"]["prompt_latents"] = prompt_rvq_res["differ"]
    rvq["max_abs_err"] = max(rvq["max_abs_err"],
                             prompt_rvq_res["max_score_gap"])
    with full_f32():
        bwd, fwd["train_shapes"] = phase_attention_bwd(smi, batch)
    paths = {k: {"synthesize": synth[k], "prompt_synthesize": prompt[k],
                 "codec_other_lstm_schedule": other[k], "train": train[k],
                 "encode": encode[k]} for k in KERNELS}
    launches = {k: sum(p.values()) for k, p in paths.items()}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the paths never ran: {launches}")
    rows = (
        ("attention_fwd", "attention", "attention.py:103", fwd),
        ("attention_bwd", "attention_bwd", "attention_bwd.py:151", bwd),
        ("lstm_recurrence", "lstm", "lstm.py:81", lstm),
        ("lstm_recurrence_t", "lstm_t", "lstm.py:170", lstm_t),
        ("rvq_encode", "rvq", "rvq.py:75", rvq),
        ("fused_resnet_block", "resnet", "resnet.py:136", resnet))
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"prompt_tts_tpu_torch/csrc/{src}.cu",
         "replaces": f"prompt_tts_tpu/ops/pallas/{tpu}",
         "launches": launches[key], "launches_by_path": paths[key], **row}
        for (name, src, tpu, row), key in zip(rows, KERNELS)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
