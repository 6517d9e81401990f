"""Drive the PyTorch port once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:
  1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the build of all six CUDA kernels from ``prompt_tts_tpu_torch/csrc``
     (one ``nvcc`` per source, all at once).
  2. kernel: each kernel against its plain PyTorch version on the card at
     the shapes its path gives it (max abs error against a stated
     tolerance; kernel, plain and library times by CUDA events; the least
     time the card could take, from the bytes and operations of the call,
     and for attention the time of its exps on the special-function units).
     Both attention kernels run in f32 (3 x TF32) and bf16 on the tensor
     cores, bf16 held to the plain versions that round where the kernels
     round and to the f32 plain versions in relative Frobenius norm; also
     at every head dim on ragged shapes, and on the prompt path's inputs
     (CFG's null text with every key masked, cross-attention over 550 + 32
     keys, the prompt encoder's calls), and in bf16 at the serve paths'
     batches of 1 and 2; both LSTM schedules at the decoder's B=4, the
     encoder's B=32, the prompt encode's T=225 and the serve paths' B=1
     (prefixes of 300 and 600, 900, the speaker registry's 225 and 15),
     run twice for the same bits, ms a layer and us a step; the
     fused resnet block at every block shape of one UNet forward (bf16 at
     B=8, 4, 2 and 1, held to the module arithmetic and to
     fused_resnet_block_plain,
     run twice for the same bits, timed per launch by the profiler, and
     the wrapper's host cost per call; f32, 3 x TF32, at B=1 and at
     ``cli.evaluate``'s B=32, held to both the same way, and at Cin = 1536
     to the block in f64, which pins the kernel's folded accumulator); the
     RVQ encode inside
     the encode slice (its inputs
     are that slice's latents); the attention backward last: checked at
     B=4, then timed, with the forward, at the batch the train slice used,
     where two runs must give the same bits.
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
  4b'. serve: ``cli.serve`` at ``ModelConfig()`` in this process
     (``build_server``, then ``serve_forever`` on a thread), DDIM-50,
     bf16, ``--max_batch 4``, over HTTP on localhost: the startup, one
     request (PCM bit-equal to the in-process batch it is padded to, and
     its exact launches), a wave of 8 concurrent requests, twice (wall,
     x real time, peak memory, then a device-only profile), in turns
     with the same texts as two serial in-process batches (serial, wave,
     wave, serial), a streamed request (time to the first chunk;
     PCM within one step of the full decode, and where it leaves it:
     each decoder layer on a prefix of its input against the full
     input's output), long-form over two windows
     whole and streamed (bit-equal to ``synthesize_long`` /
     ``synthesize_long_stream``), a streamed and a batched request at
     once (each bit-equal to its result alone), ``/stats``, the drain
     with a request in flight; then ``cli.synthesize --long`` (the file of
     ``synthesize_long``), a path of its own.
  4b''. prompt_serve: the same server on the prompt family (DPM-25, CFG
     3) with ``--speakers``: two 3 s voices and a 0.2 s one at 22.05 kHz
     (repeat-padded), the RVQ launches of the registration, the RVQ
     kernel at the registry's [1, 225] and [1, 15] against its plain
     version, one request a speaker bit-equal to the in-process call, an
     unknown speaker's 400.
  4c. prompt_small: the full-width prompt model, f32, batch 1, DPM-2, CFG
     3, on the card (kernels) against the CPU (plain versions), same
     weights, x_T and prompt codes.
  5. encode_small: a 2 x 1.5 s f32 encode through the full-width codec on
     the card and on the CPU: latents and codes compared.
  6. train_small: one f32 train step of the full-width model at batch 1,
     dropout off, on the card (kernels) and on the CPU (plain versions),
     same weights, batch, noise and timesteps: loss, gradient norm and
     every gradient compared.
  6b. prompt_train_small: the same for the full-width prompt model at
     batch 2, with the condition drop nulling row 0's text and prompt.
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
  8b. prompt_train_slice: ``cli.train`` on a prompt-conditioned config
     this script writes (the condition drop at 0.1), ``--bf16 --ema_decay
     0.999``, the same batch and code tar (225-frame prompt crops), one
     epoch with a checkpoint; checks the losses, the f32 parameters, the
     checkpoint's EMA, the launches and the backward kernel's calls at the
     prompt encoder's shapes (57 x 57 and the 32 x 57 pool, D=96) and over
     the 582 cross-attention keys; then times warm steps and profiles one.
  9. ckpt_synth: ``cli.synthesize --ckpt_dir --codec_params`` (a codec
     from ``cli.convert_codec --random``) from the prompt train slice's
     EMA (a 3 s 22.05 kHz voice prompt, DPM-25, CFG 3) and from the
     single-speaker train slice's parameters (DDIM-50), 4 requests each:
     the launches of every inference kernel, and the codes and wavs of an
     in-process ``Synthesizer`` on the same restored state, bit for bit.
  10. the attention backward at the prompt family's training shapes, f32
     and bf16 against its plain version, twice for the same bits, then
     timed beside SDPA's backward with its bound.
  11. remat_train: the flagship's bf16 train step at the train slice's
     batch with the text encoder's dropout on, without and with remat from
     the same weights and generator states: the loss and every gradient
     bit for bit, kernel #1 launched twice as often under remat; then
     whole steps in turns: wall and peak memory.
  12. train_cli_extras: ``cli.train --streaming --remat --profile_steps 2``
     (bf16, batch 16, one epoch) against the in-RAM plain run: the
     streamed batches and the losses bit-equal, the native reader loaded,
     the Chrome trace naming both attention kernels.
  13. evaluate: ``cli.evaluate`` (f32, 2 batches, the 5-point grid) on the
     flagship's checkpoint twice and the prompt family's EMA twice and raw
     once: the same JSON twice, the EMA apart; one batch's wall.
  14. export: ``cli.export_checkpoint`` of the flagship's checkpoint, read
     back bit for bit, then ``cli.synthesize --ref_ckpt`` against an
     in-process ``Synthesizer`` on the checkpoint's state, bit for bit.
  14b. aot: the deployment export (``aot.export_synthesis``): the
     flagship bf16 at batch 8, DDIM-50, int16 PCM, and the prompt family
     at batch 4, DPM-25 CFG 3, each exported (condition, step and finish
     programs), saved, loaded in a fresh ``aot.SynthesisProgram`` and held
     against the live ``Synthesizer`` on the same x_T: PCM and codes bit
     for bit, launches of every kernel equal; a corrupted magic and an
     unknown version refused; export, save and load seconds, artifact MB,
     both calls' walls, and the host microseconds a call of kernels #1
     and #6 through their ``torch.library`` op against the launcher.
  15. ddpm: ``ddpm_sample`` with the flagship's widths at one layer a
     block (``DDPM_LAYERS_PER_BLOCK``), 4 requests, bf16,
     1,000 steps and the decode (ms a step, x real time, the idle share
     over a 100-step schedule); a tiny config in f32 on the card against
     the CPU with injected noise over a 250-step schedule
     (``DDPM_TINY_STEPS``).
  15b. codec_bf16: the same seeded codes [4, 8, 900] through the f32
     codec and the bf16 one over the same parameters
     (``Synthesizer(codec_dtype=torch.bfloat16)``'s decode): warm ms of
     each by CUDA events, the largest difference and the mel distance,
     kernel #4 launched in both.
  15c. unet_variants: ``ModelConfig()`` widths with the fourier time
     embedding, the avg-pool downsample and the conv-transpose upsample at
     896 frames: ``Synthesizer`` DDIM-10, 4 requests, bf16 (launches,
     wavs); one UNet forward on the kernels against the plain versions;
     warm DDIM-50 walls of the variant and the flagship in turns; a forward
     with ``class_labels`` in each class-embedding mode, held the same way;
     3 bf16 ``Trainer`` steps at B=32 with weight decay (kernels #1 and #2,
     the Fourier buffer bit-unchanged).
  16. profile: ``cli.profile --stages cond,denoise,decode,train,synth
     --time`` at full width (its table printed), and a tiny config's FLOPs
     on the card against the CPU.
  17. ddp_nccl: ``parallel.init_distributed`` over NCCL at world size 1
     in this process; the flagship's widths at one layer a block
     (``DDP_LAYERS_PER_BLOCK``), bf16, batch 32, 3 steps through
     ``Trainer`` under DDP against the plain trainer run twice (DDP's loss
     gap at most twice the card's own noise floor + 1e-6, kernels #1 and
     #2 launched), and the prompt family under DDP (batch 4, 2 steps:
     DDP raises on a parameter the loss left unreached).
  18. ddp_two_ranks: 2 processes sharing the card over gloo, the same
     config, global batch 32: one f32 step's all-reduced gradient and loss against one
     process on the same rows (1e-4 and 1e-5 relative), 3 bf16 steps
     replicated and with ``per_process_data`` (within 2e-2 of one
     process), rank 0's checkpoint read back through
     ``read_model_state``; gloo's step time on one card, not a scaling
     figure.
  19. (the torchrun launch over NCCL runs in 20 (b), over gloo at two
     ranks in 21 (b).)
  20. tp: tensor parallelism on the one card.  (a) 2 processes sharing it
     over gloo at ``--tp 2`` (``tp_rank_main``), ``ModelConfig()`` at full
     width and ``TP_LAYERS_PER_BLOCK`` layers a block, f32 (TF32 off) and
     bf16: a model forward, 3 train steps at B=4 and a DDIM-10 synthesis
     of 2 requests, each held against this process's unsharded program on
     the same weights (``TP_*`` tolerances), kernels #1 and #2 launched at
     the local head counts (4 and 6) on every rank, #6 not at all; (b)
     ``cli.train --multihost --tp 1 --backend nccl`` under ``torchrun
     --standalone --nproc_per_node 1`` (started with the phase, beside
     (a)), then ``cli.synthesize --multihost --tp 1`` over NCCL at world
     size 1 in this process (the checkpoint, codes bit-equal to an
     in-process ``Synthesizer``); (c) ``cli.serve --multihost --tp 2
     --backend gloo`` (f32, DDIM-5, batch 1): one request and a wave of 4
     against the one-process server, the drain releasing the follower.
     Each process it starts runs ``CHILD_THREADS`` intra-op threads.
     gloo's times on one card, not a multi-card figure.
  21. sp: sequence parallelism on the one card.  (a) 2 processes sharing
     it over gloo at ``--sp 2`` (``sp_rank_main``), ``ModelConfig()`` at
     full width (the tp phase's depth), f32 (TF32 off) and bf16: the tp
     phase's forward, 3 train steps at B=4 and DDIM-10 of 2 requests, held
     against the one-process results that phase computed (``TP_*``
     tolerances), kernels #1 and #2 launched on every rank, the ring at
     900 and 450 frames only; the ring alone at those levels' shapes (8
     heads, D 32 and 64, B=4) against ``ring_attention_plain`` and
     one-process attention; (b) ``cli.train`` (under ``torchrun
     --standalone --nproc_per_node 2``) and ``cli.synthesize --multihost
     --sp 2 --backend gloo`` on ``TINY`` against the same CLIs in this
     process, run beside (a); (c) ``cli.serve --sp 2`` against the tp
     phase's one-process server.  It runs after the tp phase, on a card
     nothing else uses; its processes start with it and run side by side.
     gloo's times on one card, not a multi-card figure.
Then the phases' wall seconds (``phase_walls_s``), one
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.  Any failure raises (non-zero exit); without CUDA it exits non-zero
before any result.

    python3 chip_smoke.py --lstm-times --rvq-times --resnet-times \
        --resnet-tiles --synth-times --remat-times --f32-times --synth-bits

runs timings alone, any of them, after the build: both LSTM kernels at the
paths' three shapes beside cuDNN, the RVQ encode at [32, 900], [4, 225]
and [1, 225] beside the cdist sequence with both of its bounds (f32 on the
CUDA cores, 3 x TF32 on the tensor cores), the resnet kernel at every
block shape (per launch, the library sequence, the wrapper's host cost),
its tile shapes at B=8 and B=1 (and f32's at B=32, 8, 4 and 1), the
two synthesis slices' warm walls
with a profile, and the flagship train step plain, under the port's remat
and under two renderings of JAX's remat policy, the f32 paths at
B=32 (``f32_times``), and the flagship's live DDIM-50 batch-8 PCM and
codes as sha256 digests with their walls (``--synth-bits``).
``--lstm-times``, ``--resnet-times``, ``--synth-times`` and
``--synth-bits`` use only what earlier versions of
the package have too, so that two checkouts can be timed in one call
(``--rvq-times`` needs ``ops/cuda/opcount.py``, which came with the
trainer's remat).
"""

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import struct
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
# the serve phase's wave of concurrent requests: two batches of 4
SERVE_WAVE = 8
# streamed PCM against the full-window decode of the same codes: at most
# one pcm16 step (a prefix decode may take other cuDNN algorithms)
STREAM_PCM_STEPS = 1

# Tolerances, kernel vs plain on the same inputs.
# f32 attention: same math, f32 sums in another order over <= 900 keys.
ATTN_TOL_F32 = 2e-5
# bf16 attention (the tensor-core kernel) vs flash_attention_plain, which
# rounds where it rounds (f32 scores and statistics, the unnormalised p to
# bf16 for PV): |err| <= ATTN_ATOL_BF16 + ATTN_RTOL_BF16 |ref|.  Both round
# the output to bf16, so they may sit one ulp apart (2^-7 relative); the
# kernel rounds p at its running max and rescales later, and sums in
# another order, which moves O(1) outputs by up to ~1e-3.
ATTN_ATOL_BF16, ATTN_RTOL_BF16 = 2e-3, 2.0 ** -7
# ... and every bf16 result against the f32 plain version of the same bf16
# inputs, the overall accuracy: relative Frobenius error (p rounded to
# bf16, 2^-9 relative and random over keys, and the output's rounding).
FRO_RTOL_BF16 = 1e-2
# Rows whose keys are all masked (CFG's null text), the kernel vs the plain
# version with f32 scores (f32: attention_plain; bf16:
# flash_attention_plain): the scores sit at -1e4, where an f32 ulp is
# ~1e-3, so the two sides' probabilities differ by ~1e-3 relative; plus the
# bf16 output's rounding (|o| < 1: half an ulp <= 2e-3).
ATTN_TOL_ALL_MASKED = 5e-3
# Attention backward, per output (dq, dk, dv, dbias): f32 against the f32
# plain backward, |err| <= BWD_TOL * (1 + max|ref|) -- f32 sums in another
# order.  bf16 against attention_bwd_plain on the bf16 tensors (it rounds p
# and ds*scale to bf16 where the kernel does): dq, dk, dv are rounded to
# bf16 on both sides (one ulp apart, ATTN_RTOL_BF16), and a p or ds whose
# two f32 values straddle a bf16 rounding boundary moves a term by a bf16
# ulp (BWD_ATOL_BF16 of max|ref|); dbias is f32 on both sides.  Rows whose
# keys are all masked: BWD_TOL_ALL_MASKED in place of BWD_TOL.
BWD_TOL = 2e-5
BWD_ATOL_BF16 = 2.0 ** -8
BWD_TOL_ALL_MASKED = 5e-3
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
# The f32 kernel at the deepest K (Cin = 1536) and B = 32 against the block
# in f64, max |err| / max(1, max |ref|): the tensor cores truncate each k8
# step's sum into the accumulator, and the kernel folds a partial
# accumulator into an f32 total every kFold stages (csrc/resnet.cu).  The
# limit sits between the folded kernel's reading (6.6e-7 and 7.6e-7 at T =
# 113 and 225 on an H100) and that of one accumulator over the K loop
# (1.6e-5 and 2.0e-5), which RESNET_TOL_F32 passes.
RESNET_TOL_F32_DEEP = 4e-6
RESNET_DEEP_CIN = 1536
# The bf16 kernel vs fused_resnet_block_plain, which rounds a, h, a2 and the
# output where the kernel does: GroupNorm statistics in the last f32 bits
# and f32 sums in another order can move a value across a bf16 rounding
# boundary, |err| <= FUSED_ATOL_BF16 + FUSED_RTOL_BF16 |ref|: one ulp of the
# output, plus 2^-8 for such a flip in a, h or a2 carried through a product.
FUSED_RTOL_BF16, FUSED_ATOL_BF16 = 2.0 ** -7, 2.0 ** -8
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
# GroupNorm) is rounding noise on both sides, held below 1e-6 of the
# gradient norm of its sub-model (text encoder, prompt encoder, UNet).
TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL, ZERO_GRAD = 1e-4, 1e-3, 1e-6

# Least time for a call: bytes moved (each input read once, each output
# written once) over the memory rate, and operations over the peak rate of
# the inputs' type (NVIDIA's H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12}
# A third floor for attention: its exps on the special-function unit, 16 a
# clock per SM (Hopper), at the card's maximum SM clock (read by
# phase_card from nvidia-smi, with the SM count from torch).
EXPS_PER_CLOCK_PER_SM = 16
CARD = {}

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
PROMPT_HEADS, PROMPT_HEAD_DIM = 8, 96
# attention calls of one prompt-family forward (and train step)
PROMPT_ATTN_CALLS = ATTN_CALLS + PROMPT_BLOCKS + 1
# the prompt family's train slice trains for guidance: the condition drop
# (text and prompt nulled together) at this rate, and an EMA at this decay
PROMPT_COND_DROP, PROMPT_EMA = 0.1, 0.999
# the serve phase's streamed request decodes the prefixes of ceil(900/3)
# = 300 frames; the prompt server registers a 3 s voice (225 frames) and a
# 0.2 s one (15 frames) at batch 1
STREAM_PREFIXES = (300, 600)
SHORT_VOICE_S = 0.2
PROMPT_FRAMES = int(PROMPT_S * 75)
SHORT_VOICE_FRAMES = -(-int(SHORT_VOICE_S * SAMPLE_RATE) // 320)
# (T, B) of the LSTM calls on the paths: the decoder's (the synthesis
# slices' batch), the encoder's (the encode slice's 32), the prompt
# encode's T=225; then the serve paths' batch-1 calls: the decoder's
# prefixes and whole window, the speaker registry's encoder
LSTM_SHAPES = ((900, N_REQUESTS), (900, ENCODE_BATCH),
               (PROMPT_FRAMES, N_REQUESTS),
               *((T, 1) for T in STREAM_PREFIXES), (900, 1),
               (PROMPT_FRAMES, 1), (SHORT_VOICE_FRAMES, 1))
# [B, T] of the RVQ encode calls on the paths: the encode slice's batch,
# the prompt encode's (4 requests x 225 frames) and one prompt
RVQ_TIME_SHAPES = ((ENCODE_BATCH, 900), (N_REQUESTS, int(PROMPT_S * 75)),
                   (1, int(PROMPT_S * 75)))
# the kernels' launch counters, by name in the kernels line
KERNELS = ("attention_fwd", "attention_bwd", "lstm", "lstm_t", "rvq_encode",
           "resnet")

TEXTS = ["Hello from the port.", "Printing, in the only sense with which "
         "we are at present concerned.", "One two three four.",
         "The quick brown fox jumps over the lazy dog."]
# the serve phase's long-form text: two windows of <= 550 tokens
LONG_TEXT = " ".join(TEXTS * 3)


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


def tc_bound(flop, nbytes, dtype):
    """The least time of a tensor-core kernel's call (attention, the resnet
    block) in ``dtype``: bf16 on the tensor cores; f32 as the kernels run
    it, 3 x TF32 (three TF32 products at the card's dense TF32 peak),
    beside the f32 CUDA cores' floor."""
    if dtype == "bfloat16":
        return bound(flop, nbytes, dtype)
    return {**bound(3 * flop, nbytes, "tfloat32"), "flop": flop,
            "bound_f32_cuda_cores_ms": bound(flop, nbytes,
                                             "float32")["bound_ms"]}


def exp_floor(exps):
    """The least time (ms) the card's special-function units take for
    ``exps`` exponentials."""
    rate = EXPS_PER_CLOCK_PER_SM * CARD["sms"] * CARD["clock_max_sm_mhz"] * 1e6
    return exps / rate * 1e3


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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    CARD["clock_max_sm_mhz"] = float(clock)
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    _build.load_all(("attention", "attention_bwd", "lstm", "lstm_t",
                     "resnet", "rvq"))
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, **CARD,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds)})
    return smi


def _fwd_tol(dtype, all_masked=False):
    import torch
    if dtype == torch.float32:
        return {"atol": ATTN_TOL_ALL_MASKED if all_masked else ATTN_TOL_F32}
    return {"atol": ATTN_TOL_ALL_MASKED if all_masked else ATTN_ATOL_BF16,
            "rtol": ATTN_RTOL_BF16, "fro_rtol": FRO_RTOL_BF16}


def _fwd_check(out, q, k, v, bias, all_masked=False):
    """The forward kernel's ``out`` against its plain version: f32 against
    attention_plain; bf16 against flash_attention_plain (which rounds where
    the kernel rounds) and against the f32 plain version in relative
    Frobenius norm.  Returns (max abs error, Frobenius error or None, ok)."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import (
        attention_plain, flash_attention_plain,
    )
    tol = _fwd_tol(q.dtype, all_masked)
    f32 = attention_plain(q.float(), k.float(), v.float(), bias)
    ok = bool(torch.isfinite(out).all())
    fro = None
    if q.dtype == torch.float32:
        err = (out - f32).abs()
        limit = tol["atol"]
    else:
        ref = flash_attention_plain(q, k, v, bias).float()
        err = (out.float() - ref).abs()
        limit = tol["atol"] + tol["rtol"] * ref.abs()
        fro = ((out.float() - f32).norm() / f32.norm()).item()
        ok = ok and fro <= tol["fro_rtol"]
    ok = ok and bool((err <= limit).all())
    return err.max().item(), fro, ok


def _bwd_errors(got, args, all_masked=False):
    """The backward kernel's (dq, dk, dv, dbias) against the plain backward
    of ``args`` (q, k, v, o, do, bias): f32 against f32; bf16 against the
    plain version on the bf16 tensors, and against the f32 plain version in
    relative Frobenius norm (with BWD_TOL's floor per element, for outputs
    that are rounding noise).  Returns the max abs errors, the Frobenius
    errors and whether all are within tolerance."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_bwd_plain
    q, k, v, o, do, bias = args
    f32 = attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)), bias)
    bf16 = q.dtype == torch.bfloat16
    ref = attention_bwd_plain(q, k, v, o, do, bias) if bf16 else f32
    tol = BWD_TOL_ALL_MASKED if all_masked else BWD_TOL
    errs, fros, ok = {}, {}, True
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, ref, f32):
        if a is None:
            continue
        b, c = b.float(), c.float()
        top = b.abs().max()
        diff = (a.float() - b).abs()
        limit = tol * (1.0 + top)
        if bf16 and name != "dbias":
            limit = limit + BWD_ATOL_BF16 * top + ATTN_RTOL_BF16 * b.abs()
        errs[name] = diff.max().item()
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            (diff <= limit).all())
        if bf16:
            fe = (a.float() - c).norm()
            fros[name] = (fe / c.norm()).item()
            ok = ok and bool(fe <= FRO_RTOL_BF16 * c.norm()
                             + tol * (1.0 + top) * c.numel() ** 0.5)
    return errs, fros, ok


def _bwd_tol(dtype, all_masked=False):
    import torch
    tol = {"atol": BWD_TOL_ALL_MASKED if all_masked else BWD_TOL}
    if dtype == torch.bfloat16:
        tol.update(atol_of_max=BWD_ATOL_BF16, rtol=ATTN_RTOL_BF16,
                   fro_rtol=FRO_RTOL_BF16)
    return tol


def _hold_call(q, k, v, bias, o, lse=None, do=None, grads=None):
    """One attention call's kernel outputs against the plain versions on
    the same inputs: ``o`` by ``_fwd_check``, ``lse`` against the f64
    log-sum-exp (ATTN_TOL_F32), the backward's ``grads`` for ``do`` by
    ``_bwd_errors``.  The batch rows whose keys are all masked (the masked
    path's padded text keeps Tk >> i keys: none from i = 10 at Tk = 550)
    are held apart at ATTN_TOL_ALL_MASKED and BWD_TOL_ALL_MASKED.  Returns
    the errors by row set and whether every one holds."""
    import torch
    B, D = q.shape[0], q.shape[-1]
    dead = (torch.zeros(B, dtype=torch.bool, device=q.device)
            if bias is None else (bias.reshape(B, -1) < 0).all(1))
    res, ok = {}, True
    for name, rows in (("rows_with_keys", ~dead), ("all_masked_rows", dead)):
        idx = torch.nonzero(rows).flatten()
        if not len(idx):
            continue
        am = name == "all_masked_rows"
        sq, sk, sv, sb, so, slse, sdo = (
            None if t is None else t.index_select(0, idx)
            for t in (q, k, v, bias, o, lse, do))
        err, fro, fok = _fwd_check(so, sq, sk, sv, sb, am)
        r = {"rows": len(idx), "fwd": err, "fwd_fro": fro}
        ok = ok and fok
        if slse is not None:
            s = torch.einsum("bqhd,bkhd->bhqk", sq.double(),
                             sk.double()) / D ** 0.5
            if sb is not None:
                s = s + sb.double()
            r["lse"] = (slse.double() - torch.logsumexp(s, -1)).abs().max(
            ).item()
            del s
            ok = ok and r["lse"] <= (ATTN_TOL_ALL_MASKED if am
                                     else ATTN_TOL_F32)
        if grads is not None:
            sg = [None if t is None else t.index_select(0, idx)
                  for t in grads]
            r["bwd"], r["bwd_fro"], bok = _bwd_errors(
                sg, (sq, sk, sv, so, sdo, sb), am)
            ok = ok and bok
        res[name] = r
    return res, ok


def phase_attention_fwd(smi):
    """The forward kernel against its plain version at B=4, f32 and bf16,
    at the paths' shapes (timed), at ragged shapes and every head dim, on
    the prompt path's inputs, and in bf16 at the serve paths' batches of 1
    and 2; returns the bf16 sums over one UNet
    forward's 32 calls."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import (
        attention_plain, flash_attention_plain,
    )
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    g = torch.Generator("cuda").manual_seed(0)
    B = N_REQUESTS
    err_all = 0.0
    unet = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
            "bytes": 0, "exps": 0}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            plain = (attention_plain if dtype == torch.float32
                     else flash_attention_plain)
            for label, Tq, Tk, H, D, masked, n in attn_cases():
                q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked, dtype)
                out = flash_attention(q, k, v, bias)
                err, fro, ok = _fwd_check(out, q, k, v, bias)
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: flash_attention(q, k, v, bias), 20)
                plain_ms = cuda_ms(lambda: plain(q, k, v, bias), 20)
                lib_ms = cuda_ms(lambda: sdpa(q, k, v, bias), 20)
                size = q.element_size()
                flop = opcount.attention_fwd(B, Tq, Tk, H, D)
                exps = B * H * Tq * Tk
                nbytes = size * 2 * B * H * D * (Tq + Tk) + (
                    0 if bias is None else 4 * B * Tk)
                dname = str(dtype).split(".")[-1]
                emit({"phase": "kernel", "kernel": "attention_fwd",
                      "case": label, "dtype": dname, "B": B,
                      "max_abs_err": err, "fro_err": fro,
                      "tol": _fwd_tol(dtype), "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      **bound(flop, nbytes, dname),
                      "exp_ms": exp_floor(exps), "ok": ok, "card": smi})
                if not ok:
                    raise AssertionError(f"attention {label} {dtype}: max abs "
                                         f"err {err}, Frobenius {fro}")
                err_all = max(err_all, err)
                if dtype == torch.bfloat16 and not masked:
                    # the synthesis slice's denoiser dtype, UNet calls only
                    for key, t in (("ms", ms), ("plain_ms", plain_ms),
                                   ("library_ms", lib_ms)):
                        unet[key] += n * t
                    unet["flop"] += n * flop
                    unet["bytes"] += n * nbytes
                    unet["exps"] += n * exps
    err_all = max(err_all, _attention_ragged(smi),
                  _attention_prompt_cases(smi), _attention_serve_cases(smi))
    # one UNet forward's 32 attention calls, bf16, B=4
    b = bound(unet.pop("flop"), unet.pop("bytes"), "bfloat16")
    exp_ms = exp_floor(unet.pop("exps"))
    return {"max_abs_err": err_all, **unet, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "exp_ms": exp_ms,
            "unit": "one UNet forward's 32 calls, bf16, B=4"}


def _attention_ragged(smi):
    """Both attention kernels at every head dim on ragged shapes (one key
    and one row; tails of 63/65, 130/7 and 113/550; masked keys), f32 and
    bf16, against their plain versions.  Checked, not timed.  Returns the
    largest error."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    g = torch.Generator("cuda").manual_seed(7)
    err_all = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for D in (32, 64, 96, 128):
            for Tq, Tk, masked in ((1, 1, False), (63, 65, True),
                                   (130, 7, True), (113, 550, False)):
                q, k, v, bias = attn_inputs(g, 2, Tq, Tk, 3, D, masked, dtype)
                with torch.no_grad():
                    out, lse = flash_attention(q, k, v, bias, return_lse=True)
                    ferr, fro, fok = _fwd_check(out, q, k, v, bias)
                do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
                got = attention_bwd(q, k, v, out, do, bias, lse,
                                    need_dbias=masked)
                errs, fros, bok = _bwd_errors(got, (q, k, v, out, do, bias))
                emit({"phase": "kernel", "kernel": "attention_fwd+bwd",
                      "case": f"ragged Tq={Tq} Tk={Tk} D={D}"
                              + (" masked" if masked else ""),
                      "dtype": dname, "B": 2,
                      "fwd": {"max_abs_err": ferr, "fro_err": fro,
                              "tol": _fwd_tol(dtype), "ok": fok},
                      "bwd": {"max_abs_err": errs, "fro_err": fros,
                              "tol": _bwd_tol(dtype), "ok": bok},
                      "ok": fok and bok, "card": smi})
                if not (fok and bok):
                    raise AssertionError(f"attention ragged Tq={Tq} Tk={Tk} "
                                         f"D={D} {dname}: {ferr} {errs}")
                err_all = max(err_all, ferr, *errs.values())
    return err_all


def _attention_prompt_cases(smi):
    """Both attention kernels on the prompt path's own inputs, f32 and bf16,
    against their plain versions: CFG's null text (every one of the 550
    keys masked), the UNet's cross-attention over 550 text + 32 prompt
    keys, and the prompt encoder's self-attention and pooling.  Checked, not
    timed.  The all-masked rows are held to ATTN_TOL_ALL_MASKED against
    plain versions with f32 scores: the bias shifts every score alike, so
    the kernel's f32 scores give the softmax of the unmasked scores, while
    attention_plain on bf16 adds the bias in bf16 (ulp 64 at 1e4), rounding
    every score to -1e4 (uniform rows).  Returns the largest error."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
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
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, Tq, Tk_, H, D, mask in cases:
            all_masked = mask == "all"
            q, k, v, _ = attn_inputs(g, B, Tq, Tk_, H, D, False, dtype)
            bias = (torch.full((B, 1, 1, Tk_), -1e4, device="cuda")
                    if all_masked else None)
            with torch.no_grad():
                out, lse = flash_attention(q, k, v, bias, return_lse=True)
                err, fro, ok = _fwd_check(out, q, k, v, bias, all_masked)
            emit({"phase": "kernel", "kernel": "attention_fwd",
                  "case": "prompt path: " + label, "dtype": dname, "B": B,
                  "max_abs_err": err, "fro_err": fro,
                  "tol": _fwd_tol(dtype, all_masked), "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"attention {label} {dtype}: max abs "
                                     f"err {err}, Frobenius {fro}")
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            got = attention_bwd(q, k, v, out, do, bias, lse,
                                need_dbias=all_masked)
            errs, fros, ok = _bwd_errors(got, (q, k, v, out, do, bias),
                                         all_masked)
            emit({"phase": "kernel", "kernel": "attention_bwd",
                  "case": "prompt path: " + label, "dtype": dname, "B": B,
                  "max_abs_err": errs, "fro_err": fros,
                  "tol": _bwd_tol(dtype, all_masked), "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"attention_bwd {label} {dname}: {errs} "
                                     f"{fros}")
            err_all = max(err_all, err, *errs.values())
            del q, k, v, out, lse, do, got
    return err_all


def _attention_serve_cases(smi):
    """The forward kernel in bf16 at the serve paths' small batches against
    its plain versions: B=1 (a streamed or long-form streamed request) and
    B=2 (the prompt server's streamed warm-up under CFG), on the
    synthesis path's calls (``attn_cases``) and the prompt path's (the
    null text, the cross-attention over 550 + 32 keys, the prompt
    encoder).  Checked, not timed.  Returns the largest error."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    g = torch.Generator("cuda").manual_seed(13)
    Tk = TEXT_LEN + PROMPT_TOKENS
    cases = [(label, Tq, Tk_, H, D, "masked" if masked else None)
             for label, Tq, Tk_, H, D, masked, _ in attn_cases()]
    cases += [("prompt path: null text, all keys masked", TEXT_LEN,
               TEXT_LEN, TEXT_HEADS, TEXT_HEAD_DIM, "all"),
              (f"prompt path: cross T=900 Tk={Tk} D=32", 900, Tk, 8, 32,
               None),
              (f"prompt path: prompt self T={PROMPT_T} D=96", PROMPT_T,
               PROMPT_T, 8, 96, None),
              (f"prompt path: prompt pool T={PROMPT_TOKENS} Tk={PROMPT_T} "
               "D=96", PROMPT_TOKENS, PROMPT_T, 8, 96, None)]
    err_all = 0.0
    for B in (1, 2):
        for label, Tq, Tk_, H, D, mask in cases:
            all_masked = mask == "all"
            q, k, v, bias = attn_inputs(g, B, Tq, Tk_, H, D, mask == "masked",
                                        torch.bfloat16)
            if all_masked:
                bias = torch.full((B, 1, 1, Tk_), -1e4, device="cuda")
            with torch.no_grad():
                out = flash_attention(q, k, v, bias)
                err, fro, ok = _fwd_check(out, q, k, v, bias, all_masked)
            emit({"phase": "kernel", "kernel": "attention_fwd",
                  "case": "serve: " + label, "dtype": "bfloat16", "B": B,
                  "max_abs_err": err, "fro_err": fro,
                  "tol": _fwd_tol(torch.bfloat16, all_masked), "ok": ok,
                  "card": smi})
            if not ok:
                raise AssertionError(f"attention serve {label} B={B}: max "
                                     f"abs err {err}, Frobenius {fro}")
            err_all = max(err_all, err)
    return err_all


def phase_attention_bwd(smi, train_batch):
    """The backward kernel against its plain version at B=4 (f32 and bf16
    inputs), then timed at the training batch over one train step's 36
    calls, in bf16 (``cli.train --bf16``) and in f32 (its default): kernel,
    plain, and the library's backward (SDPA through autograd); and the
    forward kernel with the lse at the same calls: kernel, plain and SDPA
    forward.  Returns the backward's and the forward's sums in bf16, each
    with the f32 sums under ``f32_train_shapes``."""
    import torch
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
            errs, fros, ok = _bwd_errors(got, (q, k, v, o, do, bias))
            torch.cuda.synchronize()
            emit({"phase": "kernel", "kernel": "attention_bwd",
                  "case": label, "dtype": dname, "B": N_REQUESTS,
                  "max_abs_err": errs, "fro_err": fros,
                  "tol": _bwd_tol(dtype), "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"attention_bwd {label} {dname}: {errs} "
                                     f"{fros}")
            err_all = max(err_all, *errs.values())
            del q, k, v, do, o, lse, got

    sums = {str(dtype).split(".")[-1]: _attn_train_sums(smi, g, train_batch,
                                                          dtype)
            for dtype in (torch.bfloat16, torch.float32)}
    step, fwd = sums["bfloat16"]
    step["f32_train_shapes"], fwd["f32_train_shapes"] = sums["float32"]
    return {"max_abs_err": err_all, **step}, fwd


def _attn_train_sums(smi, g, B, dtype):
    """Kernel #1 with the lse and kernel #2 over one train step's
    ``ATTN_CALLS`` calls at batch ``B`` in ``dtype``, each call checked and
    timed by ``_bwd_case_times`` and emitted; returns the backward's and
    the forward's sums with their bounds and exp floors."""
    dname = str(dtype).split(".")[-1]
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "fwd_lse_ms": 0.0, "flop": 0, "bytes": 0, "exps": 0}
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
           "bytes": 0, "exps": 0}
    for label, Tq, Tk, H, D, masked, n in attn_cases():
        t = _bwd_case_times(g, B, Tq, Tk, H, D, masked, dtype)
        emit({"phase": "kernel_time", "kernel": "attention_bwd",
              "case": label, "dtype": dname, "B": B, "calls": n,
              **t["bwd"], "card": smi})
        emit({"phase": "kernel_time", "kernel": "attention_fwd_lse",
              "case": label, "dtype": dname, "B": B, "calls": n,
              **t["fwd"], "card": smi})
        for acc, key in ((step, "bwd"), (fwd, "fwd")):
            for k in acc:
                acc[k] += n * t[key][k]
    exps, fwd_exps = step.pop("exps"), fwd.pop("exps")
    b = tc_bound(step.pop("flop"), step.pop("bytes"), dname)
    fb = tc_bound(fwd.pop("flop"), fwd.pop("bytes"), dname)
    for d in (b, fb):
        del d["flop"], d["bytes"]
    unit = f"one train step's {ATTN_CALLS} calls, {dname}, B={B}"
    return ({**step, **b, "exp_ms": exp_floor(exps), "unit": unit},
            {**fwd, **fb, "exp_ms": exp_floor(fwd_exps),
             "unit": unit + ", with the lse"})


def _bwd_case_times(g, B, Tq, Tk, H, D, masked, dtype=None):
    """One attention call at [B, Tq/Tk, H, D] in ``dtype`` (bf16 if None):
    the forward kernel's o and lse and the backward kernel's gradients
    held against the plain versions on the same inputs (``_hold_call``),
    two backward runs to the same bits (raises if either fails); then
    timed by CUDA events: the backward kernel, its plain version and the
    library's backward (SDPA through autograd); the forward kernel with
    the lse, its plain version (bf16: ``flash_attention_plain``, f32:
    ``attention_plain``) and SDPA's forward; each with its flop, bytes and
    exps and its bounds (``tc_bound``).  ``fwd_lse_ms`` rides with the
    backward."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_plain, flash_attention_plain,
    )
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    fwd_plain = (flash_attention_plain if dtype == torch.bfloat16
                 else attention_plain)
    q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked, dtype)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    o, lse = flash_attention(q, k, v, bias, return_lse=True)
    # two launches a call and no atomics: the same bits on every run
    once, again = (attention_bwd(q, k, v, o, do, bias, lse,
                                 need_dbias=masked) for _ in range(2))
    same = all(torch.equal(a, b) for a, b in zip(once, again)
               if a is not None)
    check, ok = _hold_call(q, k, v, bias, o, lse, do, once)
    del once, again
    if not (ok and same):
        raise AssertionError(f"attention {dname} B={B} Tq={Tq} Tk={Tk} "
                             f"H={H} D={D}: bit_identical={same}, against "
                             f"the plain versions {check}")
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, bias, return_lse=True),
                     10)
    fwd_plain_ms = cuda_ms(lambda: fwd_plain(q, k, v, bias), 3)
    fwd_lib_ms = cuda_ms(lambda: sdpa(q, k, v, bias), 10)
    ms = cuda_ms(lambda: attention_bwd(q, k, v, o, do, bias, lse,
                                       need_dbias=masked), 10)
    plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, o, do, bias), 3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, bias)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    size = q.element_size()
    # recomputed scores, dv, dp, dq, dk: five [Tq,Tk,D] products
    flop = opcount.attention_bwd(B, Tq, Tk, H, D)
    # p is recomputed in each of the two passes
    exps = 2 * B * H * Tq * Tk
    # q, o, do in and dq out; k, v in and dk, dv out; the f32 lse in;
    # the bias in and its gradient out where it is masked
    nbytes = (size * 4 * B * H * D * (Tq + Tk) + 4 * B * H * Tq
              + (8 * B * Tk if masked else 0))
    # the forward with the lse: q, k, v in, o and the f32 lse out
    fwd_flop = opcount.attention_fwd(B, Tq, Tk, H, D)
    fwd_exps = B * H * Tq * Tk
    fwd_bytes = (size * 2 * B * H * D * (Tq + Tk) + 4 * B * H * Tq
                 + (4 * B * Tk if masked else 0))
    del q, k, v, do, o, lse, leaves, out
    torch.cuda.empty_cache()
    return {"bwd": {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "fwd_lse_ms": fwd_ms, **tc_bound(flop, nbytes, dname),
                    "exps": exps, "exp_ms": exp_floor(exps),
                    "bit_identical": same, "check": check,
                    "tol": _bwd_tol(dtype)},
            "fwd": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                    "library_ms": fwd_lib_ms,
                    **tc_bound(fwd_flop, fwd_bytes, dname),
                    "exps": fwd_exps, "exp_ms": exp_floor(fwd_exps),
                    "tol": _fwd_tol(dtype)}}


def prompt_train_attn_cases():
    """(label, Tq, Tk, H, D, calls per train step) of the attention calls
    the prompt family adds or changes in training: the prompt encoder's
    self-attention and its pooling, and the UNet's cross-attention over
    550 text + 32 prompt keys (unmasked: the UNet never masks them)."""
    Tk = TEXT_LEN + PROMPT_TOKENS
    cases = [(f"prompt self T={PROMPT_T} D={PROMPT_HEAD_DIM}", PROMPT_T,
              PROMPT_T, PROMPT_HEADS, PROMPT_HEAD_DIM, PROMPT_BLOCKS),
             (f"prompt pool T={PROMPT_TOKENS} Tk={PROMPT_T} "
              f"D={PROMPT_HEAD_DIM}", PROMPT_TOKENS, PROMPT_T, PROMPT_HEADS,
              PROMPT_HEAD_DIM, 1)]
    cases += [(f"cross T={T} Tk={Tk} D={D}", T, Tk, 8, D, n)
              for T, D, n in UNET_ATTN]
    return cases


def phase_prompt_attention_bwd(smi, B):
    """The attention backward at the prompt family's training shapes
    (batch ``B``): against its plain version in f32 and bf16, twice for the
    same bits; then timed in bf16 (kernel, plain, SDPA's backward) with its
    bound, summed over one train step's calls at the prompt encoder's
    shapes and, apart, at the cross-attention over 582 keys."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    g = torch.Generator("cuda").manual_seed(5)
    err_all = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, Tq, Tk, H, D, n in prompt_train_attn_cases():
            q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, False, dtype)
            o, lse = flash_attention(q, k, v, bias, return_lse=True)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            got, again = (attention_bwd(q, k, v, o, do, bias, lse)
                          for _ in range(2))
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            errs, fros, ok = _bwd_errors(got, (q, k, v, o, do, bias))
            emit({"phase": "kernel", "kernel": "attention_bwd",
                  "case": "prompt train: " + label, "dtype": dname, "B": B,
                  "max_abs_err": errs, "fro_err": fros,
                  "tol": _bwd_tol(dtype), "bit_identical": same,
                  "ok": ok and same, "card": smi})
            if not (ok and same):
                raise AssertionError(f"attention_bwd prompt train {label} "
                                     f"{dname}: {errs} {fros} same={same}")
            err_all = max(err_all, *errs.values())
            del q, k, v, o, lse, do, got, again
            torch.cuda.empty_cache()
    sums = {}
    for label, Tq, Tk, H, D, n in prompt_train_attn_cases():
        t = _bwd_case_times(g, B, Tq, Tk, H, D, False)["bwd"]
        emit({"phase": "kernel_time", "kernel": "attention_bwd",
              "case": "prompt train: " + label, "dtype": "bfloat16",
              "B": B, "calls": n, **t, "card": smi})
        group = "prompt_encoder" if label.startswith("prompt") else "unet_cross"
        acc = sums.setdefault(group, {"ms": 0.0, "plain_ms": 0.0,
                                      "library_ms": 0.0, "flop": 0,
                                      "bytes": 0, "exps": 0, "calls": 0})
        for key in ("ms", "plain_ms", "library_ms", "flop", "bytes",
                    "exps"):
            acc[key] += n * t[key]
        acc["calls"] += n
    for group, acc in sums.items():
        b = bound(acc.pop("flop"), acc.pop("bytes"), "bfloat16")
        acc.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   exp_ms=exp_floor(acc.pop("exps")),
                   unit=f"one prompt-family train step's {acc['calls']} "
                        f"calls, bf16, B={B}")
    return {"max_abs_err": err_all, **sums}


def _lstm_inputs(T, B, g, H=512):
    """x_proj [T,B,4H], w_hh [H,4H] and the same weights as w_hh_t [4H,H],
    and cuDNN's LSTM on x_proj as its input (w_ih = identity, zero biases,
    the same w_hh; it does one extra [4H,4H] input projection)."""
    import torch
    with torch.no_grad():
        x = torch.randn(T, B, 4 * H, generator=g, device="cuda") * 0.5
        w = torch.randn(H, 4 * H, generator=g, device="cuda") * H ** -0.5
        w_t = w.t().contiguous()
        lib = torch.nn.LSTM(4 * H, H, device="cuda")
        lib.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lib.weight_hh_l0.copy_(w_t)
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()
    return x, w, w_t, lib


def _lstm_case(smi, T, B, g):
    """Both LSTM kernels (the step schedule on w_hh [H,4H], the persistent
    one on w_hh_t [4H,H], the same weights) against their plain versions,
    twice for the same bits, timed beside cuDNN.  Returns a row for each."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_plan, lstm_recurrence, lstm_recurrence_plain, lstm_recurrence_t,
        lstm_recurrence_t_plain, lstm_t_grid,
    )
    H = 512
    with torch.no_grad():
        x, w, w_t, lib = _lstm_inputs(T, B, g, H)
        lib_ms = cuda_ms(lambda: lib(x), 3)
        rows = {}
        for name, schedule, fn, plain, wt in (
                ("lstm", "step", lstm_recurrence, lstm_recurrence_plain, w),
                ("lstm_t", "persistent", lstm_recurrence_t,
                 lstm_recurrence_t_plain, w_t)):
            out = fn(x, wt)
            again = fn(x, wt)
            ref = plain(x, wt)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            same = torch.equal(out, again)
            ms = cuda_ms(lambda: fn(x, wt), 5)
            plain_ms = cuda_ms(lambda: plain(x, wt), 2)
            ok = bool(torch.isfinite(out).all()) and err <= LSTM_TOL and same
            flop = opcount.lstm(T, B, H)
            nbytes = 4 * (T * B * 4 * H + H * 4 * H + T * B * H)
            b = bound(flop, nbytes, "float32")
            extra = lstm_plan(schedule, B, H)
            if name == "lstm_t":
                extra["grid"], extra["max_resident_ctas"] = lstm_t_grid(B, H)
            emit({"phase": "kernel", "kernel": name,
                  "case": f"T={T} B={B} H={H}", "dtype": "float32",
                  "max_abs_err": err, "tol": LSTM_TOL, "bit_identical": same,
                  "ms": ms, "us_per_step": ms * 1e3 / T, "plain_ms": plain_ms,
                  "library_ms": lib_ms,
                  "library_note": "cuDNN nn.LSTM with w_ih = I: one extra "
                                  "4Hx4H input projection", **extra, **b,
                  "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"{name} T={T} B={B}: max abs err {err} "
                                     f"(tol {LSTM_TOL}), same bits {same}")
            rows[name] = {"max_abs_err": err, "ms": ms,
                          "us_per_step": ms * 1e3 / T, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b["bound_ms"],
                          "bound_by": b["bound_by"],
                          "unit": f"one layer, T={T} B={B} H={H}"}
    return rows


def phase_lstm(smi):
    """Both LSTM kernels at the paths' shapes (``LSTM_SHAPES``).  Returns
    the step and persistent rows: the decoder's, with the encoder's, the
    prompt encode's and the serve paths' batch-1 shapes inside."""
    import torch
    g = torch.Generator("cuda").manual_seed(2)
    cases = [_lstm_case(smi, T, B, g) for T, B in LSTM_SHAPES]
    dec, enc, prompt = cases[:3]
    rows = {}
    for name in ("lstm", "lstm_t"):
        rows[name] = dict(
            dec[name], encoder_b32=enc[name], prompt_encode=prompt[name],
            serve_b1={f"T={T}": c[name] for (T, _), c in
                      zip(LSTM_SHAPES[3:], cases[3:])},
            max_abs_err=max(c[name]["max_abs_err"] for c in cases))
    return rows["lstm"], rows["lstm_t"]


def lstm_times(smi):
    """``--lstm-times``: both LSTM kernels at the paths' three shapes beside
    cuDNN (f32, TF32 off), no checks: ms a layer and us a step by CUDA
    events, the kernels and cuDNN in turns, and the host's ms to enqueue
    one call.  Uses only ``lstm_recurrence`` and
    ``lstm_recurrence_t``, which earlier versions of the package have too,
    so that two checkouts can be timed in one call."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence, lstm_recurrence_t,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32
    g = torch.Generator("cuda").manual_seed(2)
    for T, B in LSTM_SHAPES:
        x, w, w_t, lib = _lstm_inputs(T, B, g)
        runs = {"lstm": lambda: lstm_recurrence(x, w),
                "lstm_t": lambda: lstm_recurrence_t(x, w_t),
                "cudnn": lambda: lib(x)}
        ms = {k: [] for k in runs}
        host = {k: [] for k in runs}
        # cuDNN in f32, as the kernels (and phase_lstm's comparison)
        with torch.no_grad(), full_f32():
            for _ in range(3):
                for k, fn in runs.items():
                    ms[k].append(cuda_ms(fn, 5))
                    # the host's time to enqueue one call (900 launches for
                    # the step kernel), the card idle before it
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    host[k].append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
        med = {k: statistics.median(v) for k, v in ms.items()}
        emit({"phase": "lstm_time", "case": f"T={T} B={B} H=512",
              "ms": med, "us_per_step": {k: v * 1e3 / T
                                         for k, v in med.items()},
              "host_ms": {k: statistics.median(v) for k, v in host.items()},
              "ms_runs": ms, "card": smi})


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


def _resnet_launch(name):
    """Which launch of the resnet block a kernel's name is: GroupNorm
    statistics, activation pass, conv1 or conv2 (the convolutions' last
    template argument says which), else None."""
    for launch, pat in (("stats", r"stats"), ("activation", r"_act"),
                        ("conv2", r"true>"), ("conv1", r"false>")):
        if re.search(pat, name):
            return launch
    return None


# launches of each kind a call makes (the activation pass runs twice)
RESNET_LAUNCHES_PER_CALL = {"stats": 1, "activation": 2, "conv1": 1,
                            "conv2": 1}


def resnet_launch_ms(fn, n=10):
    """Device ms of each of the resnet kernel's launches, per call of
    ``fn`` (torch.profiler over ``n`` calls, after one warm call): the mean
    of the launches the profiler recorded, times the launches of that kind
    a call makes (it now and then drops some, or all: then it profiles
    again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            launch = _resnet_launch(e.key)
            if us > 0 and launch is not None:
                tot, cnt = seen.get(launch, (0.0, 0))
                seen[launch] = (tot + us, cnt + e.count)
        if seen:
            break
    return {k: tot / cnt / 1e3 * RESNET_LAUNCHES_PER_CALL[k]
            for k, (tot, cnt) in seen.items()}


def resnet_host_us(smi, n=300):
    """Host microseconds per call of the kernel's wrapper and of the
    dispatcher, at the deepest block at batch 1 (bf16, T=113, 768 -> 768),
    where the card is quickest and the host sets the pace: the wall of
    ``n`` back-to-back calls, enqueue only (the card syncs after)."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.ops.cuda.resnet import fused_resnet_block
    from prompt_tts_tpu_torch.ops.resnet import resnet_block
    g = torch.Generator().manual_seed(13)
    block = _resnet_block(768, 768, torch.bfloat16, g)
    x = torch.randn(1, 113, 768, generator=g).to("cuda", torch.bfloat16)
    temb = torch.randn(1, 1024, generator=g).to("cuda")
    norm = block.norm1.norm
    out = {}
    with torch.no_grad():
        tp = block.time_emb_proj(F.silu(temb))
        for name, fn in (
                ("wrapper", lambda: fused_resnet_block(
                    x, tp, block.kernel_weights, norm.num_groups, norm.eps)),
                ("dispatcher", lambda: resnet_block(block, x, temb))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out[name] = (time.perf_counter() - t0) / n * 1e6
            torch.cuda.synchronize()
    rec = {"phase": "resnet_host", "what": "host us per call, bf16 B=1 "
           "T=113 768->768", "host_us": out, "card": smi}
    emit(rec)
    return out


def _resnet_inputs(T, cin, cout, B, g):
    """A bf16 block on the card, x ``[B, T, cin]``, temb and its
    projection."""
    import torch
    import torch.nn.functional as F
    block = _resnet_block(cin, cout, torch.bfloat16, g)
    x = (torch.randn(B, T, cin, generator=g) * 1.5
         + torch.randn(cin, generator=g)).to("cuda", torch.bfloat16)
    temb = torch.randn(B, 1024, generator=g).to("cuda")
    with torch.no_grad():
        tp = block.time_emb_proj(F.silu(temb))
    return block, x, temb, tp


def _distinct_shapes():
    """``(T, Cin, Cout, blocks of that shape)`` of one flagship UNet
    forward, in forward order."""
    from prompt_tts_tpu_torch.config import ModelConfig
    shapes = [s[1:] for s in resnet_shapes(ModelConfig())]
    return [(*s, shapes.count(s)) for i, s in enumerate(shapes)
            if s not in shapes[:i]]


def resnet_times(smi):
    """``--resnet-times``: the bf16 block at B=8 at every distinct block
    shape, no checks: the wrapper's ms per call (CUDA events) and per
    launch (profiler), and the library sequence; then the host's cost per
    call.  Uses only the wrapper's first five arguments, so that two
    versions of the package can be timed in one call."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.resnet import fused_resnet_block
    g = torch.Generator().manual_seed(12)
    total = {"ms": 0.0, "library_ms": 0.0, "launch_ms": {}}
    B = 2 * N_REQUESTS
    shapes = _distinct_shapes()
    for T, cin, cout, n_blocks in shapes:
        block, x, _, tp = _resnet_inputs(T, cin, cout, B, g)
        norm = block.norm1.norm

        def kernel():
            return fused_resnet_block(x, tp, block.kernel_weights,
                                      norm.num_groups, norm.eps)
        with torch.no_grad():
            xc = x.transpose(1, 2).contiguous()
            rec = {"ms": cuda_ms(kernel, 20),
                   "launch_ms": resnet_launch_ms(kernel),
                   "library_ms": cuda_ms(
                       lambda: resnet_sequence(block, xc, tp), 10)}
        total["ms"] += n_blocks * rec["ms"]
        total["library_ms"] += n_blocks * rec["library_ms"]
        for k, v in rec["launch_ms"].items():
            total["launch_ms"][k] = total["launch_ms"].get(k, 0.0) + \
                n_blocks * v
        emit({"phase": "resnet_time", "case": f"T={T} Cin={cin} Cout={cout}",
              "B": B, "blocks": n_blocks, **rec, "card": smi})
    host = resnet_host_us(smi)
    emit({"phase": "resnet_times", "unit": f"one UNet forward's "
          f"{sum(s[3] for s in shapes)} blocks, bf16, B={B}", **total,
          "host_us": host, "card": smi})


def resnet_tile_sweep(smi):
    """``--resnet-tiles``: the tile rule's choices: bf16, each launch's
    device ms (profiler) at every tile shape the wrapper has, at every
    distinct block shape, at B = 8 and 1, beside the tile the rule picks;
    f32 (TF32 off), the wrapper's ms by CUDA events at every f32 tile and
    block shape at B = 32, 8, 4 and 1, beside the rule's and the rule's
    device ms by launch (profiler), with the sums over one UNet forward's
    22 blocks."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.ops.cuda.resnet import (
        TILES, TILES_F32, _launch, resnet_tiles,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32
    g = torch.Generator().manual_seed(12)
    for T, cin, cout, _ in _distinct_shapes():
        for B in (2 * N_REQUESTS, 1):
            block, x, _, tp = _resnet_inputs(T, cin, cout, B, g)
            norm = block.norm1.norm
            by_tiles = {}
            with torch.no_grad():
                for tiles in TILES:
                    by_tiles["{}x{}".format(*tiles)] = resnet_launch_ms(
                        lambda: _launch(
                            x, tp, block.kernel_weights, norm.num_groups,
                            norm.eps, tiles))
            emit({"phase": "resnet_tiles", "case": f"T={T} Cin={cin} "
                  f"Cout={cout}", "B": B, "launch_ms_by_tiles": by_tiles,
                  "rule": "{}x{}".format(*resnet_tiles(B, T, cin, cout)),
                  "card": smi})
    for B in (TRAIN_BATCHES[0], 2 * N_REQUESTS, N_REQUESTS, 1):
        sums, launch_sums = {}, {}
        for T, cin, cout, n in _distinct_shapes():
            block = _resnet_block(cin, cout, torch.float32, g)
            norm = block.norm1.norm
            x = (torch.randn(B, T, cin, generator=g) * 1.5
                 + torch.randn(cin, generator=g)).to("cuda")
            by_tiles = {}
            with torch.no_grad(), full_f32():
                tp = block.time_emb_proj(
                    F.silu(torch.randn(B, 1024, generator=g).to("cuda")))
                for tiles in (*TILES_F32, None):
                    key = "rule" if tiles is None else "{}x{}".format(*tiles)
                    by_tiles[key] = cuda_ms(lambda: _launch(
                        x, tp, block.kernel_weights, norm.num_groups,
                        norm.eps, tiles), 10)
                    sums[key] = sums.get(key, 0.0) + n * by_tiles[key]
                launch_ms = resnet_launch_ms(lambda: _launch(
                    x, tp, block.kernel_weights, norm.num_groups, norm.eps,
                    None))
            for key, v in launch_ms.items():
                launch_sums[key] = launch_sums.get(key, 0.0) + n * v
            emit({"phase": "resnet_tiles_f32", "case": f"T={T} Cin={cin} "
                  f"Cout={cout}", "B": B, "blocks": n, "ms_by_tiles": by_tiles,
                  "rule_launch_ms": launch_ms,
                  "rule": "{}x{}".format(*resnet_tiles(B, T, cin, cout,
                                                       torch.float32)),
                  "card": smi})
            del block, x, tp
        emit({"phase": "resnet_tiles_f32", "B": B, "unit": "one UNet "
              "forward's 22 blocks, f32", "ms_by_tiles": sums,
              "rule_launch_ms": launch_sums, "card": smi})


def synth_times(smi):
    """``--synth-times``: warm walls (median of 5) and one profile of the
    two synthesis slices through ``Synthesizer`` alone (DDIM-50 single
    speaker; the prompt family, DPM-25 CFG 3 with a 3 s prompt), 4
    requests, bf16, so that two versions of the package can be timed in
    one call."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    from prompt_tts_tpu_torch.utils.resample import resample
    prompt = resample(tone(np.random.default_rng(13),
                           int(PROMPT_S * ENCODE_SR))[:, None], ENCODE_SR,
                      SAMPLE_RATE)
    prompt_wav = np.tile(prompt[None, :, 0], (N_REQUESTS, 1))
    runs = {
        f"DDIM-{STEPS}": (Synthesizer(device="cuda", dtype=torch.bfloat16,
                                      num_inference_steps=STEPS), {}),
        f"prompt DPM-{PROMPT_STEPS} CFG {GUIDANCE}": (Synthesizer(
            config=Config(model=prompt_config()), device="cuda",
            dtype=torch.bfloat16, num_inference_steps=PROMPT_STEPS,
            sampler="dpm", guidance_scale=GUIDANCE),
            {"prompt_wav": prompt_wav})}
    for name, (synth, kw) in runs.items():
        def run():
            return synth.synthesize(TEXTS, **kw)   # host numpy: synced
        run()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        emit({"phase": "synth_time", "what": f"Synthesizer.synthesize "
              f"{N_REQUESTS} x {AUDIO_S:.0f} s, {name}, bf16", "wall_s": times,
              "median_wall_s": statistics.median(times),
              "profile": profile_step(run), "card": smi})


def phase_resnet(smi):
    """The fused resnet block at every block shape of one flagship UNet
    forward: bf16 at B=8 (CFG's doubled batch of 4 requests), at B=4 (the
    DDIM slice's batch), at B=1 (a streamed or long-form streamed request)
    and at B=2 (the same under CFG), where the tile rule picks other tiles;
    f32 (3 x TF32) at B=1 and at ``cli.evaluate``'s B=32; each checked
    against the module arithmetic and against fused_resnet_block_plain and
    run twice for the same bits, f32 B=32 at Cin = 1536 also against the
    block in f64 (RESNET_TOL_F32_DEEP); bf16 B=8 also timed (kernel, its
    launches, plain version, and the channels-first library sequence).
    Then the wrapper's host cost.  Returns the bf16 sums over the
    forward."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.config import ModelConfig
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.resnet import (
        fused_resnet_block, fused_resnet_block_plain, resnet_tiles,
    )
    from prompt_tts_tpu_torch.ops.resnet import (
        resnet_block, resnet_block_plain,
    )
    shapes = resnet_shapes(ModelConfig())
    emit({"phase": "resnet_shapes", "blocks": len(shapes),
          "shapes": [list(t) for t in shapes]})
    g = torch.Generator().manual_seed(12)
    per_shape, err_all, tiles_held = {}, 0.0, {}
    for _, T, cin, cout in shapes:
        if (T, cin, cout) in per_shape:
            continue
        row = {}
        for dtype, B, tol in ((torch.bfloat16, 2 * N_REQUESTS,
                               RESNET_TOL_BF16),
                              (torch.bfloat16, N_REQUESTS, RESNET_TOL_BF16),
                              (torch.bfloat16, 1, RESNET_TOL_BF16),
                              (torch.bfloat16, 2, RESNET_TOL_BF16),
                              (torch.float32, 1, RESNET_TOL_F32),
                              (torch.float32, TRAIN_BATCHES[0],
                               RESNET_TOL_F32)):
            timed = dtype == torch.bfloat16 and B == 2 * N_REQUESTS
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
                norm = block.norm1.norm

                def kernel():
                    return fused_resnet_block(
                        x, tp, block.kernel_weights, norm.num_groups,
                        norm.eps)
                fused = fused_resnet_block_plain(
                    x, tp, block.kernel_weights, norm.num_groups,
                    norm.eps).float()
                d = (out.float() - fused).abs()
                if dtype == torch.bfloat16:
                    excess = (d - FUSED_ATOL_BF16
                              - FUSED_RTOL_BF16 * fused.abs()).max().item()
                    rec.update({"fused_plain_excess": excess,
                                "fused_plain_tol": [FUSED_ATOL_BF16,
                                                    FUSED_RTOL_BF16]})
                else:   # the same contract as against the module
                    excess = d.max().item() - tol * max(
                        1.0, fused.abs().max().item())
                    rec["fused_plain_tol"] = tol
                same = torch.equal(out, resnet_block(block, x, temb))
                ok = ok and excess <= 0 and same
                if (dtype == torch.float32 and B == TRAIN_BATCHES[0]
                        and cin == RESNET_DEEP_CIN):
                    ref64 = resnet_block_plain(copy.deepcopy(block).double(),
                                               x.double(), tp.double())
                    deep = ((out.double() - ref64).abs().max().item()
                            / max(1.0, ref64.abs().max().item()))
                    rec.update({"f64_rel_err": deep,
                                "f64_rel_tol": RESNET_TOL_F32_DEEP})
                    ok = ok and deep <= RESNET_TOL_F32_DEEP
                    del ref64
                tiles = resnet_tiles(B, T, cin, cout, dtype)
                tiles_held.setdefault(dname, set()).add(tiles)
                rec.update({"fused_plain_max_abs_err": d.max().item(),
                            "same_bits_twice": same, "tiles": list(tiles)})
                if timed:
                    xc = x.transpose(1, 2).contiguous()
                    rec.update({
                        "ms": cuda_ms(kernel, 20),
                        "launch_ms": resnet_launch_ms(kernel),
                        "plain_ms": cuda_ms(
                            lambda: resnet_block_plain(block, x, tp), 10),
                        "library_ms": cuda_ms(
                            lambda: resnet_sequence(block, xc, tp), 10)})
                    w = 3 * cin * cout + 3 * cout * cout + (
                        cin * cout if cin != cout else 0)
                    rec.update(bound(opcount.resnet_block(B, T, cin, cout),
                                     2 * (B * T * (cin + cout) + w),
                                     dname))
            emit({"phase": "kernel", "kernel": "resnet",
                  "case": f"T={T} Cin={cin} Cout={cout}", "dtype": dname,
                  "B": B, **rec, "ok": ok, "card": smi})
            if not ok:
                raise AssertionError(f"resnet T={T} {cin}->{cout} {dname}: "
                                     f"{rec}")
            err_all = max(err_all, err)
            if timed:
                row = rec
            del block, x, out, ref
        per_shape[(T, cin, cout)] = row
    emit({"phase": "resnet_tiles_held",
          "batches": {"bfloat16": [2 * N_REQUESTS, N_REQUESTS, 1, 2],
                      "float32": [1, TRAIN_BATCHES[0]]},
          "tiles": {k: sorted(list(t) for t in v)
                    for k, v in tiles_held.items()}})
    unet = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0,
            "bytes": 0}
    launch_ms = {}
    for _, T, cin, cout in shapes:
        r = per_shape[(T, cin, cout)]
        for key in unet:
            unet[key] += r[key]
        for key, v in r["launch_ms"].items():
            launch_ms[key] = launch_ms.get(key, 0.0) + v
    b = bound(unet.pop("flop"), unet.pop("bytes"), "bfloat16")
    out = {"max_abs_err": err_all, **unet, "launch_ms": launch_ms,
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "host_us": resnet_host_us(smi),
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
    contract, twice for the same bits; the launch plan there must split
    the codes over a thread-block cluster."""
    import torch
    from prompt_tts_tpu_torch.pipeline import full_f32
    wav = torch.as_tensor(prompt_wav, device=DEVICE)
    with torch.no_grad(), full_f32():
        emb = runner.codec.encoder(wav[..., None]).contiguous()
    cb = runner.codec.codebooks[:8].detach()
    r = rvq_check(smi, "prompt latents", emb, cb)
    plan = _rvq_plan(emb.shape[0] * emb.shape[1], cb.shape[0], cb.shape[1])
    if plan["cluster"] < 2:
        raise AssertionError(f"rvq_plan at the prompt encode: {plan}")
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


def cdist_sequence(x, cb):
    """The RVQ encode's library-call yardstick: the n_q-layer cascade as
    ``torch.cdist`` + argmin, gather and subtract (no one PyTorch call
    computes it)."""
    import torch
    r = x.reshape(-1, x.shape[-1])
    for e in cb:
        idx = torch.cdist(r, e).argmin(-1)
        r = r - e[idx]


def rvq_bounds(N, n_q, K, D=128):
    """The least time of one RVQ encode of N vectors: its operations in f32
    on the CUDA cores (the kernel before 3 x TF32), and the three TF32
    products the kernel runs on the tensor cores, each beside the bytes."""
    from prompt_tts_tpu_torch.ops.cuda import opcount
    flop = opcount.rvq_encode(N, n_q, K, D)
    nbytes = 4 * (N * D + n_q * K * D + N * n_q)
    return {"f32": bound(flop, nbytes, "float32"),
            "tf32x3": bound(3 * flop, nbytes, "tfloat32")}


def _rvq_plan(N, n_q, K):
    """``rvq_plan`` where the package has it (earlier versions do not)."""
    try:
        from prompt_tts_tpu_torch.ops.cuda.rvq import rvq_plan
    except ImportError:
        return None
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return rvq_plan(N, n_q, K, sms)._asdict()


def rvq_check(smi, case, x, cb):
    """The RVQ kernel against its plain version (cuBLAS, TF32 off) on
    ``x``, by the index contract, run twice for the same bits; prints the
    launch plan and each vector whose codes differ."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.rvq import (
        index_contract, rvq_encode, rvq_encode_plain,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32
    B, T, D = x.shape
    n_q, K, _ = cb.shape
    with full_f32():
        got = rvq_encode(x, cb)
        again = rvq_encode(x, cb)
        ref = rvq_encode_plain(x, cb)
        torch.cuda.synchronize()
    r = index_contract(x, cb, got, ref)
    r["same_bits_twice"] = bool(torch.equal(got, again))
    r["ok"] = (r["violations"] == 0 and r["same_bits_twice"]
               and r["differ"] <= RVQ_MAX_DIFFER * r["vectors"]
               and tuple(got.shape) == (B, n_q, T))
    ref = ref.to(got.device)
    differing = [{"b": b, "t": t, "kernel": got[b, :, t].tolist(),
                  "plain": ref[b, :, t].tolist()}
                 for b, t in (got != ref).any(1).nonzero().tolist()[:20]]
    emit({"phase": "kernel", "kernel": "rvq_encode", "case": case,
          "shape": f"[{B}, {T}, {D}] x [{n_q}, {K}, {D}]",
          "plan": _rvq_plan(B * T, n_q, K), **r,
          "max_differ_share": RVQ_MAX_DIFFER,
          "differing_vectors": differing, "card": smi})
    if not r["ok"]:
        raise AssertionError(f"rvq_encode {case}: {r}")
    return r


def phase_rvq(smi, emb, cb):
    """The RVQ kernel against its plain version (cuBLAS, TF32 off) at
    ``[32, 900, 128] x [8, 1024, 128]``: on the encode slice's latents
    ``emb`` and on seeded normal vectors of the same shape, with the
    slice's codebooks ``cb``; then timed on the latents."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.rvq import (
        rvq_encode, rvq_encode_plain,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32
    n_q, K, D = cb.shape
    B, T, _ = emb.shape
    g = torch.Generator(DEVICE).manual_seed(10)
    normal = torch.randn(emb.shape, generator=g, device=DEVICE)
    res = {name: rvq_check(smi, name, x, cb)
           for name, x in (("latents", emb), ("normal", normal))}
    with full_f32():
        ms = cuda_ms(lambda: rvq_encode(emb, cb), 20)
        plain_ms = cuda_ms(lambda: rvq_encode_plain(emb, cb), 5)
        lib_ms = cuda_ms(lambda: cdist_sequence(emb, cb), 5)
    b = rvq_bounds(B * T, n_q, K, D)
    emit({"phase": "kernel_time", "kernel": "rvq_encode", "case": "latents",
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_note": "8 x (torch.cdist + argmin, gather, subtract)",
          **b["tf32x3"], "bound_f32_cuda_cores_ms": b["f32"]["bound_ms"],
          "card": smi})
    return {"max_abs_err": max(r["max_score_gap"] for r in res.values()),
            "max_abs_err_note": "largest f64 score gap between the kernel's "
                                "and the plain version's chosen codes",
            "differ": {k: r["differ"] for k, r in res.items()},
            "vectors": B * T, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b["tf32x3"]["bound_ms"],
            "bound_by": b["tf32x3"]["bound_by"],
            "bound_note": "3 TF32 products at 495 TFLOP/s; in f32 on the "
                          "CUDA cores (67 TFLOP/s): "
                          f"{b['f32']['bound_ms']:.4f} ms",
            "unit": f"one call, [{B}, {T}, {D}] x [{n_q}, {K}, {D}], f32"}


def rvq_device_ms(fn, n=10):
    """Device ms a call of ``fn`` spends in the RVQ kernels (prep and
    search), by the profiler, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        m = re.search(r"rvq_(prep|encode)_kernel", e.key)
        if m and us > 0:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / n
    out["total"] = sum(out.values())
    return out


def rvq_times(smi):
    """``--rvq-times``: the RVQ kernel at the paths' shapes -- the encode
    slice's [32, 900], the prompt encode's [4, 225] and one prompt
    [1, 225] -- beside the cdist sequence, x [B, T, 128] and codebooks
    [8, 1024, 128] seeded normal, in turns, three times each, by CUDA
    events (20 calls a turn; the codebooks stay in L2 between calls), and
    the kernels' device time a call by the profiler; no checks.  Uses only ``rvq_encode``, which earlier versions of the
    package have too, so that two checkouts can be timed in one call."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.rvq import rvq_encode
    from prompt_tts_tpu_torch.pipeline import full_f32
    g = torch.Generator("cuda").manual_seed(11)
    cb = torch.randn(8, 1024, 128, generator=g, device="cuda")
    for B, T in RVQ_TIME_SHAPES:
        x = torch.randn(B, T, 128, generator=g, device="cuda") * 2.0
        runs = {"kernel": lambda: rvq_encode(x, cb),
                "cdist": lambda: cdist_sequence(x, cb)}
        ms = {k: [] for k in runs}
        with torch.no_grad(), full_f32():
            for _ in range(3):
                for k, fn in runs.items():
                    ms[k].append(cuda_ms(fn, 20))
            device_ms = rvq_device_ms(runs["kernel"])
        b = rvq_bounds(B * T, 8, 1024)
        emit({"phase": "rvq_time", "case": f"[{B}, {T}, 128] x "
              f"[8, 1024, 128] f32",
              "ms": {k: statistics.median(v) for k, v in ms.items()},
              "ms_runs": ms, "kernel_device_ms": device_ms,
              "plan": _rvq_plan(B * T, 8, 1024),
              "bound_tf32x3_ms": b["tf32x3"]["bound_ms"],
              "bound_f32_cuda_cores_ms": b["f32"]["bound_ms"],
              "card": smi})


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


def _train_step_card_vs_cpu(model_cls, cfg, batch, inputs,
                            cond_dropout_prob=0.0):
    """One f32 train step of ``model_cls(cfg)`` (seeded weights and
    biases, dropout off) on the CPU (plain versions) and on the card
    (kernels), same batch
    and loss inputs (noise, timesteps, and the condition drop where
    ``cond_dropout_prob`` > 0): the step's results by device, the worst
    gradient error over its tolerance, and the checks."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import TrainConfig
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    from prompt_tts_tpu_torch.pipeline import random_init_
    from prompt_tts_tpu_torch.train.state import TrainState
    from prompt_tts_tpu_torch.train.step import make_loss_fn
    assert cfg.dropout == 0.0 and cfg.text_encoder_dropout == 0.0
    tcfg = TrainConfig(batch_size=len(batch["codes"]), learning_rate=1e-4,
                       lr_warmup_steps=0)
    weights = model_cls(cfg)
    random_init_(weights, torch.Generator().manual_seed(0))
    # biases N(0, 0.1), as the CPU parity tests fill them: with zero biases
    # the null prompt's all-zero rows reach LayerNorm as a zero vector
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in weights.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    res, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = model_cls(cfg, device=dev)
        model.load_state_dict(weights.state_dict())
        state = TrainState(model, tcfg, num_training_steps=10)
        loss_fn = make_loss_fn(model, linear_schedule(device=dev),
                               cond_dropout_prob)
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
    # rounding noise scales with the gradients of the sub-model a tensor
    # sits in (text encoder, prompt encoder, UNet)
    group_sq = {}
    for n, ref in grads["cpu"].items():
        top = n.split(".")[0]
        group_sq[top] = group_sq.get(top, 0.0) + ref.norm().item() ** 2
    worst, worst_name, zero = 0.0, None, 0
    for n, ref in grads["cpu"].items():
        err = (grads["cuda"][n] - ref).norm().item()
        floor = ZERO_GRAD * group_sq[n.split(".")[0]] ** 0.5
        if ref.norm().item() <= floor:
            zero += 1
            rel = err / floor     # must stay <= 1
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
    }
    return {"cuda": res["cuda"], "cpu": res["cpu"],
            "grad_norm_by_part": {k: v ** 0.5 for k, v in group_sq.items()},
            "loss_tol": TRAIN_LOSS_TOL, "grad_rtol": TRAIN_GRAD_RTOL,
            "worst_grad_err_over_tol": worst, "worst_grad": worst_name,
            "zero_grad_tensors": zero}, checks


def phase_train_small(smi):
    """One f32 train step of the full-width model at batch 1, dropout off:
    card (kernels) against CPU (plain versions)."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import ModelConfig
    from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    cfg = dataclasses.replace(ModelConfig(), text_encoder_dropout=0.0)
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
    out, checks = _train_step_card_vs_cpu(TTSSingleSpeaker, cfg, batch,
                                          inputs)
    checks["launches"] = (out["cuda"]["attention_fwd"] == ATTN_CALLS
                          and out["cuda"]["attention_bwd"]
                          == LAUNCHES_PER_CALL * ATTN_CALLS)
    emit({"phase": "train_small", "what": "ModelConfig() B=1 f32 dropout "
          "off, one train step, cuda vs cpu", **out, "checks": checks,
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"train_small checks failed: {checks}")


def phase_prompt_train_small(smi):
    """One f32 train step of the full-width prompt model at batch 2,
    dropout off, the condition drop nulling row 0's text and prompt and
    keeping row 1's: card (kernels) against CPU (plain versions), same
    weights, batch, noise, timesteps and drop.  Every gradient is compared,
    the prompt encoder's too (its pooling's queries are one parameter
    expanded over the batch)."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
    from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    cfg = dataclasses.replace(prompt_config(), text_encoder_dropout=0.0)
    rng = np.random.default_rng(4)
    ids, mask = Tokenizer(max_len=cfg.cmu_seq_len).encode_batch(TEXTS[1:3])
    codes = rng.integers(0, 1024, (2, cfg.sample_size, 8))
    lat = torch.from_numpy((codes * (2 / 1023) - 1).astype(np.float32))
    batch = {"codes": lat, "text_ids": torch.from_numpy(ids),
             "text_mask": torch.from_numpy(mask),
             "prompt": lat[:, 300:300 + cfg.prompt_frames].contiguous()}
    inputs = {"noise": torch.from_numpy(rng.standard_normal(
                  (2, cfg.sample_size, 8)).astype(np.float32)),
              "timesteps": torch.tensor([421, 77]),
              "drop": torch.tensor([[True], [False]])}
    out, checks = _train_step_card_vs_cpu(TTSPromptSpeaker, cfg, batch,
                                          inputs, cond_dropout_prob=0.5)
    checks["launches"] = (out["cuda"]["attention_fwd"] == PROMPT_ATTN_CALLS
                          and out["cuda"]["attention_bwd"]
                          == LAUNCHES_PER_CALL * PROMPT_ATTN_CALLS)
    emit({"phase": "prompt_train_small", "what": "ModelConfig(prompt_"
          "conditioning=True) B=2 f32 dropout off, row 0's text and prompt "
          "dropped, one train step, cuda vs cpu", **out, "checks": checks,
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"prompt_train_small checks failed: {checks}")


def _logged(log_dir, tag):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def _kernel_class(name):
    for cls, pat in (("attention_fwd", r"attn_fwd"),
                     ("attention_bwd", r"attn_bwd"),
                     ("lstm", r"lstm_step"),
                     ("lstm_t", r"lstm_t_kernel"),
                     ("resnet", r"resnet_|gn_stats_kernel|conv_kernel<"),
                     ("rvq_encode", r"rvq_(prep|encode)"),
                     ("conv", r"fprop|dgrad|wgrad|conv|cudnn|nchwToNhwc|"
                              r"nhwcToNchw"),
                     ("gemm", r"gemm|nvjet|xmma|cutlass|sm90_"),
                     ("norm", r"norm|Norm|welford"),
                     ("optimizer", r"adam|Adam|multi_tensor")):
        if re.search(pat, name):
            return cls
    return "other"


def profile_step(step, cpu=True):
    """Device time by kernel class of one call of ``step``
    (torch.profiler); ``cpu=False`` traces the device alone, which costs
    the host less where many threads dispatch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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


def phase_train_slice(smi, tar, tmp):
    """The train CLI at full width on the code tar ``tar``, its checkpoints
    and logs under ``tmp``; returns the launches of its runs, the batch it
    used and its checkpoint directory."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL

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
    return {k: run1[k] + run2[k] for k in run1}, batch, ckpt


def phase_prompt_train_slice(smi, tar, tmp, batch):
    """The train CLI on the prompt family at full width: a config this
    script writes (``prompt_config()`` with the condition drop), ``--bf16
    --ema_decay``, batch ``batch`` on the code tar ``tar``, one epoch with a
    checkpoint under ``tmp``.  Checks the losses, the f32 parameters and
    moments, the checkpoint's EMA, the launches, and the backward kernel's
    calls at the prompt encoder's shapes (a wrapper around the backward's
    wrapper records each call's shape); then times warm steps and profiles
    one.  Returns the launches, the checkpoint directory and the config
    file."""
    import collections
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.config import Config, TrainConfig
    from prompt_tts_tpu_torch.ops.attention import AttentionFunction
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
    cfg_path = os.path.join(tmp, "prompt_train.json")
    Config(model=prompt_config(),
           train=TrainConfig(cond_dropout_prob=PROMPT_COND_DROP)
           ).to_json(cfg_path)
    ckpt, logs = os.path.join(tmp, "prompt_ckpt"), os.path.join(tmp,
                                                                "prompt_log")
    argv = ["--data_file", tar, "--config_file", cfg_path, "--log_dir", logs,
            "--ckpt_dir", ckpt, "--bf16", "--ema_decay", str(PROMPT_EMA),
            "--batch_size", str(batch), "--epochs", "1", "--log_every", "1",
            "--device", "cuda"]
    fn = AttentionFunction.backward
    shapes = collections.Counter()

    def recording(ctx, do):
        q, k = ctx.saved_tensors[:2]
        shapes[(tuple(q.shape), k.shape[1], str(q.dtype).split(".")[-1])] \
            += 1
        return fn(ctx, do)

    zero_counts()
    AttentionFunction.backward = staticmethod(recording)
    try:
        t0 = time.perf_counter()
        trainer = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        AttentionFunction.backward = staticmethod(fn)
    launches = counts()
    losses, norms = _logged(logs, "Loss/train"), _logged(logs, "grad_norm")
    steps = ENCODE_UTTERANCES // batch
    want = want_counts(
        attention_fwd=PROMPT_ATTN_CALLS * steps,
        attention_bwd=LAUNCHES_PER_CALL * PROMPT_ATTN_CALLS * steps)
    H, D = PROMPT_HEADS, PROMPT_HEAD_DIM
    want_shapes = {  # (q shape, Tk, dtype): calls in the run
        ((batch, PROMPT_T, H, D), PROMPT_T, "bfloat16"):
            PROMPT_BLOCKS * steps,
        ((batch, PROMPT_TOKENS, H, D), PROMPT_T, "bfloat16"): steps}
    for T, Dc, n in UNET_ATTN:
        want_shapes[((batch, T, 8, Dc), TEXT_LEN + PROMPT_TOKENS,
                     "bfloat16")] = n * steps
    params = list(trainer.model.parameters())
    ema, ema_step = CheckpointManager(ckpt).read_model_state(ema=True)
    checks = {
        "steps": trainer.global_step == steps,
        "logged": sorted(losses) == list(range(1, steps + 1)),
        "finite": all(np.isfinite(v) for v in list(losses.values())
                      + list(norms.values())),
        "checkpoint_ema": ema_step == steps
        and set(ema) == set(trainer.model.state_dict())
        and all(t.dtype == torch.float32 and t.device.type == "cpu"
                for t in ema.values()),
        "launches": launches == want,
        "prompt_shapes": all(shapes[k] == n for k, n in want_shapes.items()),
        "f32_master": all(p.dtype == torch.float32 for p in params) and
        all(trainer.state.optimizer.state[p]["exp_avg"].dtype
            == torch.float32 for p in params),
    }
    emit({"phase": "prompt_train_slice", "what": f"cli.train ModelConfig("
          f"prompt_conditioning=True) --bf16 --ema_decay {PROMPT_EMA} "
          f"--batch_size {batch}, cond_dropout_prob {PROMPT_COND_DROP}, the "
          f"encode slice's {ENCODE_UTTERANCES} utterances x 900 frames with "
          f"225-frame prompt crops: 1 epoch", "checks": checks,
          "launches": launches, "want_launches": want,
          "attention_bwd_calls_by_shape": {str(k): v for k, v in
                                           sorted(shapes.items())},
          "loss": losses, "grad_norm": norms, "run_s": run_s, "card": smi})
    del ema
    if not all(checks.values()):
        raise AssertionError(f"prompt train slice checks failed: {checks}")

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
    emit({"phase": "prompt_train_warm", "what": "train step ModelConfig("
          f"prompt_conditioning=True) bf16 B={batch}", "step_s": times,
          "median_step_s": statistics.median(times),
          "examples_per_s": batch / statistics.median(times),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})
    emit({"phase": "prompt_train_profile", "what": f"one prompt-family "
          f"train step B={batch}", **profile_step(step), "card": smi})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ckpt, cfg_path


def phase_ckpt_synth(smi, tmp, prompt_ckpt, prompt_cfg, single_ckpt):
    """The synthesis CLI from the port's own checkpoints, with a codec from
    ``cli.convert_codec --random``: the prompt train slice's EMA (a 3 s
    22.05 kHz voice prompt, DPM-25, CFG 3) and the single-speaker train
    slice's parameters (DDIM-50), 4 requests each, bf16.  Each must launch
    every inference kernel of its path and give the codes and wavs of an
    in-process ``Synthesizer`` on the same restored state, bit for bit.
    Returns the launches of the two CLI runs."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import convert_codec
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    from prompt_tts_tpu_torch.utils.resample import resample
    from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav
    codec_path = os.path.join(tmp, "codec.pt")
    convert_codec.main(["--random", "--out", codec_path, "--seed", "5"])
    wav_path = os.path.join(tmp, "ckpt_voice.wav")
    write_wav(wav_path, tone(np.random.default_rng(17),
                             int(PROMPT_S * ENCODE_SR)), ENCODE_SR)
    audio, sr = read_wav(wav_path)
    prompt_wav = np.tile(resample(audio, sr, SAMPLE_RATE)[None, :, 0],
                         (N_REQUESTS, 1))
    prompt_cfg_obj = Config.from_json(prompt_cfg)
    # the two families share the UNet: the same resnet blocks a forward
    n_res = len(resnet_shapes(prompt_cfg_obj.model))
    runs = {
        "prompt": dict(
            ckpt=prompt_ckpt, ema=True, config=prompt_cfg_obj,
            sampler="dpm", steps=PROMPT_STEPS, scale=GUIDANCE,
            prompt_wav=prompt_wav,
            argv=["--config_file", prompt_cfg, "--ema", "--prompt_wav",
                  wav_path, "--sampler", "dpm", "--guidance_scale",
                  str(GUIDANCE)],
            want=want_counts(
                attention_fwd=2 * (TEXT_LAYERS + PROMPT_BLOCKS + 1)
                + 32 * PROMPT_STEPS, resnet=n_res * PROMPT_STEPS, lstm=4,
                rvq_encode=1)),
        "single": dict(
            ckpt=single_ckpt, ema=False, config=Config(), sampler="ddim",
            steps=STEPS, scale=1.0, prompt_wav=None, argv=[],
            want=want_counts(attention_fwd=TEXT_LAYERS + 32 * STEPS,
                             resnet=n_res * STEPS, lstm=2)),
    }
    all_launches = {}
    for name, r in runs.items():
        argv = sum((["--text", t] for t in TEXTS), []) + [
            "--out", os.path.join(tmp, f"ckpt_{name}.wav"), "--ckpt_dir",
            r["ckpt"], "--codec_params", codec_path, "--steps",
            str(r["steps"]), "--device", "cuda", "--dtype", "bf16",
            "--seed", "0"] + r["argv"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        paths, wavs, codes = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = counts()
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        state, step = restore_model_state(r["ckpt"], r["config"],
                                          ema=r["ema"])
        on_cpu = all(t.device.type == "cpu" and t.dtype == torch.float32
                     for t in state.values())
        synth = Synthesizer(
            config=r["config"], device="cuda", dtype=torch.bfloat16,
            num_inference_steps=r["steps"], sampler=r["sampler"],
            guidance_scale=r["scale"], model_state=state,
            codec_state=torch.load(codec_path, map_location="cpu",
                                   weights_only=True))
        del state
        wavs_p, codes_p = synth.synthesize(TEXTS, seed=0, return_codes=True,
                                           prompt_wav=r["prompt_wav"])
        n_samples = int(AUDIO_S * SAMPLE_RATE)
        checks = {
            "codes_equal_in_process": bool(np.array_equal(codes, codes_p)),
            "wavs_equal_in_process": bool(np.array_equal(wavs, wavs_p)),
            "state_read_on_cpu_f32": on_cpu,
            "wav_shape": wavs.shape == (N_REQUESTS, n_samples),
            "wav_finite": bool(np.isfinite(wavs).all()),
            "codes_range": bool(codes.min() >= 0 and codes.max() <= 1023),
            "files": len(paths) == N_REQUESTS,
            "launches": launches == r["want"],
        }
        emit({"phase": "ckpt_synth", "what": f"cli.synthesize --ckpt_dir "
              f"({name} train slice, step {step}"
              f"{', EMA' if r['ema'] else ''}) --codec_params "
              f"(convert_codec --random), {N_REQUESTS} requests, "
              f"{r['sampler']}-{r['steps']} CFG {r['scale']} bf16",
              "checks": checks, "launches": launches,
              "want_launches": r["want"], "cli_wall_s": cli_s,
              "cli_peak_mem_gib": cli_peak,
              "code_min": int(codes.min()), "code_max": int(codes.max()),
              "card": smi})
        if not all(checks.values()):
            raise AssertionError(f"ckpt_synth {name} checks failed: "
                                 f"{checks}")
        all_launches[name] = launches
        del synth
        gc.collect()
        torch.cuda.empty_cache()
    return {k: all_launches["prompt"][k] + all_launches["single"][k]
            for k in KERNELS}


def _http(port, method, path, obj=None, timeout=300):
    """(status, body, headers) of one request to the in-process server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if obj is None else (
            obj if isinstance(obj, str) else json.dumps(obj))
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _streamed(port, obj):
    """POST ``obj`` on a raw socket and read the chunked response as it
    arrives: (status line, chunk payloads, s to the first chunk, s to the
    end)."""
    import socket
    body = json.dumps(obj).encode()
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f = s.makefile("rb")
        status = f.readline().decode().strip()
        headers = {}
        while True:
            line = f.readline().strip()
            if not line:
                break
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        if headers.get("transfer-encoding") != "chunked":
            raise AssertionError(f"not a chunked response: {status} "
                                 f"{headers}")
        chunks, t_first = [], None
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                break
            chunks.append(f.read(n))
            f.read(2)
            if t_first is None:
                t_first = time.perf_counter() - t0
    return status, chunks, t_first, time.perf_counter() - t0


def _wav_pcm(data):
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError(f"not a WAV: {data[:16]!r}")
    return data[44:]


def _bits(pcm):
    return pcm.astype("<i2").tobytes()


def _start_server(argv):
    """``cli.serve.build_server`` in this process, serving on a thread:
    (server, port, serving thread)."""
    import threading
    from prompt_tts_tpu_torch.cli import serve
    server = serve.build_server(argv)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1], thread


def _stop_server(server, thread, port=None):
    """Shut down with one request in flight (when ``port`` is given): it
    must complete during the drain.  Returns (its status, drain s)."""
    import threading
    result = {}
    caller = None
    if port is not None:
        caller = threading.Thread(target=lambda: result.setdefault(
            "r", _http(port, "POST", "/synthesize",
                       {"text": TEXTS[1], "seed": 99})))
        caller.start()
        deadline = time.monotonic() + 60
        while not server.stats.inflight and time.monotonic() < deadline:
            time.sleep(0.005)
    t0 = time.perf_counter()
    server.shutdown()
    server.drain()
    drain_s = time.perf_counter() - t0
    server.server_close()
    thread.join(60)
    if caller is not None:
        caller.join(300)
    return result.get("r", (None,))[0], drain_s


@contextlib.contextmanager
def _plain_lstm():
    """The codec's LSTM layers on the persistent kernel's plain version (the
    card's f32 matmuls in a Python loop) inside the scope."""
    from prompt_tts_tpu_torch.codec import layers
    from prompt_tts_tpu_torch.ops.cuda.lstm import lstm_recurrence_t_plain
    kernel = layers.lstm_recurrence_t
    layers.lstm_recurrence_t = lstm_recurrence_t_plain
    try:
        yield
    finally:
        layers.lstm_recurrence_t = kernel


@contextlib.contextmanager
def _no_cudnn():
    """PyTorch's own convolutions in place of cuDNN's inside the scope."""
    import torch
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def _prefix_diff(full, part, axis=1):
    """max |part - full| over the part's length along ``axis``."""
    n = part.shape[axis]
    return (part - full.narrow(axis, 0, n)).abs().max().item()


def stream_prefix_cause(smi, synth, text, seed):
    """Where the streamed PCM leaves the full decode, on the card, for the
    codes of ``text`` at ``seed`` (batch 1).  First the streamed PCM
    (prefixes of ``STREAM_PREFIXES``) against the full window's, with the
    LSTM kernel, with its plain version and with cuDNN off.  Then, for each
    prefix, each decoder layer on its input from the full window and on the
    first part of that input, the part a prefix gives it: the outputs'
    common part compared (0: the layer gives a prefix the full decode's
    bits); for the LSTM also its plain version, and its first layer's input
    projection (one GEMM over every frame) and recurrence apart; for a
    layer that differs, the same without cuDNN.  Run with no other work on
    the card.  Returns the PCM counts and the first layer that differs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.codec.layers import CodecLSTM
    from prompt_tts_tpu_torch.codec.rvq import rvq_decode
    from prompt_tts_tpu_torch.ops.cuda.lstm import (
        lstm_recurrence_t, lstm_recurrence_t_plain,
    )
    from prompt_tts_tpu_torch.pipeline import full_f32, wav_to_pcm16
    runner, dec = synth.codec_runner, synth.codec_runner.codec.decoder
    _, codes = synth.synthesize([text], seed=seed, return_codes=True)
    codes = torch.as_tensor(codes, device=synth.device)
    chunk = STREAM_PREFIXES[0]

    def pcm_off():
        full = wav_to_pcm16(runner.decode(codes))[0].cpu().numpy()
        streamed = np.concatenate(list(synth._decode_stream(
            codes, chunk, True)), axis=1)[0]
        d = np.abs(streamed.astype(np.int32) - full.astype(np.int32))
        return {"samples_off": int((d > 0).sum()), "max_steps": int(d.max())}

    pcm = {"kernel": pcm_off()}
    with _plain_lstm():
        pcm["plain_lstm"] = pcm_off()
    with _no_cudnn():
        pcm["no_cudnn"] = pcm_off()
    first_off = {}
    with torch.no_grad(), full_f32():
        for prefix in STREAM_PREFIXES:
            x = rvq_decode(codes, runner.codec.codebooks[:codes.shape[1]])
            t, rows = prefix, []
            for name in dec._names:
                layer = None if name is None else getattr(dec, name)
                fn = F.elu if layer is None else layer
                y, part = fn(x), fn(x[:, :t].contiguous())
                row = {"layer": name or "elu",
                       "type": ("ELU" if layer is None
                                else type(layer).__name__),
                       "T": x.shape[1], "part": t,
                       "max_abs_diff": _prefix_diff(y, part)}
                if isinstance(layer, CodecLSTM):
                    with _plain_lstm():
                        row["plain_lstm"] = _prefix_diff(
                            fn(x), fn(x[:, :t].contiguous()))

                    def proj(z, w=layer.l0_w_ih, b=layer.l0_b):
                        return torch.einsum("btc,gc->btg", z, w) + b
                    xp = proj(x)
                    row["l0_projection"] = _prefix_diff(
                        xp, proj(x[:, :t].contiguous()))
                    xp = xp.transpose(0, 1).contiguous()
                    for key, rec in (
                            ("l0_recurrence", lstm_recurrence_t),
                            ("l0_recurrence_plain", lstm_recurrence_t_plain)):
                        row[key] = _prefix_diff(
                            rec(xp, layer.l0_w_hh),
                            rec(xp[:t].contiguous(), layer.l0_w_hh), axis=0)
                elif layer is not None and row["max_abs_diff"]:
                    with _no_cudnn():
                        row["no_cudnn"] = _prefix_diff(
                            fn(x), fn(x[:, :t].contiguous()))
                rows.append(row)
                if row["max_abs_diff"] and prefix not in first_off:
                    first_off[prefix] = row["layer"] + " " + row["type"]
                x, t = y, part.shape[1]
            emit({"phase": "stream_prefix", "prefix": prefix,
                  "layers": rows, "card": smi})
    out = {"pcm_vs_full": pcm, "first_layer_off": first_off}
    emit({"phase": "stream_prefix", "codes": list(codes.shape),
          "chunk": chunk, **out, "card": smi})
    return out


def phase_serve(smi, tmp):
    """``cli.serve`` at ``ModelConfig()`` in this process (DDIM-50, bf16
    denoiser, f32 decode, batch 4), driven over HTTP on localhost; then
    ``cli.synthesize --long``.  Returns the server's launches (its startup,
    its requests and the drain) and the CLI's."""
    import threading
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.config import ModelConfig
    from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav
    n_samples = int(AUDIO_S * SAMPLE_RATE)
    path = dict.fromkeys(KERNELS, 0)
    cli_path = dict.fromkeys(KERNELS, 0)

    def served(fn, into=path):
        """Run ``fn`` with the counts at 0, and add what it launched to the
        path's launches."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        for k in KERNELS:
            into[k] += got[k]
        return out, got

    checks, out = {}, {}
    (server, port, thread), startup = served(lambda: _start_server(
        ["--port", "0", "--steps", str(STEPS), "--max_batch",
         str(N_REQUESTS), "--batch_window_ms", "30", "--crossfade_ms",
         "20"]))
    synth = server.synth
    out["startup_s"] = server.startup
    out["startup_launches"] = startup

    # 1. one request alone: the batch of 4 it is padded to, in process
    t0 = time.perf_counter()
    (status, data, _), single = served(lambda: _http(
        port, "POST", "/synthesize", {"text": TEXTS[0], "seed": 5}))
    single_s = time.perf_counter() - t0
    want = want_counts(attention_fwd=TEXT_LAYERS + 32 * STEPS,
                       resnet=len(resnet_shapes(ModelConfig())) * STEPS,
                       lstm=2)
    ref = synth.synthesize([TEXTS[0]] + [""] * (N_REQUESTS - 1), seed=5,
                           pcm16=True)[0]
    checks["single_200"] = status == 200
    checks["single_bits"] = _wav_pcm(data) == _bits(ref)
    checks["single_launches"] = single == want
    out.update(single_s=single_s, single_launches=single,
               want_single_launches=want)

    # 2. a wave of concurrent requests: two batches of 4
    def wave():
        res = [None] * SERVE_WAVE

        def call(i):
            res[i] = _http(port, "POST", "/synthesize",
                           {"text": TEXTS[i % len(TEXTS)], "seed": i})
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(SERVE_WAVE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        return res

    # the same 8 texts as two in-process batches, each pulled before the
    # next is dispatched: what the two-stage pipeline is measured against,
    # in turns (serial, wave, wave, serial)
    texts = [TEXTS[i % len(TEXTS)] for i in range(SERVE_WAVE)]

    def serial():
        t0 = time.perf_counter()
        for k in range(0, SERVE_WAVE, N_REQUESTS):
            synth.synthesize(texts[k:k + N_REQUESTS], seed=k, pcm16=True)
        return time.perf_counter() - t0

    serial_s, wave_s = [serial()], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        res, _ = served(wave)
        wave_s.append(time.perf_counter() - t0)
        checks["wave_200"] = checks.get("wave_200", True) and all(
            r is not None and r[0] == 200 for r in res)
        checks["wave_samples"] = checks.get("wave_samples", True) and all(
            len(_wav_pcm(r[1])) == 2 * n_samples for r in res if r)
    serial_s.append(serial())
    prof = profile_step(lambda: served(wave), cpu=False)
    if not prof["kernels"]:
        raise AssertionError(f"the profiler saw no kernel of the wave: "
                             f"{prof}")
    out.update(wave_s=wave_s, wave_x_realtime=[SERVE_WAVE * AUDIO_S / w
                                               for w in wave_s],
               serial_two_batches_s=serial_s,
               wave_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               wave_profile={k: prof[k] for k in (
                   "wall_ms", "busy_ms", "kernels", "idle_share",
                   "by_class_ms")})

    # 3. one streamed request: the first chunk against the full latency,
    # the PCM against the full-window decode of the same codes
    (st, chunks, t_first, t_all), _ = served(lambda: _streamed(
        port, {"text": TEXTS[2], "seed": 6, "stream": True}))
    full = synth.synthesize([TEXTS[2]], seed=6, pcm16=True)[0]
    got = np.frombuffer(b"".join(chunks)[44:], "<i2").astype(np.int32)
    steps = (np.abs(got - full.astype(np.int32))
             if len(got) == len(full) else None)
    diff = None if steps is None else steps.max()
    checks["stream_200"] = " 200 " in st + " "
    checks["stream_chunks"] = [len(c) for c in chunks] == [
        44 + 640 * 300, 640 * 300, 640 * 300]
    checks["stream_pcm"] = diff is not None and diff <= STREAM_PCM_STEPS
    out.update(stream_first_chunk_s=t_first, stream_total_s=t_all,
               stream_max_pcm_steps=None if diff is None else int(diff),
               stream_samples_off=None if diff is None else int(
                   (steps > 0).sum()))

    # 4. long-form, in one response and streamed
    n_windows = len(synth.split_long_text(LONG_TEXT))
    checks["long_windows"] = n_windows >= 2
    t0 = time.perf_counter()
    (status, data, _), _ = served(lambda: _http(
        port, "POST", "/synthesize", {"text": LONG_TEXT, "seed": 7}))
    long_s = time.perf_counter() - t0
    ref = synth.synthesize_long(LONG_TEXT, seed=7, max_batch=N_REQUESTS,
                                pcm16=True, pad_groups=True,
                                crossfade_ms=20.0)
    checks["long_bits"] = status == 200 and _wav_pcm(data) == _bits(ref)
    (st, chunks, t_first_long, t_all_long), _ = served(lambda: _streamed(
        port, {"text": LONG_TEXT, "seed": 7, "stream": True}))
    ref = np.concatenate(list(synth.synthesize_long_stream(
        LONG_TEXT, seed=7, pcm16=True, crossfade_ms=20.0)))
    data = b"".join(chunks)
    checks["long_stream_bits"] = (data[40:44] == b"\xff" * 4
                                  and data[44:] == _bits(ref))
    out.update(long_windows=n_windows, long_s=long_s,
               long_samples=len(ref), long_stream_first_chunk_s=t_first_long,
               long_stream_total_s=t_all_long)

    # 5. a streamed and a batched request in flight together, each against
    # its result alone
    both, spans = {}, {}
    t_base = time.perf_counter()

    def timed(key, fn):
        t0 = time.perf_counter() - t_base
        both[key] = fn()
        spans[key] = (t0, time.perf_counter() - t_base)

    def together():
        ts = [threading.Thread(target=timed, args=("stream", lambda:
                  _streamed(port, {"text": TEXTS[3], "seed": 8,
                                   "stream": True}))),
              threading.Thread(target=timed, args=("batch", lambda: _http(
                  port, "POST", "/synthesize",
                  {"text": TEXTS[1], "seed": 9})))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
    served(together)
    out["together_spans_s"] = spans
    ref_stream = np.concatenate(list(synth.synthesize_stream(
        [TEXTS[3]], seed=8, chunk_frames=300, pcm16=True)), axis=1)[0]
    ref_batch = synth.synthesize([TEXTS[1]] + [""] * (N_REQUESTS - 1),
                                 seed=9, pcm16=True)[0]
    checks["together_stream_bits"] = ("stream" in both and b"".join(
        both["stream"][1])[44:] == _bits(ref_stream))
    checks["together_batch_bits"] = ("batch" in both and both["batch"][0]
                                     == 200 and _wav_pcm(both["batch"][1])
                                     == _bits(ref_batch))

    # 6. the stats, then the shutdown with one request in flight
    status, body, _ = _http(port, "GET", "/stats")
    stats = json.loads(body)
    n_posts = 1 + 3 * SERVE_WAVE + 1 + 2 + 2
    checks["stats"] = (status == 200 and stats["requests"] == n_posts
                       and stats["errors"] == 0 and stats["rejected"] == 0
                       and stats["streamed"] == 3
                       and stats["latency_s_p50"] <= stats["latency_s_p90"])
    (drained, drain_s), _ = served(lambda: _stop_server(server, thread,
                                                        port))
    checks["drain"] = drained == 200 and not thread.is_alive()
    out.update(stats=stats, drain_s=drain_s)

    # 7. cli.synthesize --long writes synthesize_long's wav
    wav_path = os.path.join(tmp, "long.wav")
    (_, wavs, _), _ = served(lambda: cli.main(
        ["--text", LONG_TEXT, "--long", "--crossfade_ms", "20", "--out",
         wav_path, "--steps", str(STEPS), "--device", "cuda", "--seed",
         "3"]), into=cli_path)
    ref = synth.synthesize_long(LONG_TEXT, seed=3, crossfade_ms=20.0)
    ref_path = os.path.join(tmp, "long_ref.wav")
    write_wav(ref_path, ref, SAMPLE_RATE)
    with open(wav_path, "rb") as a, open(ref_path, "rb") as b:
        checks["cli_long_bits"] = a.read() == b.read()
    checks["cli_long_wav"] = bool(np.array_equal(wavs[0], ref))
    out["cli_long_s"] = len(read_wav(wav_path)[0]) / SAMPLE_RATE
    out["stream_prefix"] = stream_prefix_cause(smi, synth, TEXTS[2], 6)
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "serve", "what": f"cli.serve ModelConfig() in process, "
          f"DDIM-{STEPS} bf16 + f32 decode, --max_batch {N_REQUESTS}: one "
          f"request, a wave of {SERVE_WAVE}, a streamed one, long-form "
          f"({n_windows} windows) whole and streamed, a streamed and a "
          f"batched one together, /stats, the drain; cli.synthesize --long",
          "checks": checks, **out, "path_launches": path,
          "cli_long_launches": cli_path, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    del server, synth
    gc.collect()
    torch.cuda.empty_cache()
    return path, cli_path


def phase_prompt_serve(smi, tmp):
    """``cli.serve`` on the prompt family at full width (DPM-25, CFG 3,
    batch 4) with ``--speakers``: two 3 s voices and a 0.2 s one at 22.05
    kHz; one request a speaker against the in-process call, and an unknown
    speaker; the RVQ kernel at the registry's shapes.  Returns the path's
    launches and the RVQ checks' largest score gap."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import full_f32
    from prompt_tts_tpu_torch.utils.resample import resample
    from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav
    cfg = prompt_config()
    cfg_path = os.path.join(tmp, "serve_prompt.json")
    Config(model=cfg).to_json(cfg_path)
    spk = os.path.join(tmp, "speakers")
    os.makedirs(spk)
    rng = np.random.default_rng(23)
    lengths = {"ann": PROMPT_S, "ben": PROMPT_S, "cy": SHORT_VOICE_S}
    for name, s in lengths.items():
        write_wav(os.path.join(spk, f"{name}.wav"),
                  tone(rng, int(s * ENCODE_SR)), ENCODE_SR)
    path = dict.fromkeys(KERNELS, 0)
    zero_counts()
    server, port, thread = _start_server(
        ["--port", "0", "--config_file", cfg_path, "--speakers", spk,
         "--sampler", "dpm", "--steps", str(PROMPT_STEPS),
         "--guidance_scale", str(GUIDANCE), "--max_batch", str(N_REQUESTS)])
    torch.cuda.synchronize()
    startup = counts()
    synth = server.synth
    speakers = server.speakers
    short = speakers["cy"]
    F = SHORT_VOICE_FRAMES
    checks = {
        "startup_rvq": startup["rvq_encode"] == len(lengths),
        "speakers": sorted(speakers) == sorted(lengths),
        "short_repeat_padded": bool(short.shape[1] == cfg.prompt_frames and
                                    (short[:, F:] == short[:, F - 1:F]).all()),
    }
    # the registry's RVQ calls at their own shapes, [1, 225] and [1, 15],
    # on the voices' latents, against the plain version
    codec = synth.codec_runner.codec
    rvq_gap = 0.0
    for name, frames in (("ann", PROMPT_FRAMES), ("cy", SHORT_VOICE_FRAMES)):
        audio, sr = read_wav(os.path.join(spk, f"{name}.wav"))
        audio = resample(audio, sr, SAMPLE_RATE)
        audio = audio[None, :, 0] if audio.ndim == 2 else audio[None]
        wav = torch.as_tensor(np.ascontiguousarray(audio), device="cuda")
        with torch.no_grad(), full_f32():
            emb = codec.encoder(wav[..., None]).contiguous()
        checks[f"{name}_rvq_shape"] = tuple(emb.shape) == (1, frames, 128)
        rvq_gap = max(rvq_gap, rvq_check(
            smi, f"speaker {name} latents", emb,
            codec.codebooks[:8].detach())["max_score_gap"])
    launches = dict(startup)
    per_request = {}
    for i, name in enumerate(sorted(lengths)):
        zero_counts()
        status, data, _ = _http(port, "POST", "/synthesize",
                                {"text": TEXTS[i], "speaker": name,
                                 "seed": i})
        torch.cuda.synchronize()
        got = counts()
        per_request[name] = got
        for k in KERNELS:
            launches[k] += got[k]
        prompts = np.stack([speakers[name]] + [np.zeros_like(short)]
                           * (N_REQUESTS - 1))
        ref = synth.synthesize([TEXTS[i]] + [""] * (N_REQUESTS - 1), seed=i,
                               pcm16=True, prompt_codes=prompts)[0]
        checks[f"{name}_bits"] = status == 200 and _wav_pcm(data) == _bits(
            ref)
    status, _, _ = _http(port, "POST", "/synthesize",
                         {"text": TEXTS[0], "speaker": "nobody"})
    checks["unknown_speaker_400"] = status == 400
    status, body, _ = _http(port, "GET", "/speakers")
    checks["speakers_listed"] = json.loads(body) == sorted(lengths)
    _stop_server(server, thread)
    for k in KERNELS:
        path[k] = launches[k]
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "prompt_serve", "what": "cli.serve "
          f"ModelConfig(prompt_conditioning=True) in process, DPM-"
          f"{PROMPT_STEPS} CFG {GUIDANCE}, --max_batch {N_REQUESTS}, "
          f"--speakers of {len(lengths)} wavs at {ENCODE_SR} Hz "
          f"({', '.join(f'{s:g} s' for s in lengths.values())})",
          "checks": checks, "startup_s": server.startup,
          "startup_launches": startup, "request_launches": per_request,
          "path_launches": path, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"prompt serve checks failed: {checks}")
    del server, synth
    gc.collect()
    torch.cuda.empty_cache()
    return path, rvq_gap


# a tiny config for the card-vs-CPU checks of the DDPM and profile phases:
# tests/test_profile.py's, with the UNet's widths and heads set so that
# every head dim is one the attention kernel takes (32 and 64; the test's
# 32 channels over 4 heads give 8)
TINY = dict(block_out_channels=(64, 64, 128, 128), cross_attention_dim=64,
            attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=64,
            sample_size=40, layers_per_block=1, unet_num_heads=2,
            text_encoder_dropout=0.0)
# DDPM, tiny config, f32 card vs CPU over the same weights, x_T and noise:
# the model-level contract through the 1,000 steps; a code may differ only
# where the latent is this close to a rounding boundary
DDPM_TOL = 5e-4
# The 1,000-step DDPM run at the flagship's widths and one layer a block
# (ModelConfig() has two): it checks the sampler's launches and time a
# step, and keeps the whole script within its time since the UNet's
# variants and the bf16 decode joined it.
DDPM_LAYERS_PER_BLOCK = 1
# The tiny config's card-against-CPU chain runs a 250-step linear schedule
# (the same sampler): a chain of 1,000 CPU steps was most of the phase's
# time, which the script's time limit cannot spare
DDPM_TINY_STEPS = 250
# cli.profile's FLOPs of one stage, card (FlopCounterMode + the kernels'
# formulas) against CPU (FlopCounterMode alone): relative
PROFILE_FLOP_RTOL = 1e-2
# the streaming / remat / profiled train CLI run: 4 steps an epoch on the
# encode slice's 64 utterances, so the trace (steps 2 .. 4) fits one epoch
EXTRAS_BATCH = 16


def _last_json(fn, argv):
    """Run a CLI's ``main(argv)`` with its standard output captured: (its
    return value, the JSON of its last line, the lines before)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    lines = buf.getvalue().strip().splitlines()
    return ret, json.loads(lines[-1]), lines[:-1]


def _step_walls(step, batch, gen, n):
    """``n`` synchronised calls of the train step ``step``: their walls,
    the peak memory (GiB) over them and the last call's output."""
    import torch
    walls, peak, out = [], 0.0, None
    for _ in range(n):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    return walls, peak, out


def _evaluate_batch_walls(model, sched, batch, n=3):
    """One ``cli.evaluate`` batch (the eval loss and the 5-point grid: 6
    f32 forwards of ``model``, TF32 off) ``n`` times, in process: the walls
    after the first, which warms."""
    import torch
    from prompt_tts_tpu_torch.cli.evaluate import batch_losses
    from prompt_tts_tpu_torch.pipeline import full_f32
    from prompt_tts_tpu_torch.train.step import eval_generator
    walls = []
    with full_f32():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, at = batch_losses(model, sched, batch,
                                    [50, 250, 500, 750, 950],
                                    eval_generator(torch.device("cuda"), 0,
                                                   0))
            float(loss), [float(a) for a in at]
            walls.append(time.perf_counter() - t0)
    return walls[1:]


def phase_remat_train(smi, tar, batch):
    """The flagship train step at ``ModelConfig()``, bf16 over f32, batch
    ``batch`` of the encode slice's tar, the text encoder's dropout on:
    the loss and backward without and with remat from the same weights and
    generator states must give the same bits, and kernel #1 launches twice
    as often under remat (the recompute runs it again).  Then whole steps
    (clip and AdamW included) in turns, plain, remat, remat, plain: wall
    and peak memory; then the same step in f32, ``cli.train``'s default
    (no ``--bf16``; TF32 as torch sets it by default: off for matmuls, on
    for cuDNN's convolutions), warm: wall, peak memory and launches.
    Returns the launches of the two checked steps and the timed f32
    steps."""
    import torch
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.data.dataset import CodeDataset
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import set_compute_dtype_
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    from prompt_tts_tpu_torch.pipeline import random_init_
    from prompt_tts_tpu_torch.train.state import TrainState
    from prompt_tts_tpu_torch.train.step import make_loss_fn, make_train_step
    cfg = Config()
    dev = torch.device("cuda")
    model = TTSSingleSpeaker(cfg.model, device=dev)
    random_init_(model, torch.Generator().manual_seed(cfg.train.seed))
    set_compute_dtype_(model, torch.bfloat16)
    model.train()
    sched = linear_schedule(cfg.train.num_train_timesteps, device=dev)
    host = next(CodeDataset(tar).batches(batch, shuffle=True, seed=0))
    dev_batch = {k: torch.from_numpy(host[k]).to(dev)
                 for k in ("codes", "text_ids", "text_mask")}
    launches, loss, ref = {}, {}, None
    grads_equal, grad_gap = True, 0.0
    for remat in (False, True):
        loss_fn = make_loss_fn(model, sched, remat=remat)
        model.zero_grad(set_to_none=True)
        torch.manual_seed(11)       # dropout: the device's default generator
        gen = torch.Generator(dev).manual_seed(3)
        torch.cuda.synchronize()
        zero_counts()
        out = loss_fn(dev_batch, gen)
        out.backward()
        torch.cuda.synchronize()
        launches["remat" if remat else "plain"] = counts()
        loss[remat] = out.detach().clone()
        if ref is None:
            ref = {n: p.grad.clone() for n, p in model.named_parameters()}
            continue
        for n, p in model.named_parameters():
            if not torch.equal(p.grad, ref[n]):
                grads_equal = False
                grad_gap = max(grad_gap,
                               (p.grad - ref[n]).abs().max().item())
    del ref
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    state = TrainState(model, cfg.train, 100)
    steps = {r: make_train_step(state, sched, remat=r) for r in (False,
                                                                 True)}
    gen = torch.Generator(dev).manual_seed(5)
    for r in (False, True):             # warm: the moments exist after
        steps[r](dev_batch, gen)
    torch.cuda.synchronize()
    walls, peaks = {False: [], True: []}, {False: 0.0, True: 0.0}
    for r in (False, True, True, False):
        w, peak, _ = _step_walls(steps[r], dev_batch, gen, 2)
        walls[r] += w
        peaks[r] = max(peaks[r], peak)
    # cli.train's default dtype: the same step in f32, warm
    set_compute_dtype_(model, None)
    f32_step = make_train_step(state, sched)
    f32_step(dev_batch, gen)
    torch.cuda.synchronize()
    f32_steps = 3
    zero_counts()
    f32_walls, f32_peak, f32_loss = _step_walls(f32_step, dev_batch, gen,
                                                f32_steps)
    launches["f32"] = counts()
    want = want_counts(attention_fwd=ATTN_CALLS,
                       attention_bwd=LAUNCHES_PER_CALL * ATTN_CALLS)
    checks = {
        "loss_equal": bool(torch.equal(loss[False], loss[True])),
        "grads_equal": grads_equal,
        "finite": bool(torch.isfinite(loss[True])),
        "launches_plain": launches["plain"] == want,
        "launches_remat": launches["remat"] == dict(
            want, attention_fwd=2 * ATTN_CALLS),
        "f32_finite": all(bool(torch.isfinite(v)) for v in
                          f32_loss.values()),
        "launches_f32": launches["f32"] == {k: f32_steps * n
                                            for k, n in want.items()},
    }
    emit({"phase": "remat_train", "what": f"train step ModelConfig() bf16 "
          f"B={batch}, dropout 0.1, without and with remat (each resnet "
          f"block, spatial transformer and text layer a checkpoint region)",
          "checks": checks, "loss": {"plain": loss[False].item(),
                                     "remat": loss[True].item()},
          "grad_max_abs_gap": grad_gap, "launches": launches,
          "step_s": {"plain": walls[False], "remat": walls[True]},
          "median_step_s": {"plain": statistics.median(walls[False]),
                            "remat": statistics.median(walls[True])},
          "peak_mem_gib": {"plain": peaks[False], "remat": peaks[True]},
          "f32_step": {"what": f"the same step in f32 (cli.train without "
                               f"--bf16), warm, B={batch}",
                       "step_s": f32_walls,
                       "median_step_s": statistics.median(f32_walls),
                       "examples_per_s": batch / statistics.median(
                           f32_walls),
                       "peak_mem_gib": f32_peak},
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"remat train checks failed: {checks}")
    del steps, f32_step, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(launches[r][k] for r in ("plain", "remat", "f32"))
            for k in KERNELS}


def phase_train_cli_extras(smi, tar, tmp):
    """``cli.train --streaming --remat --profile_steps 2`` at
    ``ModelConfig()``, bf16, batch 16 (one epoch: 4 steps) on the encode
    slice's tar, against the same CLI in RAM without remat or profile:
    the streamed batches are the in-RAM ones, the native reader ran, the
    losses are the same bits step for step, and the Chrome trace of steps
    2-4 names both attention kernels.  Returns the launches of both runs."""
    import glob
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.data import native
    from prompt_tts_tpu_torch.data.dataset import CodeDataset
    from prompt_tts_tpu_torch.data.streaming import StreamingCodeDataset
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    B = EXTRAS_BATCH
    seed = Config().train.seed          # the first epoch's shuffle seed
    ram = list(CodeDataset(tar).batches(B, shuffle=True, seed=seed))
    streamed = list(StreamingCodeDataset(tar).batches(B, shuffle=True,
                                                      seed=seed))
    batches_equal = len(ram) == len(streamed) == ENCODE_UTTERANCES // B and \
        all(set(a) == set(b) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a) for a, b in zip(ram, streamed))
    del ram, streamed
    runs, launches, walls = {}, {}, {}
    for name, extra in (("in_ram", []),
                        ("streaming_remat_profiled",
                         ["--streaming", "--remat", "--profile_steps", "2"])):
        logs = os.path.join(tmp, f"extras_{name}")
        argv = ["--data_file", tar, "--log_dir", logs, "--bf16",
                "--batch_size", str(B), "--epochs", "1", "--log_every", "1",
                "--device", "cuda"] + extra
        torch.manual_seed(0)             # the text encoder's dropout
        zero_counts()
        t0 = time.perf_counter()
        trainer = cli.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = counts()
        runs[name] = dict(
            losses=_logged(logs, "Loss/train"), logs=logs,
            streaming=isinstance(trainer.dataset, StreamingCodeDataset))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    prof = runs["streaming_remat_profiled"]
    traces = glob.glob(os.path.join(prof["logs"], "trace", "*.json"))
    kernels, steps_traced = set(), 0
    if len(traces) == 1:
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        steps_traced = sum(e.get("name") == "train_step" and
                           e.get("cat") == "user_annotation" for e in events)
        del events
    steps = ENCODE_UTTERANCES // B
    per_step = want_counts(attention_fwd=ATTN_CALLS,
                           attention_bwd=LAUNCHES_PER_CALL * ATTN_CALLS)
    checks = {
        "native_reader": native.available(),
        "batches_equal_in_ram": batches_equal,
        "streaming_dataset": prof["streaming"]
        and not runs["in_ram"]["streaming"],
        "losses_equal": runs["in_ram"]["losses"] == prof["losses"]
        and sorted(prof["losses"]) == list(range(1, steps + 1)),
        "trace_written": len(traces) == 1 and steps_traced == 2,
        "trace_names_kernel_1": any("attn_fwd_tc" in k for k in kernels),
        "trace_names_kernel_2": any("attn_bwd_dq_tc" in k for k in kernels)
        and any("attn_bwd_dkv_tc" in k for k in kernels),
        "launches_in_ram": launches["in_ram"] == {
            k: v * steps for k, v in per_step.items()},
        "launches_remat": launches["streaming_remat_profiled"] == dict(
            {k: v * steps for k, v in per_step.items()},
            attention_fwd=2 * ATTN_CALLS * steps),
    }
    emit({"phase": "train_cli_extras", "what": f"cli.train ModelConfig() "
          f"--bf16 --batch_size {B} --epochs 1 --streaming --remat "
          f"--profile_steps 2 against the same CLI in RAM",
          "checks": checks, "loss": prof["losses"], "run_s": walls,
          "launches": launches,
          "trace_kernels": sorted(k[:60] for k in kernels
                                  if "attn_" in k)[:8],
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"train CLI extras checks failed: {checks}")
    return {k: sum(v[k] for v in launches.values()) for k in KERNELS}


def phase_evaluate(smi, tar, ckpt, prompt_ckpt, prompt_cfg, batch):
    """``cli.evaluate`` at full width, f32, ``--max_batches 2`` and the
    default 5-point grid, batch ``batch``: the flagship train slice's
    checkpoint (raw) twice, the prompt train slice's (``--ema``) twice and
    raw once.  Two runs give the same JSON, the EMA scores apart from the
    parameters, the flagship run launches kernels #1 and #6 (f32) for 6
    forwards a batch; then one batch's wall in process, and kernels #1's
    and #6's f32 paths at the batch's shapes beside their library calls.
    Returns the launches of the CLI runs."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import evaluate as cli
    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.data.dataset import CodeDataset
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import cast_compute_
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.pipeline import full_f32
    base = ["--data_file", tar, "--max_batches", "2", "--batch_size",
            str(batch), "--device", "cuda"]
    runs = {"flagship": base + ["--ckpt_dir", ckpt],
            "prompt_ema": base + ["--ckpt_dir", prompt_ckpt, "--config_file",
                                  prompt_cfg, "--ema"],
            "prompt_raw": base + ["--ckpt_dir", prompt_ckpt,
                                  "--config_file", prompt_cfg]}
    results, launches, walls = {}, {}, {}
    for name in ("flagship", "flagship", "prompt_ema", "prompt_ema",
                 "prompt_raw"):
        zero_counts()
        t0 = time.perf_counter()
        _, res, _ = _last_json(cli.main, runs[name])
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        got = counts()
        launches[name] = {k: launches.get(name, {}).get(k, 0) + got[k]
                          for k in KERNELS}
        results.setdefault(name, []).append(res)
        gc.collect()
        torch.cuda.empty_cache()
    n_res = len(resnet_shapes(Config().model))
    forwards = 2 * 6                     # 2 batches x (eval + 5 grid points)
    want = want_counts(attention_fwd=2 * forwards * ATTN_CALLS,
                       resnet=2 * forwards * n_res)
    fl, pe, pr = (results[k] for k in ("flagship", "prompt_ema",
                                       "prompt_raw"))
    checks = {
        "flagship_deterministic": fl[0] == fl[1],
        "prompt_ema_deterministic": pe[0] == pe[1],
        "ema_differs_from_raw": pe[0]["eval_loss"] != pr[0]["eval_loss"],
        "keys": set(fl[0]) == {"eval_loss", "num_batches", "batch_size",
                               "step", "params", "timestep_profile"},
        "batches": all(r[0]["num_batches"] == 2 for r in (fl, pe, pr)),
        "finite": all(np.isfinite(r[0]["eval_loss"]) and all(
            np.isfinite(v) for v in r[0]["timestep_profile"].values())
            for r in (fl, pe, pr)),
        "launches_flagship": launches["flagship"] == want,
    }
    # one batch (eval + the grid: 6 forwards) warm, in process
    cfg = Config()
    state, _ = restore_model_state(ckpt, cfg)
    model = TTSSingleSpeaker(cfg.model, device="cuda")
    model.load_state_dict(state, strict=True)
    del state
    cast_compute_(model.eval(), torch.float32)
    sched = linear_schedule(device="cuda")
    host = next(CodeDataset(tar).batches(batch))
    dev_batch = {k: torch.from_numpy(host[k]).to("cuda")
                 for k in ("codes", "text_ids", "text_mask")}
    batch_s = _evaluate_batch_walls(model, sched, dev_batch)
    with full_f32():
        attn = _attention_f32_times(batch)
        resnet_f32 = _resnet_f32_times(batch)
    emit({"phase": "evaluate", "what": f"cli.evaluate ModelConfig() f32 "
          f"--batch_size {batch} --max_batches 2, grid 50..950: the flagship "
          f"train slice's checkpoint, the prompt one's EMA and raw",
          "checks": checks, "results": {k: v[0] for k, v in results.items()},
          "cli_wall_s": walls, "launches": launches,
          "want_launches_flagship": want,
          "batch_wall_s": batch_s, "note": "batch_wall_s: one batch's "
          "6 f32 forwards (eval + 5 grid points), warm, in process",
          "attention_f32": attn, "resnet_f32": resnet_f32, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"evaluate checks failed: {checks}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(v[k] for v in launches.values()) for k in KERNELS}


def _attention_f32_times(B):
    """Kernel #1's f32 path at the evaluate path's shapes (one forward's
    36 calls at batch ``B``): each call held against its plain version on
    the same inputs (``_hold_call``; raises if it misses), then the
    kernel, its plain version and SDPA by CUDA events, summed over the
    calls, with the bounds (``tc_bound``: 3 x TF32, and the f32 CUDA
    cores') and the exp floor."""
    import torch
    from prompt_tts_tpu_torch.ops.attention import attention_plain
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    g = torch.Generator("cuda").manual_seed(0)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    errs = {"rows_with_keys": 0.0, "all_masked_rows": 0.0}
    flop = nbytes = exps = 0
    with torch.no_grad():
        for label, Tq, Tk, H, D, masked, n in attn_cases():
            q, k, v, bias = attn_inputs(g, B, Tq, Tk, H, D, masked,
                                        torch.float32)
            check, ok = _hold_call(q, k, v, bias,
                                   flash_attention(q, k, v, bias))
            if not ok:
                raise AssertionError(f"attention f32 {label} B={B}: against "
                                     f"attention_plain {check}")
            for rows, r in check.items():
                errs[rows] = max(errs[rows], r["fwd"])
            for key, fn in (("ms", flash_attention),
                            ("plain_ms", attention_plain),
                            ("library_ms", sdpa)):
                tot[key] += n * cuda_ms(lambda: fn(q, k, v, bias), 3)
            flop += n * opcount.attention_fwd(B, Tq, Tk, H, D)
            nbytes += n * (4 * 2 * B * H * D * (Tq + Tk)
                           + (4 * B * Tk if masked else 0))
            exps += n * B * H * Tq * Tk
            del q, k, v, bias
    torch.cuda.empty_cache()
    b = tc_bound(flop, nbytes, "float32")
    del b["flop"], b["bytes"]
    return {**tot, **b, "exp_ms": exp_floor(exps), "max_abs_err": errs,
            "tol": {"rows_with_keys": _fwd_tol(torch.float32),
                    "all_masked_rows": _fwd_tol(torch.float32, True)},
            "unit": f"one forward's {ATTN_CALLS} calls, f32, B={B}"}


def _resnet_f32_times(B):
    """Kernel #6's f32 path at the evaluate path's shapes (one UNet
    forward's 22 blocks at batch ``B``): each distinct block's call first
    held against the module arithmetic (``resnet_block_plain``) and
    against ``fused_resnet_block_plain`` on the same inputs, within
    RESNET_TOL_F32 of max(1, max |ref|) (raises if it misses), then the
    wrapper, the module arithmetic and the library sequence
    (``resnet_sequence``, channels-first) by CUDA events, summed over the
    blocks, with the bounds (``tc_bound``: 3 x TF32, and the f32 CUDA
    cores').  Run with TF32 off, as the evaluate path runs."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.ops.cuda import opcount
    from prompt_tts_tpu_torch.ops.cuda.resnet import (
        fused_resnet_block, fused_resnet_block_plain,
    )
    from prompt_tts_tpu_torch.ops.resnet import resnet_block_plain
    g = torch.Generator().manual_seed(12)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    errs = {"module": 0.0, "fused_plain": 0.0}
    flop = nbytes = blocks = 0
    with torch.no_grad():
        for T, cin, cout, n in _distinct_shapes():
            block = _resnet_block(cin, cout, torch.float32, g)
            norm = block.norm1.norm
            x = (torch.randn(B, T, cin, generator=g) * 1.5
                 + torch.randn(cin, generator=g)).to("cuda")
            tp = block.time_emb_proj(
                F.silu(torch.randn(B, 1024, generator=g).to("cuda")))
            xc = x.transpose(1, 2).contiguous()

            def kernel():
                return fused_resnet_block(x, tp, block.kernel_weights,
                                          norm.num_groups, norm.eps)
            out = kernel()
            check = {}
            for name, ref in (
                    ("module", resnet_block_plain(block, x, tp)),
                    ("fused_plain", fused_resnet_block_plain(
                        x, tp, block.kernel_weights, norm.num_groups,
                        norm.eps))):
                err = (out - ref).abs().max().item()
                tol = RESNET_TOL_F32 * max(1.0, ref.abs().max().item())
                check[name] = (err, tol)
                errs[name] = max(errs[name], err)
                del ref
            if not (bool(torch.isfinite(out).all())
                    and all(e <= t for e, t in check.values())):
                raise AssertionError(f"resnet f32 T={T} {cin}->{cout} "
                                     f"B={B}: (max |err|, tol) {check}")
            del out
            tot["ms"] += n * cuda_ms(kernel, 5)
            tot["plain_ms"] += n * cuda_ms(
                lambda: resnet_block_plain(block, x, tp), 3)
            tot["library_ms"] += n * cuda_ms(
                lambda: resnet_sequence(block, xc, tp), 5)
            w = 3 * cin * cout + 3 * cout * cout + (
                cin * cout if cin != cout else 0)
            flop += n * opcount.resnet_block(B, T, cin, cout)
            nbytes += n * 4 * (B * T * (cin + cout) + w)
            blocks += n
            del block, x, tp, xc
    torch.cuda.empty_cache()
    b = tc_bound(flop, nbytes, "float32")
    del b["flop"], b["bytes"]
    return {**tot, **b, "max_abs_err": errs,
            "tol": f"{RESNET_TOL_F32} x max(1, max |ref|)",
            "unit": f"one UNet forward's {blocks} blocks, f32, B={B}"}


def phase_export(smi, tmp, ckpt):
    """``cli.export_checkpoint`` of the flagship train slice's checkpoint:
    ``models/convert.load_reference_state`` of the file gives the
    checkpoint's state bit for bit, and ``cli.synthesize --ref_ckpt`` on
    it (4 requests, DDIM-50, bf16) the codes and wavs of an in-process
    ``Synthesizer`` on the checkpoint's state.  Returns the launches of
    the synthesis."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import export_checkpoint
    from prompt_tts_tpu_torch.cli import synthesize as cli
    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.models.convert import load_reference_state
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    out = os.path.join(tmp, "ckpt_export.pt")
    t0 = time.perf_counter()
    n = export_checkpoint.main(["--ckpt_dir", ckpt, "--out", out])
    export_s = time.perf_counter() - t0
    state, step = restore_model_state(ckpt, Config())
    n_state = len(state)
    n_transformers = sum(k.endswith("proj_in.weight") for k in state)
    back = load_reference_state(out)
    round_trip = set(back) == set(state) and all(
        torch.equal(back[k], v) for k, v in state.items())
    del back
    argv = sum((["--text", t] for t in TEXTS), []) + [
        "--out", os.path.join(tmp, "export.wav"), "--ref_ckpt", out,
        "--steps", str(STEPS), "--device", "cuda", "--dtype", "bf16",
        "--seed", "0"]
    zero_counts()
    _, wavs, codes = cli.main(argv)
    torch.cuda.synchronize()
    launches = counts()
    synth = Synthesizer(config=Config(), device="cuda", dtype=torch.bfloat16,
                        num_inference_steps=STEPS, model_state=state)
    del state
    wavs_p, codes_p = synth.synthesize(TEXTS, seed=0, return_codes=True)
    n_res = len(resnet_shapes(Config().model))
    want = want_counts(attention_fwd=TEXT_LAYERS + 32 * STEPS,
                       resnet=n_res * STEPS, lstm=2)
    checks = {
        "round_trip": round_trip,
        # every tensor, the inv_freq buffer, each transformer's proj_out
        "tensors": n == n_state + 1 + 2 * n_transformers,
        "codes_equal_in_process": bool(np.array_equal(codes, codes_p)),
        "wavs_equal_in_process": bool(np.array_equal(wavs, wavs_p)),
        "launches": launches == want,
    }
    emit({"phase": "export", "what": f"cli.export_checkpoint of the flagship "
          f"train slice (step {step}), then cli.synthesize --ref_ckpt, "
          f"{N_REQUESTS} requests, DDIM-{STEPS} bf16", "checks": checks,
          "tensors": n, "bytes": os.path.getsize(out), "export_s": export_s,
          "launches": launches, "want_launches": want, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"export checks failed: {checks}")
    del synth
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the deployment export: the flagship artifact's batch, the prompt
# family's (DPM-25, CFG 3)
AOT_BATCH, AOT_PROMPT_BATCH = 8, 4


def op_host_us(smi, n=300):
    """Host microseconds a call of kernels #1 and #6 through their
    ``torch.library`` op and through the launcher the eager path calls, at
    the cheapest call of a synthesis (the deepest level at batch 1, bf16:
    attention T=113, 8 heads of 96; the resnet block T=113, 768 -> 768),
    where the host sets the pace: the wall of ``n`` back-to-back calls,
    enqueue only (the card syncs after), the two routes in turns."""
    import torch
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.resnet import (
        fused_resnet_block, packed_tensors,
    )
    g = torch.Generator().manual_seed(17)
    q, k, v = (torch.randn(1, 113, 8, 96, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(3))
    block = _resnet_block(768, 768, torch.bfloat16, g)
    x = torch.randn(1, 113, 768, generator=g).to("cuda", torch.bfloat16)
    temb = torch.randn(1, 1024, generator=g).to("cuda")
    norm = block.norm1.norm
    with torch.no_grad():
        tp = block.time_emb_proj(F.silu(temb))
    pk = block.kernel_weights
    planes = packed_tensors(pk)
    calls = {
        "attention": {
            "launcher": lambda: flash_attention(q, k, v),
            "op": lambda: torch.ops.ptts.flash_attention(q, k, v, None,
                                                         False)},
        "resnet": {
            "launcher": lambda: fused_resnet_block(
                x, tp, pk, norm.num_groups, norm.eps),
            "op": lambda: torch.ops.ptts.fused_resnet_block(
                x, tp, *planes, norm.num_groups, norm.eps)}}
    out = {}
    with torch.no_grad():
        for kernel, routes in calls.items():
            samples = {r: [] for r in routes}
            for order in (("launcher", "op"), ("op", "launcher")):
                for r in order:
                    fn = routes[r]
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        fn()
                    samples[r].append((time.perf_counter() - t0) / n * 1e6)
                    torch.cuda.synchronize()
            out[kernel] = {r: statistics.mean(v) for r, v in samples.items()}
            out[kernel]["turns_us"] = samples
    return out


def _aot_case(smi, tmp, name, synth, texts, kw_live, kw_prog):
    """Export ``synth`` at ``len(texts)`` (pcm16), save, load in a fresh
    ``SynthesisProgram``, and hold one artifact call against one live call
    (warm, same seed): bits and launch counts.  Returns the record and the
    artifact call's launches."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch import aot
    path = os.path.join(tmp, f"{name}.ptts")
    header = aot.export_synthesis(synth, len(texts), path, pcm16=True)
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    prog = aot.SynthesisProgram(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    runs = {"artifact": lambda: prog.synthesize(texts, seed=0,
                                                return_codes=True, **kw_prog),
            "live": lambda: synth.synthesize(texts, seed=0, pcm16=True,
                                             return_codes=True, **kw_live)}
    out, walls, launches = {}, {}, {}
    for key, run in runs.items():
        run()                                    # warm
        zero_counts()
        t0 = time.perf_counter()
        out[key] = run()                         # host numpy: synced
        walls[key] = time.perf_counter() - t0
        launches[key] = counts()
    (pcm, codes), (pcm_l, codes_l) = out["artifact"], out["live"]
    hot = ("attention_fwd", "resnet", "lstm_t")
    checks = {
        "pcm_bit_equal": bool(pcm.dtype == np.int16
                              and np.array_equal(pcm, pcm_l)),
        "codes_bit_equal": bool(np.array_equal(codes, codes_l)),
        "launches_equal": launches["artifact"] == launches["live"],
        "launches_nonzero": all(launches["artifact"][k] for k in hot),
        "shape": pcm.shape == (len(texts), int(AUDIO_S * SAMPLE_RATE)),
    }
    rec = {"checks": checks, "export_s": header["seconds"]["export"],
           "save_s": header["seconds"]["save"], "load_s": load_s,
           "artifact_mb": mb, "sections_mb": {
               k: v / 1e6 for k, v in header["sections"].items()},
           "wall_s": walls, "launches": launches["artifact"],
           "live_launches": launches["live"]}
    del prog
    os.unlink(path)
    return rec, launches["artifact"]


def _refusals(tmp, path_header):
    """A corrupted magic and an unknown format version raise."""
    from prompt_tts_tpu_torch import aot
    header = dict(path_header, version=99)
    hdr = json.dumps(header).encode()
    cases = {"magic": b"XXXXXXXX" + struct.pack("<I", len(hdr)) + hdr,
             "version": b"PTTSPT01" + struct.pack("<I", len(hdr)) + hdr}
    refused = {}
    for name, data in cases.items():
        bad = os.path.join(tmp, f"bad_{name}.ptts")
        with open(bad, "wb") as f:
            f.write(data)
        try:
            aot.load_synthesis(bad)
            refused[name] = False
        except ValueError as e:
            refused[name] = ("not a ptts torch AOT" in str(e) if name ==
                             "magic" else "version 99" in str(e))
    return refused


def phase_aot(smi, tmp):
    """The deployment export (``aot.py``) at full width: the flagship bf16
    ``TTSSingleSpeaker`` at batch 8, DDIM-50, int16 PCM, and the prompt
    family at batch 4, DPM-25 CFG 3 (a mid-scale constant prompt), each
    exported, saved, loaded in a fresh ``SynthesisProgram`` and held bit
    for bit, and launch for launch, against the live ``Synthesizer`` on
    the same x_T; the loader's refusals; the ops' host cost against the
    launchers'.  Returns the flagship artifact call's launches."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch import aot
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer, codes_to_latents
    host = op_host_us(smi)
    texts = (TEXTS * AOT_BATCH)[:AOT_BATCH]
    synth = Synthesizer(device="cuda", dtype=torch.bfloat16,
                        num_inference_steps=STEPS)
    flag, launches = _aot_case(smi, tmp, "flagship", synth, texts, {}, {})
    del synth
    cfg = prompt_config()
    codes = np.full((AOT_PROMPT_BATCH, cfg.in_channels, cfg.prompt_frames),
                    512, np.int32)
    lat = codes_to_latents(torch.from_numpy(codes)).numpy()
    psynth = Synthesizer(config=Config(model=cfg), device="cuda",
                         dtype=torch.bfloat16,
                         num_inference_steps=PROMPT_STEPS, sampler="dpm",
                         guidance_scale=GUIDANCE)
    prompt, _ = _aot_case(smi, tmp, "prompt", psynth,
                          texts[:AOT_PROMPT_BATCH], {"prompt_codes": codes},
                          {"prompt_latents": lat})
    del psynth
    refused = _refusals(tmp, {"device": "cuda", "sections": {}})
    # the ops' extra host time over a DDIM-50 synthesis's calls, against
    # the live batch-8 wall
    extra_ms = sum((host[k]["op"] - host[k]["launcher"]) * flag["launches"][
        c] for k, c in (("attention", "attention_fwd"),
                        ("resnet", "resnet"))) / 1e3
    rec = {"phase": "aot", "what": f"aot.export_synthesis + load: flagship "
           f"bf16 B={AOT_BATCH} DDIM-{STEPS} pcm16; prompt family "
           f"B={AOT_PROMPT_BATCH} DPM-{PROMPT_STEPS} CFG {GUIDANCE}",
           "flagship": flag, "prompt": prompt, "refused": refused,
           "op_host_us": {k: {r: v[r] for r in ("launcher", "op")}
                          for k, v in host.items()},
           "op_host_turns_us": {k: v["turns_us"] for k, v in host.items()},
           "op_extra_ms_per_synthesis": extra_ms,
           "op_extra_share_of_live_wall": extra_ms / 1e3
           / flag["wall_s"]["live"], "card": smi}
    emit(rec)
    checks = {**{f"flagship_{k}": v for k, v in flag["checks"].items()},
              **{f"prompt_{k}": v for k, v in prompt["checks"].items()},
              **{f"refused_{k}": v for k, v in refused.items()}}
    if not all(checks.values()):
        raise AssertionError(f"aot checks failed: {checks}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def synth_bits(smi):
    """``--synth-bits``: the live flagship synthesis, bf16 DDIM-50 at batch
    8, int16 PCM, seed 0: sha256 of its PCM and codes (three warm calls,
    which must agree) and their walls, through ``Synthesizer`` alone, so
    that two versions of the package can be compared in one call."""
    import hashlib
    import torch
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    texts = (TEXTS * AOT_BATCH)[:AOT_BATCH]
    synth = Synthesizer(device="cuda", dtype=torch.bfloat16,
                        num_inference_steps=STEPS)
    synth.synthesize(texts, seed=0, pcm16=True)
    digests, walls = set(), []
    for _ in range(3):
        t0 = time.perf_counter()
        pcm, codes = synth.synthesize(texts, seed=0, pcm16=True,
                                      return_codes=True)
        walls.append(time.perf_counter() - t0)
        digests.add((hashlib.sha256(pcm.tobytes()).hexdigest(),
                     hashlib.sha256(codes.tobytes()).hexdigest()))
    (pcm_sha, codes_sha), = digests
    emit({"phase": "synth_bits", "what": f"Synthesizer.synthesize "
          f"{AOT_BATCH} x {AUDIO_S:.0f} s, DDIM-{STEPS} bf16, pcm16, seed 0",
          "pcm_sha256": pcm_sha, "codes_sha256": codes_sha,
          "wall_s": walls, "card": smi})


def _near_boundary(latents, tol):
    """Where a latent is within ``tol`` of a code rounding boundary."""
    import torch
    c = (latents + 1.0) * (1023.0 / 2.0)
    return (c - torch.floor(c) - 0.5).abs() * (2.0 / 1023.0) <= tol


def phase_ddpm(smi):
    """The ancestral DDPM sampler with the flagship's widths at
    ``DDPM_LAYERS_PER_BLOCK`` (random seeded weights, bf16, cross-attention
    k/v hoisted as ``Synthesizer`` does) at 4 requests over all 1,000 steps,
    then the f32 decode: finite latents, the launches, ms a step, x real
    time, and the idle share of the same step over a 100-step schedule.
    Then the tiny config in f32 on the card against the CPU port over a
    ``DDPM_TINY_STEPS``-step schedule, with the same weights, x_T and
    injected noise.  Returns the launches of the 1,000-step run."""
    import torch
    from prompt_tts_tpu_torch.config import Config, ModelConfig
    from prompt_tts_tpu_torch.diffusion.ddpm import ddpm_sample
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.models.unet1d import (
        cross_attention_kv, cross_attn_sites,
    )
    from prompt_tts_tpu_torch.pipeline import (
        Synthesizer, full_f32, latents_to_codes, random_init_,
    )
    dev = torch.device("cuda")
    cfg = Config(model=dataclasses.replace(
        ModelConfig(), layers_per_block=DDPM_LAYERS_PER_BLOCK))
    synth = Synthesizer(cfg, device="cuda", dtype=torch.bfloat16)
    ids, mask = synth.tokenizer.encode_batch(TEXTS)
    ids, mask = (torch.from_numpy(a).to(dev) for a in (ids, mask))
    x_T = synth.noise(0, N_REQUESTS).to(dev)
    T = synth.schedule.num_train_timesteps
    with torch.no_grad():
        ctx = synth.model.encode_text(ids, mask)
        kv = cross_attention_kv(synth.model.unet, ctx)

        def eps(x, t):
            return synth.model.denoise(x, t, ctx, cross_kv=kv)

        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        lat = ddpm_sample(eps, synth.schedule, x_T,
                          generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        launches = counts()
        t0 = time.perf_counter()
        wav = synth.codec_runner.decode(latents_to_codes(lat))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        short = linear_schedule(100, device=dev)
        prof = profile_step(lambda: ddpm_sample(
            eps, short, x_T, generator=torch.Generator(dev).manual_seed(0)),
            cpu=False)
    n_res = len(resnet_shapes(cfg.model))
    n_attn = 2 * len(list(cross_attn_sites(cfg.model)))
    want = want_counts(attention_fwd=n_attn * T, resnet=n_res * T)
    finite = bool(torch.isfinite(lat).all()) and bool(
        torch.isfinite(wav).all())
    del synth, ctx, kv
    gc.collect()
    torch.cuda.empty_cache()

    # the tiny config, f32: the card (kernels) against the CPU (plain)
    mcfg = ModelConfig(**TINY)
    g = torch.Generator().manual_seed(2)
    x_t = torch.randn((2, mcfg.sample_size, mcfg.in_channels), generator=g)
    noise = torch.randn((DDPM_TINY_STEPS, *x_t.shape), generator=g)
    ids_t = torch.randint(1, 149, (2, mcfg.cmu_seq_len), generator=g)
    mask_t = torch.ones_like(ids_t)
    mask_t[1, 20:] = 0
    out = {}
    threads = torch.get_num_threads()
    try:
        for d in ("cuda", "cpu"):
            # the tiny model's CPU ops are too small to split over the
            # thread pool: one thread runs the 1,000 CPU steps
            torch.set_num_threads(1 if d == "cpu" else threads)
            model = TTSSingleSpeaker(mcfg, device=d)
            random_init_(model, torch.Generator().manual_seed(0))
            model.eval()
            with torch.no_grad(), full_f32():
                c = model.encode_text(ids_t.to(d), mask_t.to(d))
                out[d] = ddpm_sample(
                    lambda x, t: model.denoise(x, t, c), linear_schedule(
                        DDPM_TINY_STEPS, device=d), x_t.to(d),
                    noise=noise.to(d)).cpu()
    finally:
        torch.set_num_threads(threads)
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    codes_card, codes_cpu = (latents_to_codes(out[d]) for d in ("cuda",
                                                                "cpu"))
    differ = codes_card != codes_cpu
    near = _near_boundary(out["cpu"], DDPM_TOL).transpose(1, 2)
    checks = {
        "finite": finite,
        "launches": launches == want,
        "tiny_latents": err <= DDPM_TOL,
        "tiny_codes": bool((~differ | near).all()) and bool(
            ((codes_card - codes_cpu).abs() <= 1).all()),
    }
    audio_s = N_REQUESTS * AUDIO_S
    emit({"phase": "ddpm", "what": f"ddpm_sample ModelConfig() widths at "
          f"{DDPM_LAYERS_PER_BLOCK} layer a block, bf16 "
          f"B={N_REQUESTS}, {T} steps, then the f32 decode; tiny config f32 "
          f"card vs CPU with injected noise over {DDPM_TINY_STEPS} steps",
          "checks": checks,
          "sample_s": sample_s, "ms_per_step": sample_s * 1e3 / T,
          "decode_s": decode_s,
          "x_realtime": audio_s / (sample_s + decode_s),
          "profile_100_steps": {k: prof[k] for k in (
              "wall_ms", "busy_ms", "kernels", "idle_share", "by_class_ms")},
          "launches": launches, "want_launches": want,
          "tiny_max_abs_err": err, "tiny_tol": DDPM_TOL,
          "tiny_codes_differ": int(differ.sum()), "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"ddpm checks failed: {checks}")
    return launches


# The UNet's optional variants at the flagship widths and depth: the Fourier
# time embedding, the avg-pool downsample and the conv-transpose upsample,
# which is exactly 2x, so the window is 896 frames (900 -> 450 -> 225 -> 113
# does not double back to 225; JAX's assert refuses 900 too).
VARIANTS = dict(time_embedding_type="fourier", downsample_avg_pool=True,
                upsample_conv_transpose=True, sample_size=896)
VARIANT_STEPS, VARIANT_TRAIN_STEPS = 10, 3
# each class-embedding mode's config and labels for N_REQUESTS rows
CLASS_MODES = {
    "table": dict(num_class_embeds=10),
    "timestep": dict(class_embed_type="timestep"),
    "identity": dict(class_embed_type="identity"),
    "projection": dict(class_embed_type="projection",
                       projection_class_embeddings_input_dim=12),
}
# A whole bf16 UNet forward on the kernels against the plain versions
# (flash_attention_plain, the module arithmetic of the resnet blocks), same
# weights and inputs, relative Frobenius error of eps: the bf16 tolerance the
# resnet phase holds one block to (the resnet kernel rounds h once where the
# module rounds it twice, a bf16 ulp being 2^-8 relative), over the forward.
UNET_FRO_BF16 = RESNET_TOL_BF16
# The bf16 codec decode against the f32 decode of the same codes, relative
# Frobenius: bf16 activations and weights through 15 conv layers (1.1e-2 on
# the CPU, tests/test_torch_codec_bf16.py).
CODEC_BF16_FRO = 3e-2


@contextlib.contextmanager
def _plain_unet():
    """The UNet's attention and resnet blocks on their plain versions
    inside the scope: ``flash_attention_plain`` (what the bf16 kernel
    computes, rounded where it rounds) and the blocks' module arithmetic;
    no kernel launches."""
    import torch.nn.functional as F
    from prompt_tts_tpu_torch.models import unet1d
    from prompt_tts_tpu_torch.ops.attention import flash_attention_plain
    from prompt_tts_tpu_torch.ops.cuda import attention as cuda_attention
    from prompt_tts_tpu_torch.ops.resnet import resnet_block_plain
    kernels = cuda_attention.flash_attention, unet1d.resnet_block

    def attention(q, k, v, bias=None, return_lse=False):
        assert not return_lse
        return flash_attention_plain(q, k, v, bias)

    def resnet(block, x, temb):
        return resnet_block_plain(block, x, block.time_emb_proj(F.silu(temb)))
    cuda_attention.flash_attention, unet1d.resnet_block = attention, resnet
    try:
        yield
    finally:
        cuda_attention.flash_attention, unet1d.resnet_block = kernels


def _rel_fro(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def phase_unet_variants(smi, tmp):
    """The UNet's optional variants at full width (``VARIANTS``): DDIM-
    ``VARIANT_STEPS`` synthesis of 4 requests in bf16 through
    ``Synthesizer`` (its launches, the wavs), one UNet forward on the kernels
    against the plain versions on the same weights; warm DDIM-50 walls of
    the variant and the flagship in turns; a full-width UNet forward with
    ``class_labels`` in each class-embedding mode, held the same way (and
    the labels conditioning it); ``VARIANT_TRAIN_STEPS`` bf16 ``Trainer``
    steps at B=32 with weight decay: finite losses, kernels #1 and #2
    launched, the Fourier buffer bit-unchanged.  Returns the launches."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.models.layers import cast_compute_
    from prompt_tts_tpu_torch.models.unet1d import UNet1DCondition
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import LAUNCHES_PER_CALL
    from prompt_tts_tpu_torch.pipeline import Synthesizer, random_init_
    from prompt_tts_tpu_torch.train.loop import Trainer
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    vcfg = ModelConfig(**VARIANTS)
    T = vcfg.sample_size
    n_res = len(resnet_shapes(vcfg))
    synth = Synthesizer(Config(model=vcfg), device="cuda",
                        dtype=torch.bfloat16,
                        num_inference_steps=VARIANT_STEPS)
    torch.cuda.synchronize()
    zero_counts()
    wavs, codes = synth.synthesize(TEXTS, seed=0, return_codes=True)
    torch.cuda.synchronize()
    launches = counts()
    want = want_counts(attention_fwd=TEXT_LAYERS + 32 * VARIANT_STEPS,
                       resnet=n_res * VARIANT_STEPS, lstm=2)

    # one UNet forward, kernels against plain versions
    g = torch.Generator().manual_seed(11)
    x = torch.randn((N_REQUESTS, T, vcfg.in_channels), generator=g).to(dev)
    t = torch.tensor([10, 250, 500, 999], device=dev)
    ids, mask = synth.tokenizer.encode_batch(TEXTS)
    unet = synth.model.unet
    with torch.no_grad():
        ctx = synth.model.encode_text(torch.from_numpy(ids).to(dev),
                                      torch.from_numpy(mask).to(dev))
        zero_counts()
        eps = unet(x, t, ctx)
        fwd_launches = counts()
        with _plain_unet():
            eps_plain = unet(x, t, ctx)
    unet_err = _rel_fro(eps, eps_plain)

    # warm DDIM-50 walls, the flagship and the variant in turns
    flagship = Synthesizer(device="cuda", dtype=torch.bfloat16,
                           num_inference_steps=STEPS)
    synth.num_inference_steps = STEPS
    walls = {"flagship": [], "variant": []}
    for name in ("flagship", "variant"):
        (flagship if name == "flagship" else synth).synthesize(TEXTS)
    for name in ("flagship", "variant", "variant", "flagship"):
        t0 = time.perf_counter()
        (flagship if name == "flagship" else synth).synthesize(TEXTS)
        walls[name].append(time.perf_counter() - t0)
    base_sd = {k: v for k, v in unet.state_dict().items()}
    del flagship, synth, unet
    gc.collect()
    torch.cuda.empty_cache()

    # class labels: every mode at full width, kernels against plain
    labels = {
        "table": torch.tensor([1, 3, 5, 7]),
        "timestep": torch.tensor([1, 250, 500, 999]),
        "identity": torch.randn((N_REQUESTS, 2 * vcfg.block_out_channels[0]),
                                generator=g),
        "projection": torch.randn((N_REQUESTS, 12), generator=g)}
    class_err, class_moved, class_loaded = {}, {}, True
    class_launches = dict.fromkeys(KERNELS, 0)
    for mode, kw in CLASS_MODES.items():
        m = UNet1DCondition(dataclasses.replace(vcfg, **kw), device="cuda")
        missing, extra = m.load_state_dict(base_sd, strict=False)
        class_loaded &= not extra and all(
            k.startswith("class_embedding.") for k in missing)
        if m.class_embedding is not None:
            random_init_(m.class_embedding, torch.Generator().manual_seed(5))
        cast_compute_(m.eval(), torch.bfloat16)
        lab = labels[mode].to(dev)
        with torch.no_grad():
            zero_counts()
            out = m(x, t, ctx, class_labels=lab)
            out0 = m(x, t, ctx, class_labels=torch.zeros_like(lab))
            for k, v in counts().items():
                class_launches[k] += v
            with _plain_unet():
                ref = m(x, t, ctx, class_labels=lab)
        class_err[mode] = _rel_fro(out, ref)
        class_moved[mode] = _rel_fro(out0, out)
        del m
    del base_sd
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 training with weight decay: the Fourier buffer stays put
    cfg = Config(model=vcfg, train=TrainConfig(
        batch_size=TRAIN_BATCHES[0], learning_rate=1e-4, weight_decay=1e-2,
        lr_warmup_steps=0, lr_scheduler="constant", num_train_epochs=1))
    ds = SyntheticDataset(n=TRAIN_BATCHES[0] * VARIANT_TRAIN_STEPS, frames=T,
                          max_seq_length=vcfg.cmu_seq_len)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, ds, log_dir=os.path.join(tmp, "variant_train"),
                      device="cuda", dtype=torch.bfloat16)
    fourier = trainer.model.unet.time_proj.weight.clone()
    lin = trainer.model.unet.time_embedding.linear_1.weight.detach().clone()
    batches = ds.batches(TRAIN_BATCHES[0])
    torch.cuda.synchronize()
    zero_counts()
    losses, step_s = [], []
    for _ in range(VARIANT_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(next(batches))["loss"]))
        step_s.append(time.perf_counter() - t0)
    train_launches = counts()
    frozen = torch.equal(trainer.model.unet.time_proj.weight, fourier)
    moved = not torch.equal(
        trainer.model.unet.time_embedding.linear_1.weight, lin)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    calls = ATTN_CALLS * VARIANT_TRAIN_STEPS
    checks = {
        "wav": wavs.shape == (N_REQUESTS, T * 320)
        and bool(np.isfinite(wavs).all()),
        "codes": codes.shape == (N_REQUESTS, 8, T)
        and bool(codes.min() >= 0 and codes.max() <= 1023),
        "synth_launches": launches == want,
        "forward_launches": fwd_launches == want_counts(
            attention_fwd=32, resnet=n_res),
        "unet_kernel_vs_plain": unet_err <= UNET_FRO_BF16,
        "class_weights_carried": class_loaded,
        "class_kernel_vs_plain": all(
            e <= UNET_FRO_BF16 for e in class_err.values()),
        "labels_condition": all(v > 0 for v in class_moved.values()),
        "class_launches": class_launches == want_counts(
            attention_fwd=2 * 32 * len(CLASS_MODES),
            resnet=2 * n_res * len(CLASS_MODES)),
        "train_finite": all(map(math.isfinite, losses)),
        "train_launches": train_launches == want_counts(
            attention_fwd=calls, attention_bwd=LAUNCHES_PER_CALL * calls),
        "fourier_frozen": frozen and moved,
    }
    emit({"phase": "unet_variants", "what": f"ModelConfig() widths with "
          f"the fourier time embedding, avg-pool downsample and "
          f"conv-transpose upsample, sample_size {T} (the conv-transpose "
          f"upsample is exactly 2x: 900 -> 450 -> 225 -> 113 does not double "
          f"back to 225, and JAX refuses 900 too): Synthesizer DDIM-"
          f"{VARIANT_STEPS} {N_REQUESTS} requests bf16; one UNet forward and "
          f"one per class-embedding mode, kernels vs plain; "
          f"{VARIANT_TRAIN_STEPS} bf16 Trainer steps at B={TRAIN_BATCHES[0]} "
          f"with weight decay 1e-2", "checks": checks,
          "launches": launches, "want_launches": want,
          "unet_rel_fro": unet_err, "class_rel_fro": class_err,
          "class_labels_move_rel_fro": class_moved, "tol": UNET_FRO_BF16,
          "ddim50_warm_wall_s": walls,
          "x_realtime_variant": N_REQUESTS * T / 75 / statistics.median(
              walls["variant"]),
          "train_loss": losses, "train_step_s": step_s,
          "train_peak_gib": peak, "phase_s": time.perf_counter() - t_phase,
          "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"unet_variants checks failed: {checks}")
    return {k: launches[k] + fwd_launches[k] + class_launches[k]
            + train_launches[k] for k in KERNELS}


def phase_codec_bf16(smi):
    """The same seeded codes ``[4, 8, 900]`` through the f32 codec and the
    bf16 one over its parameters (``CodecRunner.at_dtype``): each decode's
    warm time by CUDA events, the largest difference, the mel distance
    (``utils/mel.py``), and kernel #4 launched in both.  Returns the
    launches."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.pipeline import CodecRunner
    from prompt_tts_tpu_torch.utils.mel import log_mel
    runner = CodecRunner("cuda")
    fast = runner.at_dtype(torch.bfloat16)
    codes = torch.randint(0, 1024, (N_REQUESTS, 8, 900),
                          generator=torch.Generator().manual_seed(3)).cuda()
    wavs, launches = {}, {}
    for name, r in (("f32", runner), ("bf16", fast)):
        torch.cuda.synchronize()
        zero_counts()
        wavs[name] = r.decode(codes)
        torch.cuda.synchronize()
        launches[name] = counts()
    ms = {name: cuda_ms(lambda r=r: r.decode(codes), 5)
          for name, r in (("f32", runner), ("bf16", fast),
                          ("f32_again", runner), ("bf16_again", fast))}
    a, b = (wavs[k].cpu().numpy() for k in ("f32", "bf16"))
    mel = float(np.mean([np.abs(log_mel(x) - log_mel(y)).mean()
                         for x, y in zip(a, b)]))
    err = float(np.abs(a - b).max())
    fro = _rel_fro(wavs["bf16"], wavs["f32"])
    shared = all(p.data_ptr() == q.data_ptr() for p, q in zip(
        runner.codec.parameters(), fast.codec.parameters()))
    want = want_counts(lstm=2)
    checks = {
        "shape": a.shape == b.shape == (N_REQUESTS, 900 * 320),
        "finite": bool(np.isfinite(b).all()),
        "f32_out": wavs["bf16"].dtype == torch.float32,
        "lstm_launches": launches["f32"] == launches["bf16"] == want,
        "shared_params": shared,
        "bf16_near_f32": fro <= CODEC_BF16_FRO,
    }
    emit({"phase": "codec_bf16", "what": f"CodecRunner decode of the same "
          f"seeded codes [{N_REQUESTS}, 8, 900] in f32 and in bf16 over the "
          f"same parameters", "checks": checks, "decode_ms": ms,
          "max_abs_diff": err, "rel_fro": fro, "tol": CODEC_BF16_FRO,
          "mel_distance": mel, "max_abs_wav": float(np.abs(a).max()),
          "launches": launches, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"codec_bf16 checks failed: {checks}")
    del runner, fast
    return {k: launches["f32"][k] + launches["bf16"][k] for k in KERNELS}


def phase_profile(smi, tmp, train_batch):
    """``cli.profile --stages cond,denoise,decode,train,synth --time`` at
    full width, batch 8 (train ``train_batch``), DDIM-50, bf16: its table
    printed; then the tiny config's five stages on the card and on the
    CPU, whose FLOPs must agree (the kernels' formulas on the card,
    ``FlopCounterMode`` on their plain versions on the CPU).  Returns the
    launches of the full-width run."""
    import torch
    from prompt_tts_tpu_torch.cli import profile as cli
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    stages = "cond,denoise,decode,train,synth"
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    _, res, table = _last_json(cli.main, [
        "--stages", stages, "--time", "--batch_size", str(2 * N_REQUESTS),
        "--train_batch_size", str(train_batch), "--chain", "3",
        "--device", "cuda"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    for line in table:
        print(line, flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    cfg_path = os.path.join(tmp, "profile_tiny.json")
    Config(model=ModelConfig(**TINY),
           train=TrainConfig(batch_size=2)).to_json(cfg_path)
    tiny = {}
    for d in ("cuda", "cpu"):
        _, tiny[d], _ = _last_json(cli.main, [
            "--config_file", cfg_path, "--stages", stages, "--batch_size",
            "1", "--num_inference_steps", "2", "--train_batch_size", "1",
            "--device", d])
    rel = {s: abs(tiny["cuda"]["stages"][s]["gflop"]
                  - tiny["cpu"]["stages"][s]["gflop"])
           / tiny["cpu"]["stages"][s]["gflop"] for s in stages.split(",")}
    rows = res["stages"]
    checks = {
        "stages": set(rows) == set(stages.split(",")),
        "timed": all(r["ms"] > 0 and r["gflop"] > 0 and r["peak_mib"] > 0
                     for r in rows.values()),
        "train_above_denoise": rows["train"]["gflop"]
        > rows["denoise"]["gflop"],
        "synth_covers_steps": rows["synth"]["gflop"] >= 0.9 * (
            50 * rows["denoise"]["gflop"] + rows["decode"]["gflop"]),
        "tiny_gflop_card_equals_cpu": all(v <= PROFILE_FLOP_RTOL
                                          for v in rel.values()),
        "launched": launches["attention_fwd"] > 0
        and launches["attention_bwd"] > 0 and launches["resnet"] > 0,
    }
    emit({"phase": "profile", "what": f"cli.profile --stages {stages} --time "
          f"--batch_size {2 * N_REQUESTS} --train_batch_size {train_batch} "
          f"--chain 3, ModelConfig(), DDIM-50 bf16", "checks": checks,
          "result": res, "run_s": run_s,
          "tiny_gflop": {d: {s: r["gflop"] for s, r in
                             tiny[d]["stages"].items()} for d in tiny},
          "tiny_gflop_rel_gap": rel, "launches": launches, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"profile checks failed: {checks}")
    return launches


# data parallelism: the flagship's global batch and steps in the DDP
# phases, and the bounds the two-rank runs are held to against one process
# (f32 without TF32: the same arithmetic in another order; bf16: the
# rounding of the bf16 compute over three updates)
DDP_BATCH = 32
DDP_STEPS = 3
# The DDP phases check DDP's mechanics (the all-reduced gradients, bit
# equality with one process), which do not depend on depth: the flagship's
# widths at one layer a block (ModelConfig() has two), which keeps the whole
# script within its time since the UNet's variants and the bf16 decode
# joined it.
DDP_LAYERS_PER_BLOCK = 1
DDP_F32_GRAD_RTOL = 1e-4
DDP_F32_LOSS_RTOL = 1e-5
DDP_BF16_LOSS_RTOL = 2e-2
DDP_RANKS = 2


def _free_port():
    """A port that binds now, drawn below Linux's ephemeral range (32768
    up): a port the kernel hands out (``bind`` to 0) can be taken by an
    outgoing connection of another process before its server binds it."""
    import random
    import socket
    while True:
        port = random.SystemRandom().randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _ddp_config(dropout=True, **train):
    """The flagship ``ModelConfig()`` at ``DDP_LAYERS_PER_BLOCK`` and the
    DDP phases' batch, one epoch; ``dropout`` False turns the text
    encoder's off, so that two ranks and one process draw alike."""
    from prompt_tts_tpu_torch.config import Config
    cfg = Config()
    model = dataclasses.replace(cfg.model,
                                layers_per_block=DDP_LAYERS_PER_BLOCK)
    if not dropout:
        model = dataclasses.replace(model, text_encoder_dropout=0.0)
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, batch_size=DDP_BATCH, num_train_epochs=1, **train))


def _ddp_data(cfg, steps, **kw):
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    return SyntheticDataset(n=cfg.train.batch_size * steps,
                            frames=cfg.model.sample_size,
                            max_seq_length=cfg.model.cmu_seq_len, **kw)


def _train_run(cfg, ds, log_dir, dtype, device="cuda", **kw):
    """Train one epoch with a loss pull every step; returns (the losses
    by step, the seconds of each step after the first, the launches).
    Only rank 0 logs, so other ranks return no losses or times."""
    import torch
    from prompt_tts_tpu_torch.parallel import data_rank
    from prompt_tts_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, ds, log_dir=log_dir, device=device, dtype=dtype,
                      log_every=1, **kw)
    torch.cuda.synchronize()
    zero_counts()
    trainer.train()
    torch.cuda.synchronize()
    launches = counts()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if data_rank() != 0:
        return {}, [], launches
    losses = _logged(log_dir, "Loss/train")
    step_s = [cfg.train.batch_size / v for v in
              _logged(log_dir, "examples_per_s").values()]
    return losses, step_s, launches


def _grad_step(cfg, ds, log_dir, device):
    """One f32 step of a fresh trainer on the dataset's first global
    batch, TF32 off: (the loss, the flat gradient ``apply_gradients``
    received, after DDP's all-reduce under a process group, the step's
    seconds)."""
    import torch
    from prompt_tts_tpu_torch.pipeline import full_f32
    from prompt_tts_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, ds, log_dir=log_dir, device=device)
    grads = []
    apply = trainer.state.apply_gradients

    def snapshot():
        grads.append(torch.cat([p.grad.flatten()
                                for p in trainer.state.params]))
        return apply()
    trainer.state.apply_gradients = snapshot
    batch = next(ds.batches(cfg.train.batch_size))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with full_f32():
        loss = float(trainer.train_step(batch)["loss"])
    step_s = time.perf_counter() - t0
    del trainer
    return loss, grads[0], step_s


def phase_ddp_nccl(smi, tmp):
    """``parallel.init_distributed`` over NCCL at world size 1 in this
    process, then the flagship's widths at ``DDP_LAYERS_PER_BLOCK``, bf16,
    batch 32, 3 steps
    through ``Trainer`` under DDP, against the plain one-process trainer
    twice (the second run gives the card's own noise floor): DDP's loss gap
    at most 2x the floor + 1e-6, kernels #1 and #2 launched under DDP.
    Then the prompt family at full width, 2 steps at batch 4 under DDP
    with the condition drop: DDP without an unused-parameter search raises
    at the second step if a parameter went unreached.  Returns the
    launches under DDP."""
    import torch
    import torch.distributed as dist
    from prompt_tts_tpu_torch.parallel import data_size, init_distributed
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _ddp_config()
    ds = _ddp_data(cfg, DDP_STEPS)
    env = {"PTTS_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "PTTS_NUM_PROCESSES": "1", "PTTS_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        device = init_distributed("cuda")
        backend, world = dist.get_backend(), data_size()
        ddp, ddp_s, launches = _train_run(
            cfg, ds, os.path.join(tmp, "ddp_nccl"), torch.bfloat16, device)
        pcfg = dataclasses.replace(
            cfg, model=prompt_config(), train=dataclasses.replace(
                cfg.train, batch_size=4, cond_dropout_prob=0.1))
        pds = _ddp_data(pcfg, 2, prompt_frames=pcfg.model.prompt_frames)
        prompt, _, prompt_launches = _train_run(
            pcfg, pds, os.path.join(tmp, "ddp_nccl_prompt"), torch.bfloat16,
            device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    plain, plain_s, _ = _train_run(cfg, ds, os.path.join(tmp, "plain_1"),
                                   torch.bfloat16)
    again, again_s, _ = _train_run(cfg, ds, os.path.join(tmp, "plain_2"),
                                   torch.bfloat16)
    steps = sorted(plain)
    gap = max(abs(ddp[s] - plain[s]) for s in steps)
    floor = max(abs(again[s] - plain[s]) for s in steps)
    checks = {
        "nccl_world_1": backend == "nccl" and world == 1,
        "steps": sorted(ddp) == sorted(again) == steps == list(
            range(1, DDP_STEPS + 1)),
        "finite": all(map(math.isfinite, list(ddp.values())
                          + list(prompt.values()))),
        "ddp_within_noise": gap <= 2 * floor + 1e-6,
        "launched": launches["attention_fwd"] > 0
        and launches["attention_bwd"] > 0,
        "prompt_two_steps": sorted(prompt) == [1, 2],
    }
    emit({"phase": "ddp_nccl", "what": f"Trainer under DDP over NCCL, world "
          f"size 1: ModelConfig() widths at {DDP_LAYERS_PER_BLOCK} layer a "
          f"block, bf16 batch {DDP_BATCH}, {DDP_STEPS} steps, "
          f"against the plain trainer twice; the prompt family under DDP, "
          f"batch 4, 2 steps", "checks": checks,
          "loss": {"ddp": ddp, "plain": plain, "plain_again": again,
                   "prompt_ddp": prompt},
          "ddp_gap": gap, "noise_floor": floor,
          "step_s": {"ddp": ddp_s, "plain": plain_s + again_s},
          "launches": launches, "prompt_launches": prompt_launches,
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"ddp_nccl checks failed: {checks}")
    return {k: launches[k] + prompt_launches[k] for k in KERNELS}


def ddp_rank_main(out):
    """One rank of :func:`phase_ddp_two_ranks` (a process of its own,
    started with the ``PTTS_*`` variables): gloo, since both ranks share
    the one card.  The f32 step's gradient (rank 0 saves it), then three
    bf16 steps replicated (rank 0 writes the checkpoint) and with
    ``per_process_data``; its results go to ``rank<r>.json``."""
    import torch
    from prompt_tts_tpu_torch.parallel import (
        barrier, data_rank, init_distributed,
    )
    device = init_distributed("cuda", backend="gloo")
    rank = data_rank()
    res = {"rank": rank, "device": str(device),
           "backend": torch.distributed.get_backend()}
    zero_counts()
    f32 = _ddp_config(dropout=False)
    res["f32_loss"], grad, res["f32_step_s"] = _grad_step(
        f32, _ddp_data(f32, 1), os.path.join(out, f"f32_{rank}"), device)
    if rank == 0:
        torch.save(grad.cpu(), os.path.join(out, "grad.pt"))
    del grad
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = _ddp_config(dropout=False)
    ds = _ddp_data(bf16, DDP_STEPS)
    for mode in ("replicated", "per_process"):
        per = mode == "per_process"
        losses, step_s, _ = _train_run(
            bf16, ds, os.path.join(out, f"{mode}_{rank}"), torch.bfloat16,
            device, per_process_data=per,
            ckpt_dir=None if per else os.path.join(out, "ckpt"))
        res[mode] = {"losses": losses, "step_s": step_s}
    res["launches"] = counts()
    barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn_ranks(argv, n, env, cwd):
    """``n`` processes of ``argv``, ``PTTS_PROCESS_ID`` 0 .. n-1."""
    return [subprocess.Popen(argv, cwd=cwd, env=dict(
        env, PTTS_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


def _reap(procs, timeout, what):
    """Wait for ``procs`` (those still running at ``timeout`` are killed);
    raise naming each that failed; their logs."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise AssertionError(f"{what}: " + "\n".join(failed))
    return logs


def phase_ddp_two_ranks(smi, tmp):
    """Two processes on the one card over gloo (``ddp_rank_main``), the
    flagship's widths at ``DDP_LAYERS_PER_BLOCK``, global batch 32 (16 a
    rank), the text encoder's dropout off so that the ranks draw what one
    process draws:
    one f32 step (TF32 off) whose all-reduced gradient and loss are held
    to this process's one-process step on the same 32 rows (relative
    1e-4 and 1e-5), and three bf16 steps replicated and with
    ``per_process_data``, finite and within 2e-2 of the one-process run;
    rank 0's checkpoint read back here through ``read_model_state``.  The
    step times are gloo's on one card: the gradients' all-reduce goes
    through host memory.  Returns the ranks' launches."""
    import torch
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "two_ranks")
    os.makedirs(out)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PTTS_COORDINATOR=f"127.0.0.1:{_free_port()}",
               PTTS_NUM_PROCESSES=str(DDP_RANKS),
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    _reap(_spawn_ranks([sys.executable, "-c", f"import chip_smoke; "
                        f"chip_smoke.ddp_rank_main({out!r})"],
                       DDP_RANKS, env, here), 600, "ddp_two_ranks")
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    f32 = _ddp_config(dropout=False)
    loss1, g1, one_f32_s = _grad_step(f32, _ddp_data(f32, 1),
                                      os.path.join(tmp, "f32_one"), "cuda")
    g2 = torch.load(os.path.join(out, "grad.pt")).to(g1.device)
    grad_gap = float(torch.linalg.vector_norm(g2 - g1)
                     / torch.linalg.vector_norm(g1))
    del g1, g2
    gc.collect()
    torch.cuda.empty_cache()
    loss2 = ranks[0]["f32_loss"]
    loss_gap = abs(loss2 - loss1) / abs(loss1)
    bf16 = _ddp_config(dropout=False)
    one, one_s, _ = _train_run(bf16, _ddp_data(bf16, DDP_STEPS),
                               os.path.join(tmp, "bf16_one"),
                               torch.bfloat16)
    gaps = {}
    for mode in ("replicated", "per_process"):
        got = {int(k): v for k, v in ranks[0][mode]["losses"].items()}
        gaps[mode] = max(abs(got[s] - one[s]) / abs(one[s]) for s in one)
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    sd, step = ckpt.read_model_state()
    model = TTSSingleSpeaker(bf16.model, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    checks = {
        "gloo_on_one_card": all(r["backend"] == "gloo"
                                and r["device"] == "cuda:0" for r in ranks),
        "f32_grad_rel_gap": grad_gap <= DDP_F32_GRAD_RTOL,
        "f32_loss_rel_gap": loss_gap <= DDP_F32_LOSS_RTOL,
        "f32_loss_same_on_ranks": ranks[0]["f32_loss"]
        == ranks[1]["f32_loss"],
        "bf16_finite": all(math.isfinite(v) for r in ranks
                           for m in gaps for v in r[m]["losses"].values()),
        "bf16_steps": all(len(ranks[0][m]["losses"]) == DDP_STEPS
                          for m in gaps) and sorted(one) == list(
                              range(1, DDP_STEPS + 1)),
        "bf16_within": all(g <= DDP_BF16_LOSS_RTOL for g in gaps.values()),
        "checkpoint_read": step == DDP_STEPS and all(
            bool(torch.isfinite(v).all()) for v in sd.values()
            if v.is_floating_point()),
        "launched": all(r["launches"]["attention_fwd"] > 0
                        and r["launches"]["attention_bwd"] > 0
                        for r in ranks),
    }
    emit({"phase": "ddp_two_ranks", "what": f"{DDP_RANKS} processes on one "
          f"card over gloo, ModelConfig() global batch {DDP_BATCH}, dropout "
          f"off: one f32 step (TF32 off) against one process, {DDP_STEPS} "
          f"bf16 steps replicated and per_process_data", "checks": checks,
          "f32": {"grad_rel_gap": grad_gap, "loss_rel_gap": loss_gap,
                  "loss_two_ranks": loss2, "loss_one": loss1,
                  "step_s_two_ranks": [r["f32_step_s"] for r in ranks],
                  "step_s_one": one_f32_s},
          "bf16": {"loss_rel_gap": gaps, "loss_one": one,
                   "losses_two_ranks": {m: ranks[0][m]["losses"]
                                        for m in gaps},
                   "step_s_two_ranks": {m: ranks[0][m]["step_s"]
                                        for m in gaps},
                   "step_s_one": one_s},
          "ranks_s": ranks_s, "checkpoint_step": step,
          "launches": [r["launches"] for r in ranks],
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"ddp_two_ranks checks failed: {checks}")
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}


TP_RANKS = 2
TP_BATCH = 4
# the depth of the tp and sp phases' cases (ModelConfig() has 2): their
# widths are the flagship's, and their walls are gloo's, not the model's
TP_LAYERS_PER_BLOCK = 1
# the intra-op threads of each process the tp and sp phases start (8 or 9
# run at once): with torch's default of one a host core they spin against
# each other (NVIDIA H100 80GB HBM3, 700.00 W, 8 host cores, both in one
# call: tp 97.5 s and sp 77.1 s at the default, 64.3 and 56.4 s at 1)
CHILD_THREADS = "1"
TP_STEPS = 3
TP_SYNTH_STEPS = 10
# requests of the tp phase's synthesis: the batch its kernel #1 calls see
TP_SYNTH_BATCH = 2
TP_SERVE_STEPS = 5
# Two gloo ranks sharing the card against one process on it, the same
# weights and inputs; every row-parallel product is summed in two halves
# and the resnet blocks run the module arithmetic (kernel #6 is not on
# the tp > 1 path), so the f32 gaps are rounding's (TF32 off): the model's
# forward 1e-4 in relative Frobenius norm, each step's loss 1e-5 relative
# (DDP_F32_LOSS_RTOL) and so is each step's global gradient norm, the
# first step's gradient 1e-5 relative over the whole model (the CPU
# tests' RANKS_GRAD_RTOL) and each tensor's 1e-4 of its own norm plus
# ZERO_GRAD of the whole gradient's (a tensor whose gradient is zero in
# exact arithmetic, a bias in front of a GroupNorm, is rounding noise on
# both sides), the whole update after 3 steps 1e-2 relative (the CPU
# tests' UPDATE_RTOL), the synthesis latents 2e-4 (JAX's own TP
# tolerance, tests/test_tp.py) with codes agreeing in more than 99 % of
# places.  bf16 rounds each half: the forward and the latents 3e-2
# relative (RESNET_TOL_BF16's scale) and so is the first step's whole
# gradient, each tensor's gradient 0.1 of its norm (plus ZERO_GRAD of the
# whole's), the losses and the gradient norms 2e-2 (DDP_BF16_LOSS_RTOL),
# the update 5e-2.  (On an H100: f32 gradients 1.3e-6 whole, 3.3e-6 in
# the worst tensor; bf16 8.7e-3 and 2.3e-2.)  The
# AdamW update moves each element by about lr * sign(g) whatever the
# gradient's scale, so the gradients are held, not only the update.
TP_F32_FWD_RTOL = 1e-4
TP_F32_LOSS_RTOL = 1e-5
TP_F32_GRAD_RTOL, TP_F32_TENSOR_GRAD_RTOL = 1e-5, 1e-4
TP_F32_UPDATE_RTOL = 1e-2
TP_F32_LATENT_ATOL = 2e-4
TP_CODE_AGREE = 0.99
TP_BF16_FWD_RTOL = 3e-2
TP_BF16_LOSS_RTOL = 2e-2
TP_BF16_GRAD_RTOL, TP_BF16_TENSOR_GRAD_RTOL = 3e-2, 0.1
TP_BF16_UPDATE_RTOL = 5e-2
# cli.serve --tp 2 (f32, DDIM-5, batch 1) against the one-process
# server: a flipped code (JAX's contract allows 1 %) changes the decode
# from its frame on, so the PCM is held in relative Frobenius norm, to
# half the gap between two different requests' PCM (the same text at two
# seeds: 1.03 on an H100) and at most 0.1 (sound runs: 0.018-0.040), and
# at least half of each answer's samples are bit-equal to the one
# process's (sound runs: 0.86-0.97); the same text at two seeds is the
# control, its gap and equal share printed beside them
TP_SERVE_PCM_RTOL = 0.1
TP_SERVE_EQUAL_SHARE = 0.5
# more cli.serve arguments (none: ModelConfig() on the card)
TP_SERVE_ARGV = []
TP_SERVE_REQUESTS = [(TEXTS[0], 3)] + [(TEXTS[i % len(TEXTS)], 20 + i)
                                       for i in range(4)]


def _tp_config():
    """``ModelConfig()`` at full width and ``TP_LAYERS_PER_BLOCK`` layers a
    block, with the text encoder's dropout off (the ranks and one process
    then draw alike), the tp phase's batch."""
    from prompt_tts_tpu_torch.config import Config
    cfg = Config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, text_encoder_dropout=0.0,
            layers_per_block=TP_LAYERS_PER_BLOCK),
        train=dataclasses.replace(cfg.train, batch_size=TP_BATCH,
                                  num_train_epochs=1))


def _tp_state(cfg):
    """The full-width weights every rank and the one process start from,
    drawn on the CPU from a seed."""
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.pipeline import random_init_
    import torch
    return random_init_(TTSSingleSpeaker(cfg.model),
                        torch.Generator().manual_seed(5)).state_dict()


def _tp_case(device, dtype, cfg, state, log_dir):
    """One model forward on the first batch at fixed timesteps, 3 train
    steps from ``state`` (the losses, the gradient norms, the first step's
    gradients and the update's squares by tensor, of this rank's slices),
    then a DDIM-10 synthesis of 2 requests (latents, then the decode:
    codes): what this process computes, sharded or not."""
    import torch
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.parallel import model_rank, model_size
    from prompt_tts_tpu_torch.parallel.tp import shard_state
    from prompt_tts_tpu_torch.pipeline import Synthesizer, full_f32
    from prompt_tts_tpu_torch.train.loop import Trainer
    f32 = dtype == torch.float32
    scope = full_f32 if f32 else contextlib.nullcontext
    out = {}
    ds = SyntheticDataset(n=TP_BATCH * TP_STEPS, frames=cfg.model.sample_size,
                          max_seq_length=cfg.model.cmu_seq_len)
    tr = Trainer(cfg, ds, log_dir=log_dir, device=device, dtype=dtype,
                 init_state=state, log_every=1)
    batch = next(ds.batches(TP_BATCH))
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    t = torch.tensor([0, 250, 500, 999], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), scope():
        tr.model.eval()
        out["forward"] = tr.model(b["codes"], t, b["text_ids"],
                                  b["text_mask"]).float().cpu()
    torch.cuda.synchronize()
    out["forward_s"] = time.perf_counter() - t0
    losses, norms, step_s, grads = [], [], [], []
    apply = tr.state.apply_gradients

    def snapshot():     # the first step's gradients, before the clip
        if not grads:
            grads.append({n: p.grad.detach().cpu() for n, p in
                          zip(tr.state.names, tr.state.params)})
        return apply()
    tr.state.apply_gradients = snapshot
    with scope():
        for bt in ds.batches(TP_BATCH):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(bt)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
    init = shard_state(state, model_rank(), model_size())
    out.update(losses=losses, grad_norms=norms, step_s=step_s,
               grad=grads[0], update_sq={n: float(((p.detach().float().cpu()
                                     - init[n].float()) ** 2).sum())
                          for n, p in tr.model.named_parameters()},
               sharded=[n for n, p in tr.model.named_parameters()
                        if hasattr(p, "tp_dim")])
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    synth = Synthesizer(config=cfg, device=device, dtype=dtype,
                        num_inference_steps=TP_SYNTH_STEPS,
                        model_state=state)
    ids, mask = synth.tokenizer.encode_batch(TEXTS[:TP_SYNTH_BATCH])
    x_T = synth.noise(7, TP_SYNTH_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = synth.denoise_latents(
        x_T.to(device), torch.from_numpy(ids).to(device),
        torch.from_numpy(mask).to(device))
    _, codes = synth.finish_program(False)(latents)
    torch.cuda.synchronize()
    out["synth_s"] = time.perf_counter() - t0
    out["latents"] = latents.float().cpu()
    out["codes"] = codes.cpu().numpy()
    out["tp"], out["sp"] = synth.tp, synth.sp
    del synth
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _recording_heads():
    """Record the head count of every launch of kernels #1 and #2 (their
    modules' ``_launch``, which each wrapper calls where it launches), by
    kernel; the wrappers and their counts are untouched."""
    from prompt_tts_tpu_torch.ops.cuda import attention, attention_bwd
    heads = {"attention_fwd": set(), "attention_bwd": set()}
    mods = {"attention_fwd": attention, "attention_bwd": attention_bwd}
    orig = {k: m._launch for k, m in mods.items()}

    def recording(key):
        def launch(q, *a):
            heads[key].add(q.shape[2])
            return orig[key](q, *a)
        return launch
    for k, m in mods.items():
        m._launch = recording(k)
    try:
        yield heads
    finally:
        for k, m in mods.items():
            m._launch = orig[k]


def tp_rank_main(out):
    """One rank of :func:`phase_tp` (a process of its own, started with
    the ``PTTS_*`` variables): gloo, since both ranks share the one card,
    a model axis of 2; both dtypes of :func:`_tp_case`; its results go to
    ``rank<r>.pt``."""
    import torch
    from prompt_tts_tpu_torch.parallel import (
        barrier, init_distributed, model_rank, model_size, world_rank,
    )
    device = init_distributed(DEVICE, backend="gloo", n_model=TP_RANKS)
    rank = world_rank()
    res = {"rank": rank, "device": str(device),
           "backend": torch.distributed.get_backend(),
           "model": (model_rank(), model_size())}
    cfg = _tp_config()
    state = _tp_state(cfg)
    zero_counts()
    with _recording_heads() as heads:
        for name, dtype in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
            res[name] = _tp_case(device, dtype, cfg, state,
                                 os.path.join(out, f"{name}_{rank}"))
    res["launches"] = counts()
    res["heads"] = {k: sorted(v) for k, v in heads.items()}
    barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _rel_gap(a, b):
    import torch
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def _grad_gaps(got, one, tensor_rtol, b=None, replicated=()):
    """A whole gradient ``got`` against one process's ``one``: (the
    relative gap over the whole model, the tensors whose gap exceeds
    ``tensor_rtol`` of their own norm plus ZERO_GRAD of the whole's with
    their gaps, the largest such gap by tensor's norm, and the largest gap
    between the ``replicated`` tensors of ``got`` and of another rank's
    ``b``)."""
    import torch
    one = {n: g.float() for n, g in one.items()}

    def norm(t):
        return float(torch.linalg.vector_norm(t.float()))
    whole = math.sqrt(sum(norm(g) ** 2 for g in one.values()))
    diff = {n: norm(got[n].float() - one[n]) for n in one}
    whole_gap = math.sqrt(sum(d ** 2 for d in diff.values())) / whole
    floor = ZERO_GRAD * whole
    rel = {n: diff[n] / max(norm(one[n]), floor) for n in one}
    over = {n: rel[n] for n in one
            if diff[n] > tensor_rtol * norm(one[n]) + floor}
    ranks = max((norm(got[n].float() - b[n].float())
                 / max(norm(one[n]), floor) for n in replicated), default=0.0)
    return whole_gap, over, max(rel.values()), ranks


def _tp_grads(a, b, o, tensor_rtol):
    """The first step's gradients of the ranks ``a`` and ``b``, gathered,
    against one process's ``o`` (:func:`_grad_gaps`, the ranks' replicated
    tensors compared)."""
    from prompt_tts_tpu_torch.parallel.tp import gather_state
    tp = gather_state([a["grad"], b["grad"]],
                      {n: g.shape for n, g in o["grad"].items()})
    return _grad_gaps(tp, o["grad"], tensor_rtol, a["grad"],
                      [n for n in o["grad"] if n not in a["sharded"]])


def _tp_hold(name, ranks, one):
    """The checks and figures of one dtype: the ranks against each other
    and against one process."""
    import torch
    f32 = name == "f32"
    a, b = (r[name] for r in ranks)
    o = one[name]
    grad_gap, grad_over, tensor_gap, ranks_grad_gap = _tp_grads(
        a, b, o, TP_F32_TENSOR_GRAD_RTOL if f32 else TP_BF16_TENSOR_GRAD_RTOL)
    norm_gap = max(abs(x - y) / y for x, y in zip(a["grad_norms"],
                                                  o["grad_norms"]))
    upd_tp = math.sqrt(sum(a["update_sq"][n] + (b["update_sq"][n]
                                                 if n in a["sharded"] else 0)
                           for n in a["update_sq"]))
    upd_one = math.sqrt(sum(o["update_sq"].values()))
    fwd_gap = _rel_gap(a["forward"], o["forward"])
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       o["losses"]))
    lat_gap = (float((a["latents"] - o["latents"]).abs().max()) if f32
               else _rel_gap(a["latents"], o["latents"]))
    agree = float((a["codes"] == o["codes"]).mean())
    figures = {"forward_rel_gap": fwd_gap, "loss_rel_gap": loss_gap,
               "losses": {"tp2": a["losses"], "one": o["losses"]},
               "grad_norm": {"tp2": a["grad_norms"], "one": o["grad_norms"]},
               "grad_norm_rel_gap": norm_gap, "grad_rel_gap": grad_gap,
               "grad_tensor_rel_gap_max": tensor_gap,
               "grad_tensors_over": grad_over,
               "grad_replicated_ranks_gap": ranks_grad_gap,
               "update_norm": {"tp2": upd_tp, "one": upd_one},
               "latent_gap": lat_gap, "code_agreement": agree,
               "walls_s": {"tp2": {k: a[k] for k in ("forward_s", "step_s",
                                                     "synth_s")},
                           "one": {k: o[k] for k in ("forward_s", "step_s",
                                                     "synth_s")}}}
    checks = {
        f"{name}_ranks_agree": torch.equal(a["forward"], b["forward"])
        and a["losses"] == b["losses"]
        and torch.equal(a["latents"], b["latents"]),
        f"{name}_sharded": a["tp"] == 2 and len(a["sharded"]) > 0,
        f"{name}_forward": fwd_gap <= (TP_F32_FWD_RTOL if f32
                                       else TP_BF16_FWD_RTOL),
        f"{name}_losses": loss_gap <= (TP_F32_LOSS_RTOL if f32
                                       else TP_BF16_LOSS_RTOL),
        f"{name}_grad_norms": norm_gap <= (TP_F32_LOSS_RTOL if f32
                                           else TP_BF16_LOSS_RTOL),
        f"{name}_grads": grad_gap <= (TP_F32_GRAD_RTOL if f32
                                      else TP_BF16_GRAD_RTOL)
        and not grad_over and ranks_grad_gap <= (
            TP_F32_TENSOR_GRAD_RTOL if f32 else TP_BF16_TENSOR_GRAD_RTOL),
        f"{name}_update": abs(upd_tp - upd_one) / upd_one <= (
            TP_F32_UPDATE_RTOL if f32 else TP_BF16_UPDATE_RTOL),
        f"{name}_latents": lat_gap <= (TP_F32_LATENT_ATOL if f32
                                       else TP_BF16_FWD_RTOL),
    }
    if f32:
        checks["f32_codes"] = agree > TP_CODE_AGREE
    return checks, figures


def _tp_attention(smi):
    """Kernels #1 and #2 at the tp 2 path's local head counts (4 of the
    UNet's 8 heads, 6 of the text encoder's 12), f32 and bf16, against
    their plain versions at the kernel phases' tolerances: the forward
    with the lse and the backward at the train steps' B=4 (``_hold_call``;
    the text mask's bias takes no gradient, as on the path), the forward
    alone at the synthesis's B=2 (``_fwd_check``).  Checked, not timed.
    Returns the errors by case; raises if one misses."""
    import torch
    from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
    from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
    g = torch.Generator("cuda").manual_seed(17)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, Tq, Tk, H, D, masked, _ in attn_cases():
            H //= TP_RANKS
            label = f"{label} H={H}"
            q, k, v, bias = attn_inputs(g, TP_BATCH, Tq, Tk, H, D, masked,
                                        dtype)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            with torch.no_grad():
                o, lse = flash_attention(q, k, v, bias, return_lse=True)
            grads = attention_bwd(q, k, v, o, do, bias, lse,
                                  need_dbias=False)
            train, tok = _hold_call(q, k, v, bias, o, lse, do, grads)
            q, k, v, bias = attn_inputs(g, TP_SYNTH_BATCH, Tq, Tk, H, D,
                                        masked, dtype)
            with torch.no_grad():
                out = flash_attention(q, k, v, bias)
                err, fro, sok = _fwd_check(out, q, k, v, bias)
            res[f"{dname} {label}"] = r = {
                f"B={TP_BATCH} fwd+lse+bwd": train,
                f"B={TP_SYNTH_BATCH} fwd": {"max_abs_err": err,
                                            "fro_err": fro}}
            emit({"phase": "kernel", "kernel": "attention_fwd+bwd",
                  "case": f"tp {TP_RANKS} local heads: {label}",
                  "dtype": dname, **r, "tol": {"fwd": _fwd_tol(dtype),
                                               "bwd": _bwd_tol(dtype)},
                  "ok": tok and sok, "card": smi})
            if not (tok and sok):
                raise AssertionError(f"attention at tp {TP_RANKS}'s local "
                                     f"heads, {label} {dname}: {r}")
            del q, k, v, bias, do, o, lse, grads, out
    return res


def _tp_nccl_train_start(tmp, here):
    """Start ``cli.train --multihost --tp 1 --backend nccl --smoke`` on
    ``TINY`` under ``torchrun --standalone --nproc_per_node 1`` (the
    launcher's variables, NCCL at world size 1): (the config, its path,
    the process)."""
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    cfg = Config(model=ModelConfig(**TINY),
                 train=TrainConfig(batch_size=8, num_train_epochs=1,
                                   learning_rate=1e-3, lr_warmup_steps=0))
    cfg_path = os.path.join(tmp, "tp_tiny.json")
    cfg.to_json(cfg_path)
    env = dict(os.environ, OMP_NUM_THREADS=CHILD_THREADS,
               PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "prompt_tts_tpu_torch.cli.train",
         "--multihost", "--tp", "1", "--backend", "nccl", "--smoke",
         "--device", DEVICE, "--config_file", cfg_path, "--log_every", "1",
         "--log_dir", os.path.join(tmp, "tp_nccl_log"), "--ckpt_dir",
         os.path.join(tmp, "tp_nccl_ckpt")],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return cfg, cfg_path, proc


def _tp_cli_nccl(tmp, cfg, cfg_path, train):
    """The ``cli.train`` of :func:`_tp_nccl_train_start` (``train``) to its
    end, then ``cli.synthesize --multihost --tp 1`` over NCCL at world size
    1 in this process on its checkpoint: rank 0's checkpoint, the groups
    released, and codes bit-equal to an in-process ``Synthesizer`` on the
    checkpoint's state.  Returns (checks, the synthesis's launches)."""
    import numpy as np
    import torch
    from prompt_tts_tpu_torch.cli import synthesize as synth_cli
    from prompt_tts_tpu_torch.cli._common import restore_model_state
    from prompt_tts_tpu_torch.pipeline import Synthesizer
    ckpt, log_dir = (os.path.join(tmp, "tp_nccl_ckpt"),
                     os.path.join(tmp, "tp_nccl_log"))
    _reap([train], 300, "torchrun cli.train over NCCL")
    env = {"PTTS_NUM_PROCESSES": "1", "PTTS_PROCESS_ID": "0",
           "PTTS_COORDINATOR": f"127.0.0.1:{_free_port()}"}
    try:
        os.environ.update(env)
        zero_counts()
        _, _, codes = synth_cli.main(
            ["--multihost", "--tp", "1", "--device", DEVICE,
             "--config_file", cfg_path,
             "--ckpt_dir", ckpt, "--steps", "10", "--text", TEXTS[0],
             "--text", TEXTS[1], "--out", os.path.join(tmp, "tp_nccl.wav")])
        torch.cuda.synchronize()
        launches = counts()
        backend_ok = not torch.distributed.is_initialized()
    finally:
        for k in env:
            os.environ.pop(k, None)
    state, step = restore_model_state(ckpt, cfg)
    ref = Synthesizer(config=cfg, device=DEVICE, num_inference_steps=10,
                      model_state=state)
    _, ref_codes = ref.synthesize(TEXTS[:2], return_codes=True)
    losses = _logged(log_dir, "Loss/train")
    checks = {"nccl_cli_train_torchrun": step == 2
              and sorted(losses) == [1, 2]
              and all(map(math.isfinite, losses.values())),
              "nccl_groups_released": backend_ok,
              "nccl_cli_synthesize_bits": np.array_equal(codes, ref_codes),
              "nccl_cli_synthesize_wavs": all(os.path.exists(os.path.join(
                  tmp, f"tp_nccl_{i}.wav")) for i in range(2))}
    return checks, launches


def _serve_pcm(port, requests):
    """One request alone, then the rest at once: {request: PCM}."""
    import threading
    import numpy as np
    out = {}

    def post(r):
        status, body, _ = _http(port, "POST", "/synthesize",
                                {"text": r[0], "seed": r[1]})
        if status != 200:
            raise AssertionError(f"serve {r}: {status} {body[:200]!r}")
        out[r] = np.frombuffer(_wav_pcm(body), "<i2")
    post(requests[0])
    threads = [threading.Thread(target=post, args=(r,))
               for r in requests[1:]]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return out


def _tp_serve_argv():
    return ["--steps", str(TP_SERVE_STEPS), "--max_batch", "1", "--dtype",
            "f32", "--device", DEVICE] + TP_SERVE_ARGV


def _tp_serve_start(here, env, flag="--tp"):
    """Start ``cli.serve --multihost --tp 2 --backend gloo`` (or ``flag``
    ``--sp``) as two processes on the card (f32, DDIM-5, batch 1,
    ``ModelConfig()``): (the processes, rank 0's port, the start time)."""
    port = _free_port()
    procs = _spawn_ranks(
        [sys.executable, "-m", "prompt_tts_tpu_torch.cli.serve",
         "--multihost", flag, "2", "--backend", "gloo", "--port",
         str(port)] + _tp_serve_argv(),
        TP_RANKS, dict(env, PTTS_COORDINATOR=f"127.0.0.1:{_free_port()}"),
        here)
    return procs, port, time.perf_counter()


def _tp_serve(procs, port, t0, one_pcm=None, what="tp serve"):
    """The servers of :func:`_tp_serve_start`, once rank 0 answers: one
    request and a wave of 4 over HTTP, held against the one-process
    server in this process (run here unless ``one_pcm`` gives its PCM);
    SIGTERM to rank 0, whose drain releases rank 1.  Returns (checks,
    figures, the one-process PCM)."""
    import signal
    import numpy as np
    argv = _tp_serve_argv()
    try:
        deadline = time.monotonic() + 300
        while True:
            if any(p.poll() is not None for p in procs):
                _reap(procs, 10, what)
            try:
                if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: rank 0 never answered")
            time.sleep(0.5)
        # from the start to rank 0's first answer, beside (a) and (b)
        ready_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_pcm = _serve_pcm(port, TP_SERVE_REQUESTS)
        tp_s = time.perf_counter() - t0
        procs[0].send_signal(signal.SIGTERM)
        logs = _reap(procs, 120, what)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one_s = None
    if one_pcm is None:
        server, sport, thread = _start_server(["--port", "0"] + argv)
        try:
            t0 = time.perf_counter()
            one_pcm = _serve_pcm(sport, TP_SERVE_REQUESTS)
            one_s = time.perf_counter() - t0
        finally:
            _stop_server(server, thread)
    import torch
    def gap(x, y):      # a length that differs fails the check
        if len(x) != len(y):
            return math.inf
        return _rel_gap(torch.from_numpy(x.astype(np.float32)),
                        torch.from_numpy(y.astype(np.float32)))
    gaps = {f"{t[:12]}|{s}": gap(tp_pcm[(t, s)], one_pcm[(t, s)])
            for t, s in TP_SERVE_REQUESTS}
    # the same text at two seeds: how far apart two answers lie
    a, b = (one_pcm[r].astype(np.float32) for r in TP_SERVE_REQUESTS[:2])
    n_ab = min(len(a), len(b))
    apart = _rel_gap(torch.from_numpy(a[:n_ab]), torch.from_numpy(b[:n_ab]))
    apart_equal = float((a[:n_ab] == b[:n_ab]).mean())
    equal = {k: float((tp_pcm[r] == one_pcm[r]).mean())
             if len(tp_pcm[r]) == len(one_pcm[r]) else 0.0
             for k, r in zip(gaps, TP_SERVE_REQUESTS)}
    # the warmup's 2 denoises and one a request (or a window of one)
    followed = re.findall(r"rank 0 shut down after (\d+) denoises", logs[1])
    checks = {"serve_pcm": all(g <= min(TP_SERVE_PCM_RTOL, apart / 2)
                               for g in gaps.values()),
              "serve_equal_share": all(e >= TP_SERVE_EQUAL_SHARE
                                       for e in equal.values()),
              "serve_drained": "drained; exiting" in logs[0],
              "serve_followed": bool(followed) and int(followed[0])
              >= 2 + len(TP_SERVE_REQUESTS)}
    return checks, {"pcm_rel_gap": gaps, "two_requests_rel_gap": apart,
                    "two_requests_equal_share": apart_equal,
                    "denoises_followed": followed,
                    "equal_share": equal, "ready_s": ready_s,
                    "requests_s": {"ranks": tp_s, "one": one_s}}, one_pcm


def phase_tp(smi, tmp):
    """Tensor parallelism on one card: (a) two processes sharing it over
    gloo at ``--tp 2`` (``tp_rank_main``), ``ModelConfig()`` at full
    width, f32 (TF32 off) and bf16: one model forward, 3 train steps at
    B=4, a DDIM-10 synthesis of 2 requests, each held against this
    process's unsharded program on the same weights and inputs, kernels #1
    and #2 launched at the local head counts (4 of the UNet's 8, 6 of the
    text encoder's 12) on every rank and #6 not at all (a sharded block
    runs the module arithmetic), and both kernels held against their plain
    versions at those heads and the path's batches (``_tp_attention``);
    (b) ``cli.train --multihost --tp 1`` over NCCL under ``torchrun
    --standalone --nproc_per_node 1`` (started with the phase), then
    ``cli.synthesize --multihost --tp 1`` over NCCL at world size 1 here;
    (c) ``cli.serve --tp 2`` as two gloo processes against the
    one-process server.  A gather is an all-reduce of a zero-filled whole
    buffer (exact).  Times are gloo's on one card, through host memory:
    not a multi-card figure.  Returns the launches summed over the ranks, and
    the one-process references (the cases' results, the server's PCM),
    which :func:`phase_sp` holds its ranks to."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "tp_ranks")
    os.makedirs(out)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PTTS_NUM_PROCESSES=str(TP_RANKS),
               OMP_NUM_THREADS=CHILD_THREADS, PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # the servers of (c) and the train of (b) start first: their start-up
    # overlaps (a)
    serve_procs = _tp_serve_start(here, env)
    nccl_train = None
    try:
        nccl_train = _tp_nccl_train_start(tmp, here)
        return _tp_checked(smi, tmp, out, here, env, serve_procs, nccl_train,
                           t_phase)
    finally:
        for p in serve_procs[0] + ([nccl_train[2]] if nccl_train else []):
            if p.poll() is None:
                p.kill()
                p.wait()


def _tp_checked(smi, tmp, out, here, env, serve_procs, nccl_train, t_phase):
    """The body of :func:`phase_tp`, with (c)'s servers and (b)'s train
    started."""
    import torch
    from prompt_tts_tpu_torch.pipeline import full_f32
    t0 = time.perf_counter()
    procs = _spawn_ranks(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.tp_rank_main({out!r})"],
        TP_RANKS, dict(env, PTTS_COORDINATOR=f"127.0.0.1:{_free_port()}"),
        here)
    try:
        # the unsharded references meanwhile, on the same card
        cfg = _tp_config()
        state = _tp_state(cfg)
        with _recording_heads() as one_heads:
            one = {name: _tp_case(DEVICE, dtype, cfg, state,
                                  os.path.join(tmp, f"tp_one_{name}"))
                   for name, dtype in (("f32", torch.float32),
                                       ("bf16", torch.bfloat16))}
        del state
        # the kernels at the ranks' shapes against their plain versions
        with full_f32():
            attention = _tp_attention(smi)
        _reap(procs, 600, "tp ranks")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(TP_RANKS)]
    checks, figures = {}, {}
    for name in ("f32", "bf16"):
        c, figures[name] = _tp_hold(name, ranks, one)
        checks.update(c)
    checks["gloo_on_one_card"] = all(
        r["backend"] == "gloo" and r["device"] == "cuda:0"
        and r["model"] == (i, TP_RANKS) for i, r in enumerate(ranks))
    checks["local_heads"] = all(
        r["heads"] == {"attention_fwd": [4, 6], "attention_bwd": [4, 6]}
        for r in ranks) and one_heads == {"attention_fwd": {8, 12},
                                          "attention_bwd": {8, 12}}
    checks["launched"] = all(
        r["launches"]["attention_fwd"] > 0
        and r["launches"]["attention_bwd"] > 0
        and r["launches"]["resnet"] == 0
        and r["launches"]["lstm_t" if _default_lstm() == "persistent"
                          else "lstm"] > 0 for r in ranks)
    t0 = time.perf_counter()
    c, nccl_launches = _tp_cli_nccl(tmp, *nccl_train)
    checks.update(c)
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, serve, one_pcm = _tp_serve(*serve_procs)
    checks.update(c)
    serve["after_the_ranks_s"] = time.perf_counter() - t0
    emit({"phase": "tp", "what": f"(a) {TP_RANKS} processes on one card "
          f"over gloo at --tp 2, ModelConfig() at {TP_LAYERS_PER_BLOCK} "
          f"layer a block, f32 and bf16: a forward, "
          f"{TP_STEPS} steps at B={TP_BATCH}, DDIM-{TP_SYNTH_STEPS} of 2 "
          f"requests, against one process; (b) cli.train (under torchrun "
          f"--standalone --nproc_per_node 1) and cli.synthesize --multihost "
          f"--tp 1 over NCCL at world size 1; (c) cli.serve "
          f"--tp 2 (f32, DDIM-{TP_SERVE_STEPS}, batch 1) against the "
          f"one-process server", "checks": checks, "figures": figures,
          "local_head_kernels": attention,
          "heads": [r["heads"] for r in ranks],
          "launches": [r["launches"] for r in ranks],
          "nccl_launches": nccl_launches, "serve": serve,
          "ranks_s": ranks_s, "nccl_s": nccl_s,
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"tp checks failed: {checks}")
    return ({k: sum(r["launches"][k] for r in ranks) + nccl_launches[k]
             for k in KERNELS}, {"one": one, "serve_pcm": one_pcm})


SP_RANKS = 2
# the ring at the flagship's self-attention shapes under sp 2: (whole
# frames, head dim) of the 900- and 450-frame levels, 8 heads, each rank
# holding half the frames, at the train steps' batch
SP_RING_SHAPES = ((900, 32), (450, 64))
SP_RING_HEADS = 8
# Two gloo ranks sharing the card at --sp 2 against one process (the tp
# phase's cases, weights and inputs, whose one-process results it hands
# on), held to the tp phase's limits (TP_*; the forecast is in PERF.md §6):
# the sharded levels run the module arithmetic for the resnet blocks, as a
# tp 2 block does, the GroupNorms take their statistics over the group in
# two passes, and the ring merges its blocks' outputs in f32, so the f32
# gaps are rounding's and bf16 adds a rounding of each block's output.
# The ring alone, against its plain version (ring_attention_plain, JAX's
# loop) and against one-process attention (the kernel phases' plain
# versions, at their tolerances, through _hold_call): f32 o and lse
# ATTN_TOL_F32, the gradients BWD_TOL (1 + max|ref|); bf16 every output
# FRO_RTOL_BF16 in relative Frobenius norm against the plain ring.
# cli.train --sp 2 on TINY (f32, cuDNN's default TF32 convolutions on
# both sides, in other orders) against one process: the losses 1e-2
# relative.
SP_CLI_LOSS_RTOL = 1e-2


def _sp_gathered(t, seq, dim=1):
    """The ranks' slices of ``t`` along ``dim`` joined (an exact all-reduce
    of a zero-filled whole buffer: gloo has no all-gather on the card)."""
    from prompt_tts_tpu_torch.parallel import sp
    return sp.gather_time(t.detach().transpose(1, dim), seq).transpose(1, dim)


def _sp_ring_check():
    """Each rank: the ring (kernels #1 and #2 at every step) and its plain
    version on its halves of the same seeded q/k/v/do at
    ``SP_RING_SHAPES``, f32 and bf16; the slices are joined and rank 0
    holds the ring's o, lse, dq, dk and dv against the plain ring and
    against one-process attention.  Returns rank 0's errors by case (None
    on the others); raises on rank 0 if one misses."""
    import torch
    from prompt_tts_tpu_torch.ops.ring_attention import (
        ring_attention, ring_attention_plain,
    )
    from prompt_tts_tpu_torch.parallel import sp
    seq = sp.mesh_seq()
    g = torch.Generator("cuda").manual_seed(23)
    res, ok = {}, True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for T, D in SP_RING_SHAPES:
            q, k, v, _ = attn_inputs(g, TP_BATCH, T, T, SP_RING_HEADS, D,
                                     False, dtype)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            n = T // seq.size

            def mine(t):
                return t[:, seq.rank * n:(seq.rank + 1) * n].contiguous()
            got = {}
            for label, fn in (("ring", ring_attention),
                              ("plain", ring_attention_plain)):
                qq, kk, vv = (mine(t).requires_grad_() for t in (q, k, v))
                o, lse = fn(qq, kk, vv, None, seq, return_lse=True)
                o.backward(mine(do))
                got[label] = {"o": _sp_gathered(o, seq),
                              "lse": _sp_gathered(lse, seq, dim=2),
                              "dq": _sp_gathered(qq.grad, seq),
                              "dk": _sp_gathered(kk.grad, seq),
                              "dv": _sp_gathered(vv.grad, seq)}
            if seq.rank:
                continue
            ring, plain = got["ring"], got["plain"]
            one, one_ok = _hold_call(q, k, v, None, ring["o"], ring["lse"],
                                     do, (ring["dq"], ring["dk"], ring["dv"],
                                          None))
            vs_plain, plain_ok = {}, True
            for key in ("o", "lse", "dq", "dk", "dv"):
                a, b = ring[key].float(), plain[key].float()
                err = (a - b).abs().max().item()
                fro = ((a - b).norm() / b.norm()).item()
                vs_plain[key] = {"max_abs_err": err, "fro_err": fro}
                if dtype == torch.bfloat16:
                    plain_ok = plain_ok and fro <= FRO_RTOL_BF16
                elif key in ("o", "lse"):
                    plain_ok = plain_ok and err <= ATTN_TOL_F32
                else:
                    plain_ok = plain_ok and err <= BWD_TOL * (
                        1.0 + b.abs().max().item())
            case = f"{dname} T={T} H={SP_RING_HEADS} D={D}"
            res[case] = {"vs_one_process": one, "vs_plain_ring": vs_plain,
                         "ok": one_ok and plain_ok}
            ok = ok and one_ok and plain_ok
    if not seq.rank and not ok:
        raise AssertionError(f"ring attention at sp {seq.size}: {res}")
    return res if not seq.rank else None


def sp_rank_main(out):
    """One rank of :func:`phase_sp` (a process of its own, started with
    the ``PTTS_*`` variables): gloo, since both ranks share the one card,
    a seq axis of 2; both dtypes of :func:`_tp_case` (the main path: their
    launches and the levels that rang are read just after), then the ring
    on its own (:func:`_sp_ring_check`); its results go to
    ``rank<r>.pt``."""
    import torch
    from prompt_tts_tpu_torch.parallel import (
        barrier, init_distributed, seq_rank, seq_size, world_rank,
    )
    from prompt_tts_tpu_torch.parallel import sp
    from prompt_tts_tpu_torch.pipeline import full_f32
    entered = time.time()
    device = init_distributed(DEVICE, backend="gloo", n_seq=SP_RANKS)
    rank = world_rank()
    res = {"rank": rank, "device": str(device),
           "backend": torch.distributed.get_backend(),
           "seq": (seq_rank(), seq_size())}
    cfg = _tp_config()
    state = _tp_state(cfg)
    # wall clock stamps: the phase reads the start-up against its launch
    res["entered_at"], res["cases_at"] = entered, time.time()
    zero_counts()
    sp.reset_ring_traces()
    t0 = time.perf_counter()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res[name] = _tp_case(device, dtype, cfg, state,
                             os.path.join(out, f"{name}_{rank}"))
    res["launches"] = counts()
    res["ring_tqs"] = sp.ring_trace_tqs()
    res["cases_s"] = time.perf_counter() - t0
    del state
    t0 = time.perf_counter()
    with full_f32():
        res["ring"] = _sp_ring_check()
    res["ring_s"] = time.perf_counter() - t0
    barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _sp_hold(name, ranks, one):
    """The checks and figures of one dtype: the seq ranks against each
    other (the same bits: each holds the whole output and the averaged
    gradient) and rank 0 against one process, at the tp phase's limits."""
    import torch
    f32 = name == "f32"
    a, b = (r[name] for r in ranks)
    o = one[name]
    grad_gap, grad_over, tensor_gap, _ = _grad_gaps(
        a["grad"], o["grad"],
        TP_F32_TENSOR_GRAD_RTOL if f32 else TP_BF16_TENSOR_GRAD_RTOL)
    norm_gap = max(abs(x - y) / y for x, y in zip(a["grad_norms"],
                                                  o["grad_norms"]))
    upd_sp = math.sqrt(sum(a["update_sq"].values()))
    upd_one = math.sqrt(sum(o["update_sq"].values()))
    fwd_gap = _rel_gap(a["forward"], o["forward"])
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       o["losses"]))
    lat_gap = (float((a["latents"] - o["latents"]).abs().max()) if f32
               else _rel_gap(a["latents"], o["latents"]))
    agree = float((a["codes"] == o["codes"]).mean())
    figures = {"forward_rel_gap": fwd_gap, "loss_rel_gap": loss_gap,
               "losses": {"sp2": a["losses"], "one": o["losses"]},
               "grad_norm": {"sp2": a["grad_norms"], "one": o["grad_norms"]},
               "grad_norm_rel_gap": norm_gap, "grad_rel_gap": grad_gap,
               "grad_tensor_rel_gap_max": tensor_gap,
               "grad_tensors_over": grad_over,
               "update_norm": {"sp2": upd_sp, "one": upd_one},
               "latent_gap": lat_gap, "code_agreement": agree,
               "walls_s": {"sp2": {k: a[k] for k in ("forward_s", "step_s",
                                                     "synth_s")},
                           "one": {k: o[k] for k in ("forward_s", "step_s",
                                                     "synth_s")}}}
    checks = {
        f"{name}_ranks_agree": torch.equal(a["forward"], b["forward"])
        and a["losses"] == b["losses"]
        and torch.equal(a["latents"], b["latents"])
        and all(torch.equal(g, b["grad"][n]) for n, g in a["grad"].items()),
        f"{name}_seq_sharded": a["sp"] == SP_RANKS and a["tp"] == 1,
        f"{name}_forward": fwd_gap <= (TP_F32_FWD_RTOL if f32
                                       else TP_BF16_FWD_RTOL),
        f"{name}_losses": loss_gap <= (TP_F32_LOSS_RTOL if f32
                                       else TP_BF16_LOSS_RTOL),
        f"{name}_grad_norms": norm_gap <= (TP_F32_LOSS_RTOL if f32
                                           else TP_BF16_LOSS_RTOL),
        f"{name}_grads": grad_gap <= (TP_F32_GRAD_RTOL if f32
                                      else TP_BF16_GRAD_RTOL)
        and not grad_over,
        f"{name}_update": abs(upd_sp - upd_one) / upd_one <= (
            TP_F32_UPDATE_RTOL if f32 else TP_BF16_UPDATE_RTOL),
        f"{name}_latents": lat_gap <= (TP_F32_LATENT_ATOL if f32
                                       else TP_BF16_FWD_RTOL),
    }
    if f32:
        checks["f32_codes"] = agree > TP_CODE_AGREE
    return checks, figures


def _pcm_gaps(got, want):
    """Relative Frobenius gap and bit-equal share of two int16 PCMs (a
    length that differs: inf and 0)."""
    import numpy as np
    import torch
    if len(got) != len(want):
        return math.inf, 0.0
    return (_rel_gap(torch.from_numpy(got.astype(np.float32)),
                     torch.from_numpy(want.astype(np.float32))),
            float((got == want).mean()))


def _sp_cli_start(tmp, here, env):
    """Start ``cli.train --multihost --sp 2 --backend gloo`` under
    ``torchrun --standalone --nproc_per_node 2`` (the launcher's path) and
    a ``cli.synthesize --multihost --sp 2 --backend gloo`` pair, on
    ``TINY`` (levels 40/20/10/5: three of the four shard): (the config's
    path, the processes by CLI)."""
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    cfg_path = os.path.join(tmp, "sp_tiny.json")
    Config(model=ModelConfig(**TINY),
           train=TrainConfig(batch_size=8, num_train_epochs=1,
                             learning_rate=1e-3,
                             lr_warmup_steps=0)).to_json(cfg_path)
    multi = ["--multihost", "--sp", "2", "--backend", "gloo"]
    train = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(SP_RANKS), "-m",
         "prompt_tts_tpu_torch.cli.train"] + multi
        + _sp_train_argv(cfg_path)
        + ["--log_dir", os.path.join(tmp, "sp_cli_log")],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    synth = _spawn_ranks(
        [sys.executable, "-m", "prompt_tts_tpu_torch.cli.synthesize"]
        + multi + _sp_synth_argv(cfg_path)
        + ["--out", os.path.join(tmp, "sp.wav")],
        SP_RANKS, dict(env, PTTS_COORDINATOR=f"127.0.0.1:{_free_port()}"),
        here)
    return cfg_path, {"train": [train], "synthesize": synth}


def _sp_train_argv(cfg_path):
    return ["--smoke", "--device", DEVICE, "--config_file", cfg_path,
            "--log_every", "1"]


def _sp_synth_argv(cfg_path):
    return ["--device", DEVICE, "--config_file", cfg_path, "--steps", "10",
            "--dtype", "f32", "--text", TEXTS[0], "--text", TEXTS[1]]


def _sp_cli_finish(tmp, cfg_path, procs):
    """The same two CLIs in this process, then the pairs of
    :func:`_sp_cli_start` held to them: the losses (``SP_CLI_LOSS_RTOL``),
    the wavs (the serve limits, ``TP_SERVE_*``).  Returns (checks,
    figures)."""
    import numpy as np
    from prompt_tts_tpu_torch.cli import synthesize as synth_cli
    from prompt_tts_tpu_torch.cli import train as train_cli
    t0 = time.perf_counter()
    try:
        train_cli.main(_sp_train_argv(cfg_path)
                       + ["--log_dir", os.path.join(tmp, "sp_one_log")])
        _, one_wavs, _ = synth_cli.main(
            _sp_synth_argv(cfg_path)
            + ["--out", os.path.join(tmp, "sp_one.wav")])
        logs = {k: _reap(ps, 300, f"sp cli.{k}") for k, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    sp_losses = _logged(os.path.join(tmp, "sp_cli_log"), "Loss/train")
    one_losses = _logged(os.path.join(tmp, "sp_one_log"), "Loss/train")
    loss_gap = max(abs(sp_losses[s] - one_losses[s]) / abs(one_losses[s])
                   for s in one_losses) if sorted(sp_losses) == sorted(
                       one_losses) else math.inf
    wav_gaps = []
    for i, wav in enumerate(one_wavs):
        want = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(
            np.int16)
        with open(os.path.join(tmp, f"sp_{i}.wav"), "rb") as f:
            got = np.frombuffer(_wav_pcm(f.read()), "<i2")
        wav_gaps.append(_pcm_gaps(got, want))
    checks = {"cli_train_sp2_torchrun": sorted(sp_losses) == [1, 2]
              and all(map(math.isfinite, sp_losses.values()))
              and loss_gap <= SP_CLI_LOSS_RTOL,
              "cli_synthesize_sp2": all(
                  g <= TP_SERVE_PCM_RTOL and e >= TP_SERVE_EQUAL_SHARE
                  for g, e in wav_gaps)
              and all("synthesized 2 utterance(s)" in log
                      for log in logs["synthesize"])}
    return checks, {"train_losses": {"sp2": sp_losses, "one": one_losses},
                    "train_loss_rel_gap": loss_gap,
                    "synthesize_pcm_rel_gap_equal_share": wav_gaps,
                    "after_the_ranks_s": time.perf_counter() - t0}


def phase_sp(smi, tmp, refs):
    """Sequence parallelism on one card: (a) two processes sharing it over
    gloo at ``--sp 2`` (``sp_rank_main``), ``ModelConfig()`` at full
    width, f32 (TF32 off) and bf16: the tp phase's forward, 3 train steps
    at B=4 and DDIM-10 of 2 requests, held against the one-process results
    that phase computed on the same weights and inputs (``refs``), kernels
    #1 and #2 launched on every rank (#1 at every step of the ring), the
    ring at 900 and 450 frames only (225 and 113 run whole); the ring
    alone at the flagship's self-attention shapes against its plain
    version and one-process attention (``_sp_ring_check``); (b)
    ``cli.train`` and ``cli.synthesize --sp 2`` pairs against the same CLIs
    in this process, the train pair under ``torchrun --standalone``
    (``_sp_cli_start``, ``_sp_cli_finish``); (c) ``cli.serve --sp 2
    --backend gloo`` against the one-process server's PCM (``refs``).  The
    processes of (a), (b) and (c) start together and run side by side.
    The halos, the GroupNorm statistics and the gathers are all-reduces,
    the ring's blocks cross through host memory: gloo's times on one card,
    not a multi-card figure.  Returns the launches summed over the ranks."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PTTS_NUM_PROCESSES=str(SP_RANKS),
               OMP_NUM_THREADS=CHILD_THREADS, PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = os.path.join(tmp, "sp_ranks")
    os.makedirs(out)
    serve, cli, ranks = ([], 0, 0.0), {}, []
    try:
        serve = _tp_serve_start(here, env, flag="--sp")
        cfg_path, cli = _sp_cli_start(tmp, here, env)
        launched = time.time()
        ranks = _spawn_ranks(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.sp_rank_main({out!r})"],
            SP_RANKS, dict(env, PTTS_COORDINATOR=f"127.0.0.1:{_free_port()}"),
            here)
        checks, figures = {}, {}
        # the one-process CLIs meanwhile, then the pairs
        c, cli_figures = _sp_cli_finish(tmp, cfg_path, cli)
        checks.update(c)
        _reap(ranks, 600, "sp ranks")
        ranks_s = time.perf_counter() - t_phase
        c, serve_figures, _ = _tp_serve(*serve, one_pcm=refs["serve_pcm"],
                                        what="sp serve")
        checks.update(c)
    finally:
        for p in (ranks + serve[0] + [p for ps in cli.values() for p in ps]):
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(SP_RANKS)]
    for name in ("f32", "bf16"):
        c, figures[name] = _sp_hold(name, ranks, refs["one"])
        checks.update(c)
    checks["gloo_on_one_card"] = all(
        r["backend"] == "gloo" and r["device"] == "cuda:0"
        and r["seq"] == (i, SP_RANKS) for i, r in enumerate(ranks))
    checks["ring_levels"] = all(r["ring_tqs"] == [450, 900] for r in ranks)
    checks["launched"] = all(
        r["launches"]["attention_fwd"] > 0
        and r["launches"]["attention_bwd"] > 0
        and r["launches"]["resnet"] > 0
        and r["launches"]["lstm_t" if _default_lstm() == "persistent"
                          else "lstm"] > 0 for r in ranks)
    checks["ring_kernels"] = all(c["ok"] for c in ranks[0]["ring"].values())
    emit({"phase": "sp", "what": f"(a) {SP_RANKS} processes on one card "
          f"over gloo at --sp 2, ModelConfig() at {TP_LAYERS_PER_BLOCK} "
          f"layer a block, f32 and bf16: a forward, "
          f"{TP_STEPS} steps at B={TP_BATCH}, DDIM-{TP_SYNTH_STEPS} of 2 "
          f"requests, against one process; the ring at "
          f"{SP_RING_SHAPES} (frames, D), {SP_RING_HEADS} heads, B="
          f"{TP_BATCH}; (b) cli.train (under torchrun --standalone) and "
          f"cli.synthesize --sp 2 on TINY against one process; (c) "
          f"cli.serve --sp 2 (f32, "
          f"DDIM-{TP_SERVE_STEPS}, batch 1) against the one-process server",
          "checks": checks, "figures": figures,
          "ring_kernels": ranks[0]["ring"],
          "ring_tqs": [r["ring_tqs"] for r in ranks],
          "launches": [r["launches"] for r in ranks], "cli": cli_figures,
          "serve": serve_figures, "ranks_s": ranks_s,
          "rank_start_s": [r["entered_at"] - launched for r in ranks],
          "rank_setup_s": [r["cases_at"] - r["entered_at"] for r in ranks],
          "rank_cases_s": [r["cases_s"] for r in ranks],
          "rank_ring_s": [r["ring_s"] for r in ranks],
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"sp checks failed: {checks}")
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}


def _default_lstm():
    from prompt_tts_tpu_torch.codec.layers import DEFAULT_LSTM_SCHEDULE
    return DEFAULT_LSTM_SCHEDULE


def f32_times(smi):
    """``--f32-times``: the f32 paths of kernels #1, #2 and #6 and the f32
    walls at B=32 alone, through what the parent commits have too, so
    that two versions of the package can be timed in turns in one call:
    kernel #1 at ``cli.evaluate``'s shapes and #6 beside their library
    calls (TF32 off), #1 with the lse and #2 over one train step's 36
    calls (each call, and each of #6's blocks, checked against its plain
    version first); then the
    flagship ``ModelConfig()`` on seeded random weights and
    ``SyntheticDataset`` codes: a warm f32 train step (what ``cli.train``
    runs without ``--bf16``: wall and peak memory) and one ``cli.evaluate``
    batch (6 f32 forwards: wall)."""
    import torch
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.data.dataset import SyntheticDataset
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import cast_compute_
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.pipeline import full_f32, random_init_
    from prompt_tts_tpu_torch.train.state import TrainState
    from prompt_tts_tpu_torch.train.step import make_train_step
    B = TRAIN_BATCHES[0]
    with full_f32():
        emit({"phase": "f32_times", "kernel": "attention_fwd",
              "evaluate": _attention_f32_times(B), "card": smi})
        emit({"phase": "f32_times", "kernel": "resnet",
              "evaluate": _resnet_f32_times(B), "card": smi})
        bwd, fwd = _attn_train_sums(smi, torch.Generator("cuda").manual_seed(
            1), B, torch.float32)
        emit({"phase": "f32_times", "kernel": "attention_fwd_lse",
              "train": fwd, "card": smi})
        emit({"phase": "f32_times", "kernel": "attention_bwd",
              "train": bwd, "card": smi})
    cfg = Config()
    dev = torch.device("cuda")
    model = TTSSingleSpeaker(cfg.model, device=dev)
    random_init_(model, torch.Generator().manual_seed(cfg.train.seed))
    sched = linear_schedule(cfg.train.num_train_timesteps, device=dev)
    host = next(SyntheticDataset(n=B).batches(B))
    batch = {k: torch.from_numpy(host[k]).to(dev)
             for k in ("codes", "text_ids", "text_mask")}
    state = TrainState(model, cfg.train, 100)
    step = make_train_step(state, sched)
    gen = torch.Generator(dev).manual_seed(5)
    step(batch, gen)
    torch.cuda.synchronize()
    walls, peak, _ = _step_walls(step, batch, gen, 3)
    del step, state
    gc.collect()
    torch.cuda.empty_cache()
    cast_compute_(model.eval(), torch.float32)
    emit({"phase": "f32_times", "what": f"ModelConfig() f32, B={B}: a warm "
          f"train step (cli.train without --bf16; TF32 as torch sets it) "
          f"and one cli.evaluate batch (eval + 5 grid points, TF32 off)",
          "train_step_s": walls,
          "train_median_step_s": statistics.median(walls),
          "train_peak_mem_gib": peak,
          "evaluate_batch_s": _evaluate_batch_walls(model, sched, batch),
          "card": smi})


def remat_times(smi):
    """The flagship bf16 train step at batch 32 on random codes, in turns
    (each variant twice, forward order then backward order): plain; the
    port's remat (a plain checkpoint region a block); and two renderings
    of JAX's ``dots_with_no_batch_dims_saveable`` as a selective
    checkpoint (``aten.mm`` / ``aten.addmm`` outputs saved): one region
    over the whole model, as ``jax.checkpoint`` wraps it, and a region a
    block.  Median wall of a synchronised step (clip and AdamW included)
    and peak memory."""
    import functools
    import torch
    from torch.utils.checkpoint import (
        CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    )
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
    from prompt_tts_tpu_torch.models.layers import set_compute_dtype_
    from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
    from prompt_tts_tpu_torch.pipeline import random_init_
    from prompt_tts_tpu_torch.train import step as train_step
    from prompt_tts_tpu_torch.train.state import TrainState
    cfg, dev, B = Config(), torch.device("cuda"), TRAIN_BATCHES[0]
    model = TTSSingleSpeaker(cfg.model, device=dev)
    random_init_(model, torch.Generator().manual_seed(0))
    set_compute_dtype_(model, torch.bfloat16)
    model.train()
    g = torch.Generator().manual_seed(1)
    batch = {"codes": (torch.rand(B, 900, 8, generator=g) * 2 - 1).to(dev),
             "text_ids": torch.randint(1, 149, (B, TEXT_LEN),
                                       generator=g).to(dev),
             "text_mask": torch.ones(B, TEXT_LEN, dtype=torch.long,
                                     device=dev)}
    state = TrainState(model, cfg.train, 100)
    sched = linear_schedule(device=dev)

    def dots(ctx, op, *args, **kwargs):
        if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    selective = functools.partial(create_selective_checkpoint_contexts,
                                  dots)
    plain_loss = train_step.make_loss_fn(model, sched)
    blocks = train_step.remat_blocks(model)

    def one_region(b, gen):
        def fn(*a):
            return checkpoint(model, *a, use_reentrant=False,
                              context_fn=selective)
        return train_step.make_loss_fn(fn, sched)(b, gen)

    def per_block_dots(b, gen):
        for m in blocks:
            m.forward = functools.partial(checkpoint, m.forward,
                                          use_reentrant=False,
                                          context_fn=selective)
        try:
            return plain_loss(b, gen)
        finally:
            for m in blocks:
                del m.forward
    variants = {"plain": plain_loss,
                "remat": train_step.make_loss_fn(model, sched, remat=True),
                "one_region_dots": one_region,
                "per_block_dots": per_block_dots}

    def step(name):
        variants[name](batch, torch.Generator(dev).manual_seed(3)).backward()
        state.apply_gradients()

    for name in variants:
        step(name)
    walls = {n: [] for n in variants}
    peaks = dict.fromkeys(variants, 0.0)
    for name in list(variants) + list(variants)[::-1]:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(name)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name],
                              torch.cuda.max_memory_allocated() / 2**30)
    emit({"phase": "remat_times", "what": f"train step ModelConfig() bf16 "
          f"B={B}, random codes: plain, the port's remat and JAX's policy "
          f"as a selective checkpoint (one region; a region a block)",
          "median_step_s": {n: statistics.median(w)
                            for n, w in walls.items()},
          "step_s": walls, "peak_mem_gib": peaks, "card": smi})


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from prompt_tts_tpu_torch.pipeline import full_f32

    modes = {"--lstm-times": lstm_times,
             "--rvq-times": rvq_times,
             "--resnet-times": resnet_times,
             "--resnet-tiles": resnet_tile_sweep,
             "--synth-times": synth_times,
             "--remat-times": remat_times,
             "--f32-times": f32_times,
             "--synth-bits": synth_bits}
    if any(a not in modes for a in sys.argv[1:]):
        raise SystemExit(f"chip_smoke: arguments are any of {list(modes)}")
    t_script = time.perf_counter()
    smi = phase_card()
    if sys.argv[1:]:
        for a in sys.argv[1:]:
            modes[a](smi)
        return
    walls = {}

    def timed(phase):
        """``phase``, its wall seconds kept in ``walls`` by name."""
        def run(*args):
            t0 = time.perf_counter()
            try:
                return phase(*args)
            finally:
                walls[phase.__name__[len("phase_"):]] = (
                    time.perf_counter() - t0)
        return run

    with full_f32():
        fwd = timed(phase_attention_fwd)(smi)
        lstm, lstm_t = timed(phase_lstm)(smi)
        resnet = timed(phase_resnet)(smi)
    synth = timed(phase_slice)(smi)
    with tempfile.TemporaryDirectory() as tmp:
        prompt, other, prompt_rvq_res = timed(phase_prompt_slice)(smi, tmp)
        served, long_cli = timed(phase_serve)(smi, tmp)
        prompt_served, serve_rvq_gap = timed(phase_prompt_serve)(smi, tmp)
    with full_f32():
        timed(phase_small)(smi)
        timed(phase_prompt_small)(smi)
        timed(phase_encode_small)(smi)
        timed(phase_train_small)(smi)
        timed(phase_prompt_train_small)(smi)
    with tempfile.TemporaryDirectory() as tmp:
        encode, rvq, codes_tar = timed(phase_encode_slice)(smi, tmp)
        train, batch, ckpt = timed(phase_train_slice)(smi, codes_tar, tmp)
        prompt_train, prompt_ckpt, prompt_cfg = timed(
            phase_prompt_train_slice)(smi, codes_tar, tmp, batch)
        ckpt_synth = timed(phase_ckpt_synth)(smi, tmp, prompt_ckpt,
                                             prompt_cfg, ckpt)
        remat = timed(phase_remat_train)(smi, codes_tar, batch)
        extras = timed(phase_train_cli_extras)(smi, codes_tar, tmp)
        evaluated = timed(phase_evaluate)(smi, codes_tar, ckpt,
                                          prompt_ckpt, prompt_cfg, batch)
        exported = timed(phase_export)(smi, tmp, ckpt)
    with tempfile.TemporaryDirectory() as tmp:
        aot_art = timed(phase_aot)(smi, tmp)
    ddpm = timed(phase_ddpm)(smi)
    codec_bf16 = timed(phase_codec_bf16)(smi)
    with tempfile.TemporaryDirectory() as tmp:
        variants = timed(phase_unet_variants)(smi, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        profiled = timed(phase_profile)(smi, tmp, batch)
        ddp_nccl = timed(phase_ddp_nccl)(smi, tmp)
        ddp_ranks = timed(phase_ddp_two_ranks)(smi, tmp)
        tp, one_refs = timed(phase_tp)(smi, tmp)
        sp = timed(phase_sp)(smi, tmp, one_refs)
        del one_refs
    rvq["differ"]["prompt_latents"] = prompt_rvq_res["differ"]
    rvq["max_abs_err"] = max(rvq["max_abs_err"],
                             prompt_rvq_res["max_score_gap"], serve_rvq_gap)
    with full_f32():
        bwd, fwd["train_shapes"] = timed(phase_attention_bwd)(smi, batch)
        bwd["prompt_train_shapes"] = timed(phase_prompt_attention_bwd)(
            smi, batch)
    bwd["max_abs_err"] = max(bwd["max_abs_err"],
                             bwd["prompt_train_shapes"].pop("max_abs_err"))
    paths = {k: {"synthesize": synth[k], "prompt_synthesize": prompt[k],
                 "codec_other_lstm_schedule": other[k], "train": train[k],
                 "encode": encode[k], "prompt_train": prompt_train[k],
                 "ckpt_synthesize": ckpt_synth[k], "serve": served[k],
                 "synthesize_long": long_cli[k],
                 "prompt_serve": prompt_served[k], "remat_train": remat[k],
                 "train_cli_extras": extras[k], "evaluate": evaluated[k],
                 "export": exported[k], "aot": aot_art[k], "ddpm": ddpm[k],
                 "profile": profiled[k], "ddp_nccl": ddp_nccl[k],
                 "ddp_two_ranks": ddp_ranks[k], "codec_bf16": codec_bf16[k],
                 "unet_variants": variants[k], "tp": tp[k], "sp": sp[k]}
             for k in KERNELS}
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
    emit({"phase_walls_s": walls, "script_s": time.perf_counter() - t_script,
          "card": smi})
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
