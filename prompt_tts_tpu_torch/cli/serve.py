"""Batching TTS inference server on PyTorch:
``python -m prompt_tts_tpu_torch.cli.serve``.

Port of ``prompt_tts_tpu/cli/serve.py``.  HTTP POST /synthesize with
``{"text": "...", "seed": 0}`` returns a 16-bit 24 kHz WAV, one utterance
a request.  Requests are micro-batched up to ``--max_batch`` within
``--batch_window_ms``: the batch is padded to ``--max_batch`` with empty
texts, so every batch runs the program the warmup ran, and the requests
of one batch share the first one's seed (each row still draws its own
noise).  ``"stream": true`` returns chunked transfer, one decoded code
prefix at a time; a text longer than one window (``split_long_text``)
is synthesized window by window and joined (``--crossfade_ms``), in one
response or streamed.

A prompt-conditioned config (``prompt_conditioning: true``) takes
``--speakers DIR``: every ``*.wav`` there is resampled to 24 kHz, encoded
once at startup and registered under its file name's stem; requests pick
one with ``{"speaker": "name"}`` (default: the first).  GET /speakers
lists them, GET /healthz answers, GET /stats counts.

On the card the batcher is a two-stage pipeline: its dispatcher enqueues
batch k+1 on a stream of its own while its collector waits on batch k's
event alone and pulls it.  Streaming and long-form requests bypass the
batcher and hold one of two slots, each with its own stream.

``--tp N`` with ``--multihost`` (N processes under torchrun or the
``PTTS_*`` variables, one model group) shards the denoiser over the N
ranks (``parallel/tp.py``), and ``--sp M`` its latent time over M ranks
(``parallel/sp.py``; the world is N x M ranks). The JAX server is one
controller; here only rank 0 runs the HTTP server, the batcher and the
slots, and its ``Synthesizer`` leads (``Synthesizer.lead``): each
denoise, from whichever thread, first broadcasts its inputs (ids, masks,
x_T from the request's seed, prompt latents, the sampler and step count)
to the group, one at a time under a lock, so its collectives are the
only ones in flight.  The other ranks run the same denoises in a follow
loop (``Synthesizer.follow``) and exit when rank 0 shuts down.

  python -m prompt_tts_tpu_torch.cli.serve --device cpu --steps 2 \\
      --max_batch 2 --config_file tiny.json
  curl localhost:8777/healthz
  curl -d '{"text": "Hello there."}' localhost:8777/synthesize -o x.wav
  torchrun --nproc_per_node 2 -m prompt_tts_tpu_torch.cli.serve \
      --multihost --tp 2
  torchrun --nproc_per_node 2 -m prompt_tts_tpu_torch.cli.serve \
      --multihost --sp 2 --backend gloo
"""

import argparse
import contextlib
import json
import logging
import os
import queue
import signal
import threading
import time
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from prompt_tts_tpu_torch.cli._common import (
    add_parallel_args, check_one_block, check_parallel_flags,
)

log = logging.getLogger(__name__)

# a follower rank waits on rank 0 between requests for as long as the
# server is idle: its collectives may not time out
IDLE_TIMEOUT = timedelta(days=365)

# how many streaming / long-form requests may run at once
STREAM_SLOTS = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TTS inference server "
                                            "(PyTorch port).")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8777,
                   help="0 takes a free port; the log names it.")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="The port's checkpoint directory (cli.train "
                        "--ckpt_dir); its latest step is loaded.")
    p.add_argument("--codec_params", type=str, default=None,
                   help="Codec weights: a port state dict (torch.save), "
                        "as cli.convert_codec writes it.")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim",
                   help="dpm = DPM-Solver++(2M): ~20-25 steps suffice.")
    p.add_argument("--max_batch", type=int, default=8,
                   help="Static device batch size.")
    p.add_argument("--batch_window_ms", type=int, default=30,
                   help="How long to wait to fill a batch.")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                   help="Denoiser compute dtype (the codec decodes in f32).")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="Classifier-free guidance scale (>1 needs a "
                        "model trained with cond_dropout_prob>0; "
                        "works for both model families).")
    p.add_argument("--speakers", type=str, default=None,
                   help="Directory of reference *.wav files for a "
                        "prompt-conditioned model; each is registered as "
                        "a speaker under its filename stem.")
    p.add_argument("--drain_s", type=float, default=600.0,
                   help="SIGTERM drain budget: wait up to this long for "
                        "in-flight requests (incl. streaming/long-form) "
                        "to complete before exiting.")
    p.add_argument("--ema", action="store_true",
                   help="Serve the checkpoint's EMA params (requires "
                        "training with --ema_decay).")
    p.add_argument("--max_queue", type=int, default=32,
                   help="Admission control: bound on queued batcher "
                        "requests; past it, POSTs are rejected with 429 "
                        "immediately instead of queueing.")
    p.add_argument("--crossfade_ms", type=float, default=20.0,
                   help="Long-form seam treatment: equal-power crossfade "
                        "of this many milliseconds at every window join "
                        "(0 = hard concatenation).")
    p.add_argument("--continuity_prompt", action="store_true",
                   help="Prompt-conditioned family: condition each "
                        "long-form window on the previous window's "
                        "generated tail codes (sequential windows). "
                        "Applies to prompted requests only.")
    p.add_argument("--stream_wait_s", type=float, default=30.0,
                   help="Admission control for streaming/long-form "
                        "requests (which bypass the batcher): max wait "
                        "for one of the two in-flight slots before "
                        "rejecting with 429.")
    add_parallel_args(p, "Run as one rank of a process group (torchrun or "
                         "the PTTS_* variables), for --tp and --sp; the "
                         "world is one model x seq group and rank 0 "
                         "serves.")
    return p.parse_args(argv)


def default_chunk(frames: int) -> int:
    """The streaming chunk the warmup decodes: ceil(frames / 3)."""
    return min(max(1, -(-frames // 3)), frames)


def quantize_chunk(chunk: int, frames: int) -> int:
    """A client's ``chunk_frames`` snapped to a multiple of the default
    chunk of a ``frames``-long window, so its prefixes are among those the
    warmup decoded."""
    c0 = default_chunk(frames)
    k = max(1, round(chunk / c0))
    return min(k * c0, frames)


class _Batcher:
    """Collects requests into fixed-size batches for the device program.

    Two stages: the dispatcher thread builds and pads a batch and enqueues
    its whole program without a pull (``Synthesizer.synthesize_async``,
    pcm16 quantized on the device); the collector thread pulls each
    dispatched batch and fulfils its requests' slots.  On the card the
    dispatcher runs on a stream of its own and the collector waits on that
    batch's event alone, then copies on its thread's default stream, so
    batch k's pull overlaps batch k+1's compute (a pull on the dispatcher's
    stream would wait for everything queued there).  At most 2 batches are
    dispatched and not yet pulled (``pending``); the request queue is
    bounded at ``max_queue``.
    """

    def __init__(self, synth, max_batch: int, window_s: float,
                 prompted: bool = False, max_queue: int = 32):
        self.synth = synth
        self.max_batch = max_batch
        self.window_s = window_s
        self.prompted = prompted
        self.q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.pending: "queue.Queue" = queue.Queue(maxsize=2)
        self.stream = side_stream(synth.device)
        self.thread = threading.Thread(target=self._dispatch_loop,
                                       daemon=True)
        self.collector = threading.Thread(target=self._collect_loop,
                                          daemon=True)
        self.thread.start()
        self.collector.start()

    def submit(self, text: str, seed: int, prompt_codes=None):
        """Enqueue one request; returns its slot, or ``None`` when the
        bounded queue is full (the caller must reject with 429)."""
        slot = {"done": threading.Event()}
        try:
            self.q.put_nowait((text, seed, prompt_codes, slot))
        except queue.Full:
            return None
        return slot

    def close(self, timeout: float = 60.0):
        """Stop both threads once the work queued before has finished."""
        try:
            self.q.put(None, timeout=timeout)
        except queue.Full:
            return
        self.thread.join(timeout)
        self.collector.join(timeout)

    @staticmethod
    def _fail(batch, e):
        for b in batch:
            b[3]["error"] = str(e)
            b[3]["done"].set()

    def _dispatch_loop(self):
        from prompt_tts_tpu_torch.pipeline import stream_scope
        with torch.no_grad(), stream_scope(self.stream):
            stop = False
            while not stop:
                item = self.q.get()
                if item is None:
                    break
                batch = [item]
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self.q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None:
                        stop = True
                        break
                    batch.append(item)
                texts = [b[0] for b in batch]
                padded = texts + [""] * (self.max_batch - len(texts))
                kw = {}
                if self.prompted:
                    # per-request speaker prompts, zero-filled padding rows
                    prompts = [b[2] for b in batch]
                    fill = np.zeros_like(prompts[0])
                    prompts += [fill] * (self.max_batch - len(prompts))
                    kw["prompt_codes"] = np.stack(prompts)
                try:
                    wav, event = self.synth.synthesize_async(
                        padded, seed=batch[0][1], pcm16=True, **kw)
                except Exception as e:  # noqa: BLE001 — report per request
                    log.exception("batch dispatch failed")
                    self._fail(batch, e)
                    continue
                self.pending.put((batch, wav, event))
        self.pending.put(None)

    @staticmethod
    def _pull(wav, event) -> np.ndarray:
        """The device wav on the host once ``event`` has passed.  The copy
        runs on this thread's default stream, which does not wait on the
        dispatcher's, and holds ``wav`` until it has finished."""
        if event is not None:
            event.synchronize()
        return wav.cpu().numpy()

    def _collect_loop(self):
        while True:
            item = self.pending.get()
            if item is None:
                return
            batch, wav, event = item
            try:
                wavs = self._pull(wav, event).astype("<i2", copy=False)
            except Exception as e:  # noqa: BLE001
                log.exception("batch pull failed")
                self._fail(batch, e)
                continue
            for i, b in enumerate(batch):
                b[3]["wav"] = wavs[i]
                b[3]["done"].set()


def side_stream(device):
    """A new stream for a worker thread, ordered after the work queued so
    far on the current one (the weights, the warmup); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def load_speakers(synth, directory: str) -> dict:
    """Every ``*.wav`` of ``directory``, resampled to 24 kHz and encoded
    once, as int32 prompt codes ``[n_q, prompt_frames]`` by file stem.  A
    reference shorter than ``prompt_frames`` is padded by repeating its
    last code frame: RVQ index 0 is a real codebook entry, not silence."""
    from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE
    from prompt_tts_tpu_torch.utils.resample import resample
    from prompt_tts_tpu_torch.utils.wav import read_wav
    tp = synth.config.model.prompt_frames
    speakers: dict = {}
    for name in sorted(os.listdir(directory)):
        if not name.lower().endswith(".wav"):
            continue
        audio, sr = read_wav(os.path.join(directory, name))
        if sr != SAMPLE_RATE:
            audio = resample(audio, sr, SAMPLE_RATE)
        audio = audio[None, :, 0] if audio.ndim == 2 else audio[None]
        codes = synth.encode_audio(np.ascontiguousarray(audio))[0]
        codes = codes.cpu().numpy()                       # [n_q, F]
        F = min(tp, codes.shape[1])
        if F == 0:
            raise SystemExit(f"speaker wav {name} is empty")
        fixed = np.repeat(codes[:, F - 1:F], tp, axis=1)
        fixed[:, :F] = codes[:, :F]
        speakers[os.path.splitext(name)[0]] = fixed
    if not speakers:
        raise SystemExit(f"no *.wav files in {directory}")
    log.info("registered %d speakers: %s", len(speakers), ", ".join(speakers))
    return speakers


def warmup(synth, max_batch: int, chunk_frames: int, speakers: dict):
    """Run the batched program and the streaming path once (on the card
    this also builds every kernel's library)."""
    kw, kw1 = {}, {}
    if speakers:
        first = next(iter(speakers.values()))
        kw = {"prompt_codes": np.stack([first] * max_batch)}
        kw1 = {"prompt_codes": first[None]}
    synth.synthesize([""] * max_batch, pcm16=True, **kw)
    for _ in synth.synthesize_stream([""], pcm16=True,
                                     chunk_frames=chunk_frames, **kw1):
        pass


class _Stats:
    """GET /stats: counters, the last 256 admitted latencies, and the
    POSTs being handled now (the SIGTERM drain waits on those)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = {"requests": 0, "errors": 0, "streamed": 0,
                       "rejected": 0}
        self.started = time.time()
        self.latencies: list = []
        self.inflight = 0

    def record(self, t0: float, error: bool = False, streamed: bool = False):
        dt = time.time() - t0
        with self.lock:
            self.counts["requests"] += 1
            self.counts["errors"] += int(error)
            self.counts["streamed"] += int(streamed)
            self.latencies.append(dt)
            del self.latencies[:-256]

    def reject(self):
        # 429s are the admission policy working: counted apart, and kept
        # out of the latency window of admitted work
        with self.lock:
            self.counts["requests"] += 1
            self.counts["rejected"] += 1

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies)
            out = dict(self.counts,
                       uptime_s=round(time.time() - self.started, 1),
                       requests_in_flight=self.inflight)
        if lat:
            # one nearest-rank formula for both, so p50 <= p90 at any size
            def pct(q):
                return round(lat[int(q * (len(lat) - 1))], 4)
            out["latency_s_p50"] = pct(0.5)
            out["latency_s_p90"] = pct(0.9)
        return out


class Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 for chunked transfer (the streaming paths); every other
    # response carries Content-Length
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        # count the whole handling, response included, so that the drain
        # never ends the process under a reply
        stats = self.server.stats
        with stats.lock:
            stats.inflight += 1
        try:
            self._do_post()
        finally:
            with stats.lock:
                stats.inflight -= 1

    def _do_post(self):
        srv = self.server
        if self.path != "/synthesize":
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            text = req["text"]
            seed = int(req.get("seed", 0))
            stream = bool(req.get("stream", False))
            chunk_frames = quantize_chunk(
                int(req.get("chunk_frames", srv.default_chunk)),
                srv.synth.config.model.sample_size)
        except Exception as e:  # noqa: BLE001
            self.send_error(400, f"bad request: {e}")
            return
        prompt = None
        if srv.speakers:
            name = req.get("speaker", next(iter(srv.speakers)))
            if name not in srv.speakers:
                self.send_error(400, f"unknown speaker {name!r}; see "
                                     "/speakers")
                return
            prompt = srv.speakers[name]
        t0 = time.time()
        # texts past one window take the long-form path
        if len(srv.synth.split_long_text(text)) > 1:
            if stream:
                self._stream_long_response(text, seed, prompt, t0)
            else:
                self._long_response(text, seed, prompt, t0)
            return
        if stream:
            self._stream_response(text, seed, prompt, chunk_frames, t0)
            return
        slot = srv.batcher.submit(text, seed, prompt)
        if slot is None:
            srv.stats.reject()
            self.send_error(429, "server overloaded: request queue is "
                                 "full, retry later")
            return
        slot["done"].wait(timeout=600)
        if "error" in slot:
            srv.stats.record(t0, error=True)
            self.send_error(500, slot["error"])
            return
        if "wav" not in slot:
            # the wait timed out with the slot unfulfilled
            srv.stats.record(t0, error=True)
            self.send_error(503, "synthesis timed out")
            return
        self._send_wav(slot["wav"])
        srv.stats.record(t0)

    def _send_wav(self, pcm: np.ndarray):
        from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE
        from prompt_tts_tpu_torch.utils.wav import wav_header
        data = (wav_header(len(pcm), SAMPLE_RATE)
                + pcm.astype("<i2", copy=False).tobytes())
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _prompt_kw(self, prompt) -> dict:
        return {} if prompt is None else {"prompt_codes": prompt[None]}

    def _continuity(self, prompt) -> bool:
        return self.server.args.continuity_prompt and prompt is not None

    def _long_response(self, text, seed, prompt, t0):
        """Long-form synthesis in one response.  ``pad_groups`` keeps every
        group at the batch size the warmup ran; like streaming, it bypasses
        the batcher (it owns whole batches)."""
        srv = self.server
        with srv.stream_slot() as ok:
            if not ok:
                srv.stats.reject()
                self.send_error(429, "server overloaded: long-form slots "
                                     "busy, retry later")
                return
            try:
                wav = srv.synth.synthesize_long(
                    text, seed=seed, max_batch=srv.args.max_batch,
                    pcm16=True, pad_groups=True,
                    crossfade_ms=srv.args.crossfade_ms,
                    continuity_prompt=self._continuity(prompt),
                    **self._prompt_kw(prompt))
            except Exception as e:  # noqa: BLE001
                log.exception("long-form synthesis failed")
                srv.stats.record(t0, error=True)
                self.send_error(500, str(e))
                return
        self._send_wav(wav)
        srv.stats.record(t0)

    def _chunked(self, first: bytes, rest):
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        chunk(first)
        for data in rest:
            chunk(data)
        self.wfile.write(b"0\r\n\r\n")

    def _stream_long_response(self, text, seed, prompt, t0):
        """Chunked long-form WAV, one trimmed piece a window.  The total
        is not known up front, so the header carries the unknown-length
        sizes (0xFFFFFFFF: read until the end)."""
        from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE
        from prompt_tts_tpu_torch.utils.wav import wav_header
        srv = self.server
        with srv.stream_slot() as ok:
            if not ok:
                srv.stats.reject()
                self.send_error(429, "server overloaded: streaming slots "
                                     "busy, retry later")
                return
            try:
                gen = srv.synth.synthesize_long_stream(
                    text, seed=seed, pcm16=True,
                    crossfade_ms=srv.args.crossfade_ms,
                    continuity_prompt=self._continuity(prompt),
                    **self._prompt_kw(prompt))
                first = next(gen)
            except Exception as e:  # noqa: BLE001
                log.exception("long-form streaming failed")
                srv.stats.record(t0, error=True, streamed=True)
                self.send_error(500, str(e))
                return
            self._chunked(
                wav_header(None, SAMPLE_RATE) + _pcm(first),
                (_pcm(piece) for piece in gen))
            srv.stats.record(t0, streamed=True)

    def _stream_response(self, text, seed, prompt, chunk_frames, t0):
        """Chunked WAV: the first audio leaves after one decoded code
        prefix instead of the whole window."""
        from prompt_tts_tpu_torch.pipeline import SAMPLE_RATE
        from prompt_tts_tpu_torch.utils.wav import wav_header
        srv = self.server
        n_total = srv.synth.config.model.sample_size * 320
        with srv.stream_slot() as ok:
            if not ok:
                srv.stats.reject()
                self.send_error(429, "server overloaded: streaming slots "
                                     "busy, retry later")
                return
            try:
                gen = srv.synth.synthesize_stream(
                    [text], seed=seed, chunk_frames=chunk_frames,
                    pcm16=True, **self._prompt_kw(prompt))
                first = next(gen)
            except Exception as e:  # noqa: BLE001
                log.exception("streaming failed")
                srv.stats.record(t0, error=True, streamed=True)
                self.send_error(500, str(e))
                return
            self._chunked(
                wav_header(n_total, SAMPLE_RATE) + _pcm(first[0]),
                (_pcm(piece[0]) for piece in gen))
            srv.stats.record(t0, streamed=True)

    def do_GET(self):
        srv = self.server
        if self.path == "/healthz":
            body = b'{"status": "ok"}'
        elif self.path == "/speakers":
            body = json.dumps(sorted(srv.speakers)).encode()
        elif self.path == "/stats":
            body = json.dumps(dict(
                srv.stats.snapshot(), queue_depth=srv.batcher.q.qsize(),
                max_queue=srv.args.max_queue,
                batches_in_flight=srv.batcher.pending.qsize())).encode()
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *fmt_args):
        log.info("%s " + fmt, self.address_string(), *fmt_args)


def _pcm(piece: np.ndarray) -> bytes:
    return piece.astype("<i2", copy=False).tobytes()


class Server(ThreadingHTTPServer):
    """The HTTP server and what its handlers share: the ``Synthesizer``,
    the speaker registry, the batcher, the stream slots and the stats."""

    def __init__(self, args, synth, speakers: dict, batcher: _Batcher):
        # the listen backlog must exceed the admission bound: with the
        # stock 5, a burst of connects overflows the kernel's accept queue
        # and clients see resets instead of 429s
        self.request_queue_size = max(128, 4 * args.max_queue)
        self.args = args
        self.synth = synth
        self.speakers = speakers
        self.batcher = batcher
        self.stats = _Stats()
        self.default_chunk = default_chunk(synth.config.model.sample_size)
        self._slots = threading.Semaphore(STREAM_SLOTS)
        self._slot_streams: "queue.SimpleQueue" = queue.SimpleQueue()
        for _ in range(STREAM_SLOTS):
            self._slot_streams.put(side_stream(synth.device))
        self.startup: dict = {}
        super().__init__((args.host, args.port), Handler)

    @contextlib.contextmanager
    def stream_slot(self):
        """One of the streaming / long-form slots, waited for up to
        ``--stream_wait_s``: yields False when none came free, else True
        with the calling thread's torch work on the slot's stream, grad
        off."""
        if not self._slots.acquire(timeout=self.args.stream_wait_s):
            yield False
            return
        from prompt_tts_tpu_torch.pipeline import stream_scope
        stream = self._slot_streams.get()
        try:
            with torch.no_grad(), stream_scope(stream):
                yield True
        finally:
            self._slot_streams.put(stream)
            self._slots.release()

    def busy(self) -> bool:
        with self.stats.lock:
            n = self.stats.inflight
        return bool(n or self.batcher.q.qsize()
                    or self.batcher.pending.qsize())

    def drain(self):
        """Wait, up to ``--drain_s``, for in-flight handlers and both
        batcher queues to empty."""
        deadline = time.monotonic() + self.args.drain_s
        while time.monotonic() < deadline and self.busy():
            time.sleep(0.05)

    def server_close(self):
        super().server_close()
        self.batcher.close()
        self.synth.release()


def _synthesizer(args, device):
    """The ``Synthesizer`` of the parsed ``args`` on ``device``."""
    from prompt_tts_tpu_torch.config import Config
    from prompt_tts_tpu_torch.pipeline import Synthesizer

    config = (Config.from_json(args.config_file) if args.config_file
              else Config())
    if args.ema and not args.ckpt_dir:
        raise SystemExit("--ema requires --ckpt_dir (EMA params live in "
                         "checkpoints produced by train --ema_decay)")
    prompted = config.model.prompt_conditioning
    if prompted and not args.speakers:
        raise SystemExit("prompt-conditioned model requires --speakers DIR")
    if args.speakers and not prompted:
        raise SystemExit("--speakers needs a prompt-conditioned model "
                         "config")
    model_state = codec_state = None
    if args.ckpt_dir:
        from prompt_tts_tpu_torch.cli._common import restore_model_state
        model_state, _ = restore_model_state(args.ckpt_dir, config,
                                             ema=args.ema)
    else:
        log.warning("no --ckpt_dir given: using RANDOM model weights "
                    "(output is noise)")
    if args.codec_params:
        codec_state = torch.load(args.codec_params, map_location="cpu",
                                 weights_only=True)
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    return Synthesizer(config=config, device=device, dtype=dtype,
                       num_inference_steps=args.steps, sampler=args.sampler,
                       guidance_scale=args.guidance_scale,
                       model_state=model_state, codec_state=codec_state)


def build_server(argv=None, device=None) -> Server:
    """The server of ``argv``, warmed up and listening (not yet serving):
    the ``Synthesizer`` (on ``device``, else ``--device``), the speaker
    registry, the warmup, the batcher and the socket.  ``startup`` holds
    the seconds each took.  On rank 0 of a group of ``--tp`` x ``--sp`` ranks
    the ``Synthesizer`` leads the others (which run :func:`follow`) from
    the warmup on."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    synth = _synthesizer(args, device or args.device)
    config = synth.config
    prompted = config.model.prompt_conditioning
    if synth.tp * synth.sp > 1:
        synth.lead()
    t_build = time.perf_counter()
    try:
        speakers = load_speakers(synth, args.speakers) if prompted else {}
        t_speakers = time.perf_counter()
        log.info("warming up (the batched program and the streaming path)")
        warmup(synth, args.max_batch,
               default_chunk(config.model.sample_size), speakers)
        t_warm = time.perf_counter()
        batcher = _Batcher(synth, args.max_batch,
                           args.batch_window_ms / 1e3, prompted=prompted,
                           max_queue=args.max_queue)
        server = Server(args, synth, speakers, batcher)
    except BaseException:
        synth.release()         # the followers return
        raise
    t_end = time.perf_counter()
    server.startup = {"build_s": t_build - t0,
                      "speakers_s": t_speakers - t_build,
                      "warmup_s": t_warm - t_speakers,
                      "rest_s": t_end - t_warm, "total_s": t_end - t0}
    return server


def follow(argv=None, device=None) -> int:
    """A rank of the model x seq group other than 0: build the same
    ``Synthesizer`` and run the denoises rank 0 sends until it shuts down.
    Returns how many ran."""
    synth = _synthesizer(parse_args(argv), device)
    log.info("rank of a group of %d x %d: following rank 0", synth.tp,
             synth.sp)
    n = synth.follow()
    log.info("rank 0 shut down after %d denoises", n)
    return n


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    check_parallel_flags(args)
    if not args.multihost:
        _serve(argv)
        return
    from prompt_tts_tpu_torch.parallel import block_rank, init_distributed
    device = init_distributed(args.device, backend=args.backend,
                              n_model=args.tp, n_seq=args.sp,
                              timeout=IDLE_TIMEOUT)
    try:
        check_one_block(args)
        if block_rank() != 0:
            follow(argv, device)
        else:
            _serve(argv, device)
    finally:
        torch.distributed.destroy_process_group()


def _serve(argv=None, device=None):
    server = build_server(argv, device)

    # SIGTERM stops accepting connections, drains what is in flight, then
    # exits 0
    def _sigterm(signum, frame):
        log.info("SIGTERM: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    host, port = server.server_address[:2]
    log.info("serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        server.drain()
        server.server_close()
        log.info("drained; exiting")


if __name__ == "__main__":
    main()
