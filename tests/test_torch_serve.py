"""The port's inference server on the CPU: ``cli.serve --device cpu`` as a
subprocess on a tiny config, driven over HTTP.

Three servers start at once in the module fixture, each on a free port it
binds itself (``--port 0``; the log names it): the main one (batch 2), an
overloaded one (batch 1, queue bound 2, stream wait 0.05 s) and a prompted
one with ``--speakers``.  What they answer is held, bit for bit, to an
in-process port ``Synthesizer`` on one thread at the padded batch.
"""

import http.client
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

from prompt_tts_tpu_torch.cli import serve
from prompt_tts_tpu_torch.config import Config, ModelConfig
from prompt_tts_tpu_torch.pipeline import Synthesizer
from prompt_tts_tpu_torch.utils.resample import resample
from prompt_tts_tpu_torch.utils.wav import write_wav

TINY = dict(block_out_channels=[32, 64, 64, 64], cross_attention_dim=64,
            attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
            sample_size=24, layers_per_block=1, unet_num_heads=4)
PROMPTED = dict(TINY, prompt_conditioning=True, prompt_frames=8,
                prompt_encoder_layers=1, prompt_tokens=4)
T = TINY["sample_size"]
HEADER = 44
# five windows at cmu_seq_len 32
LONG = "Hello there. General synthesis! Another sentence here."
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
JAX_SERVE = pathlib.Path(ROOT, "prompt_tts_tpu", "cli", "serve.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as the servers run (``OMP_NUM_THREADS=1``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(args):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "prompt_tts_tpu_torch.cli.serve",
         "--device", "cpu", "--steps", "2", "--port", "0", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})


def _wait_ready(proc, deadline):
    """The port the server listens on, once it says it is serving."""
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        lines.append(line)
        m = re.search(r"serving on http://[\d.]+:(\d+)", line)
        if m:
            # keep draining the log, so that the server never blocks on it
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return int(m.group(1))
        if proc.poll() is not None:
            break
    proc.kill()
    pytest.fail("server did not become ready:\n" + "".join(lines[-20:]))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    (root / "tiny.json").write_text(json.dumps(TINY))
    (root / "prompted.json").write_text(json.dumps(PROMPTED))
    spk = root / "speakers"
    spk.mkdir()
    rng = np.random.default_rng(0)
    # 0.3 s at 24 kHz, and 0.05 s at 22.05 kHz: 4 frames after the
    # resample, under prompt_frames (8): padded by its last frame
    write_wav(str(spk / "alice.wav"),
              (0.1 * rng.standard_normal(7200)).astype(np.float32), 24000)
    write_wav(str(spk / "bob.wav"),
              (0.1 * rng.standard_normal(1102)).astype(np.float32), 22050)
    procs = {
        "main": _start(["--max_batch", "2", "--batch_window_ms", "300",
                        "--config_file", str(root / "tiny.json")]),
        "overload": _start(["--max_batch", "1", "--batch_window_ms", "10",
                            "--max_queue", "2", "--stream_wait_s", "0.05",
                            "--config_file", str(root / "tiny.json")]),
        "prompted": _start(["--max_batch", "2", "--batch_window_ms", "50",
                            "--config_file", str(root / "prompted.json"),
                            "--speakers", str(spk)]),
    }
    try:
        deadline = time.time() + 240
        ports = {k: _wait_ready(p, deadline) for k, p in procs.items()}
        yield {"procs": procs, "ports": ports, "root": root, "speakers": spk}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def synth():
    return Synthesizer(config=Config(model=ModelConfig(**TINY)),
                       device="cpu", num_inference_steps=2)


@pytest.fixture(scope="module")
def prompted_synth():
    return Synthesizer(config=Config(model=ModelConfig(**PROMPTED)),
                       device="cpu", num_inference_steps=2)


def _jax_serve_lines(first: str, last: str) -> str:
    """The lines of JAX ``cli/serve.py`` from the one that starts with
    ``first`` through the one that starts with ``last``, dedented: rules
    the JAX server writes inline in its ``main``."""
    lines = JAX_SERVE.read_text().splitlines()
    i = next(k for k, line in enumerate(lines)
             if line.strip().startswith(first))
    j = next(k for k in range(i, len(lines))
             if lines[k].strip().startswith(last))
    return textwrap.dedent("\n".join(lines[i:j + 1]))


def _request(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _post(port, obj, **kw):
    body = obj if isinstance(obj, str) else json.dumps(obj)
    return _request(port, "POST", "/synthesize", body, **kw)


def _pcm(data) -> bytes:
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    return data[HEADER:]


def test_healthz(servers):
    status, body, _ = _request(servers["ports"]["main"], "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"status": "ok"}


def test_wav_is_the_in_process_batch(servers, synth):
    status, data, headers = _post(servers["ports"]["main"],
                                  {"text": "hello server", "seed": 4})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    want = synth.synthesize(["hello server", ""], seed=4, pcm16=True)[0]
    assert len(data) == HEADER + T * 320 * 2
    assert _pcm(data) == want.astype("<i2").tobytes()


def test_concurrent_requests_share_a_batch(servers, synth):
    """Two requests inside the batch window run as one batch of 2 at the
    first one's seed: each answer is a row of that batch."""
    port = servers["ports"]["main"]
    texts = ["first request", "second request"]
    go = threading.Barrier(2)
    results = {}

    def call(text):
        go.wait(10)
        results[text] = _post(port, {"text": text, "seed": 9})

    threads = [threading.Thread(target=call, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    got = {t: _pcm(results[t][1]) for t in texts}
    assert all(results[t][0] == 200 for t in texts)
    batches = [synth.synthesize(order, seed=9, pcm16=True)
               for order in (texts, texts[::-1])]
    assert any(got[texts[0]] == b[order.index(texts[0])].tobytes()
               and got[texts[1]] == b[order.index(texts[1])].tobytes()
               for b, order in zip(batches, (texts, texts[::-1])))


def _raw_chunks(port, obj):
    """POST ``obj`` on a raw socket: the response's headers and its chunk
    payloads, as they arrived."""
    body = json.dumps(obj).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f = s.makefile("rb")
        status = f.readline()
        headers = {}
        while True:
            line = f.readline().strip()
            if not line:
                break
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        chunks = []
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                break
            chunks.append(f.read(n))
            assert f.read(2) == b"\r\n"
        return status, headers, chunks


def test_streaming_is_chunked_and_the_in_process_stream(servers, synth):
    """One chunk a decoded prefix: the default chunk is ceil(24 / 3) = 8
    frames, and a client's 5 snaps to it."""
    status, headers, chunks = _raw_chunks(
        servers["ports"]["main"],
        {"text": "hello stream", "seed": 2, "stream": True,
         "chunk_frames": 5})
    assert b" 200 " in status
    assert headers["transfer-encoding"] == "chunked"
    assert [len(c) for c in chunks] == [HEADER + 8 * 640, 8 * 640, 8 * 640]
    head = chunks[0][:HEADER]
    assert int.from_bytes(head[40:44], "little") == T * 320 * 2
    want = np.concatenate(list(synth.synthesize_stream(
        ["hello stream"], seed=2, chunk_frames=8, pcm16=True)), axis=1)[0]
    assert b"".join(chunks)[HEADER:] == want.astype("<i2").tobytes()


def test_long_text_is_synthesize_long(servers, synth):
    status, data, _ = _post(servers["ports"]["main"],
                            {"text": LONG, "seed": 3})
    assert status == 200
    want = synth.synthesize_long(LONG, seed=3, max_batch=2, pcm16=True,
                                 pad_groups=True, crossfade_ms=20.0)
    assert len(want) > T * 320
    assert int.from_bytes(data[40:44], "little") == len(data) - HEADER
    assert _pcm(data) == want.astype("<i2").tobytes()


def test_long_text_streamed_is_synthesize_long_stream(servers, synth):
    status, headers, chunks = _raw_chunks(
        servers["ports"]["main"], {"text": LONG, "seed": 3, "stream": True})
    assert b" 200 " in status and headers["transfer-encoding"] == "chunked"
    data = b"".join(chunks)
    # the total after the trims is not known up front
    assert int.from_bytes(data[40:44], "little") == 0xFFFFFFFF
    want = list(synth.synthesize_long_stream(LONG, seed=3, pcm16=True,
                                             crossfade_ms=20.0))
    assert len(chunks) == len(want)
    assert data[HEADER:] == np.concatenate(want).astype("<i2").tobytes()


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/synthesize", "this is not json", 400),
    ("POST", "/synthesize", json.dumps({"seed": 1}), 400),
    ("POST", "/nope", "{}", 404),
    ("GET", "/nope", None, 404),
])
def test_bad_requests(servers, method, path, body, code):
    status, _, _ = _request(servers["ports"]["main"], method, path, body)
    assert status == code


def test_overload_is_rejected_then_recovers(servers):
    """A burst of 16 against batch 1 and a queue bound of 2: the overflow
    gets 429 at once and admitted work completes; streamers beyond the two
    slots get 429 after 0.05 s; afterwards a request is served."""
    port = servers["ports"]["overload"]
    results = []
    lock = threading.Lock()

    def call(i, stream):
        status, data, _ = _post(port, {"text": f"overload {i}",
                                       "stream": stream}, timeout=180)
        with lock:
            results.append((stream, status, data))

    threads = [threading.Thread(target=call, args=(i, i % 4 == 0))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 16
    assert {s for _, s, _ in results} <= {200, 429}
    for stream in (False, True):
        statuses = [s for st, s, _ in results if st == stream]
        assert 200 in statuses and 429 in statuses, (stream, statuses)
    assert all(d[:4] == b"RIFF" for _, s, d in results if s == 200)
    _, body, _ = _request(port, "GET", "/stats")
    stats = json.loads(body)
    assert stats["rejected"] == sum(s == 429 for _, s, _ in results)
    assert stats["errors"] == 0
    status, data, _ = _post(port, {"text": "after the storm"}, timeout=180)
    assert status == 200 and data[:4] == b"RIFF"


def test_stats_fields(servers):
    port = servers["ports"]["main"]
    assert _post(port, {"text": "stats probe"})[0] == 200
    status, body, _ = _request(port, "GET", "/stats")
    stats = json.loads(body)
    assert status == 200
    assert set(stats) == {
        "requests", "errors", "streamed", "rejected", "uptime_s",
        "queue_depth", "max_queue", "batches_in_flight",
        "requests_in_flight", "latency_s_p50", "latency_s_p90"}
    assert stats["requests"] >= 1 and stats["errors"] == 0
    assert stats["max_queue"] == 32 and stats["queue_depth"] == 0
    assert 0 < stats["latency_s_p50"] <= stats["latency_s_p90"]


def test_speakers_listed_and_unknown_rejected(servers):
    port = servers["ports"]["prompted"]
    status, body, _ = _request(port, "GET", "/speakers")
    assert status == 200 and json.loads(body) == ["alice", "bob"]
    assert _post(port, {"text": "hello", "speaker": "nobody"})[0] == 400


def test_short_speaker_is_padded_by_its_last_frame(servers, prompted_synth):
    """bob's reference is 4 frames long: its prompt repeats the last frame
    up to prompt_frames, and the padding row of the batch is zeros."""
    from prompt_tts_tpu_torch.utils.wav import read_wav
    status, data, _ = _post(servers["ports"]["prompted"],
                            {"text": "hello", "speaker": "bob", "seed": 1})
    assert status == 200
    synth = prompted_synth
    audio, sr = read_wav(str(servers["speakers"] / "bob.wav"))
    codes = synth.encode_audio(resample(audio, sr, 24000)[None, :, 0])
    codes = codes[0].numpy()
    assert codes.shape == (8, 4)
    prompt = np.concatenate([codes, np.repeat(codes[:, -1:], 4, 1)], 1)
    want = synth.synthesize(["hello", ""], seed=1, pcm16=True,
                            prompt_codes=np.stack([prompt,
                                                   np.zeros_like(prompt)]))
    assert _pcm(data) == want[0].astype("<i2").tobytes()


def test_speakers_need_the_prompt_family(servers):
    proc = subprocess.run(
        [sys.executable, "-m", "prompt_tts_tpu_torch.cli.serve",
         "--device", "cpu", "--port", "0", "--config_file",
         str(servers["root"] / "tiny.json"), "--speakers",
         str(servers["speakers"])],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert "prompt-conditioned" in proc.stderr


def test_speaker_registry_is_jax(servers, prompted_synth):
    """``load_speakers`` against the JAX server's own registry lines (read,
    resample, encode, crop or repeat-pad to prompt_frames), run with JAX's
    wav reader and resampler on the port's encoder: the same codes for a
    long (cropped) and a short (padded) reference."""
    from prompt_tts_tpu.utils.resample import resample as jax_resample
    from prompt_tts_tpu.utils.wav import read_wav as jax_read_wav
    spk = servers["speakers"]
    body = _jax_serve_lines("audio, sr = read_wav(os.path.join(",
                            "speakers[os.path.splitext(name)[0]] = fixed")
    ns = {"os": os, "np": np, "read_wav": jax_read_wav,
          "resample": jax_resample, "SAMPLE_RATE": 24000, "speakers": {},
          "tp": PROMPTED["prompt_frames"],
          "args": types.SimpleNamespace(speakers=str(spk)),
          "synth": types.SimpleNamespace(encode_audio=lambda a: (
              prompted_synth.encode_audio(a).numpy()))}
    for name in sorted(os.listdir(spk)):
        exec(body, dict(ns, name=name))
    got = serve.load_speakers(prompted_synth, str(spk))
    assert list(got) == list(ns["speakers"]) == ["alice", "bob"]
    for name, want in ns["speakers"].items():
        assert got[name].dtype == want.dtype
        np.testing.assert_array_equal(got[name], want)


@pytest.mark.parametrize("frames", [24, 25, 900])
def test_quantize_chunk_is_jax(frames):
    """``default_chunk`` and ``quantize_chunk`` against the JAX server's
    lines for every client chunk up to twice the window."""
    ns = {"T_frames": frames}
    exec(_jax_serve_lines("default_chunk = min(",
                          "return min(k * default_chunk"), ns)
    assert serve.default_chunk(frames) == ns["default_chunk"]
    for chunk in range(2 * frames + 2):
        assert serve.quantize_chunk(chunk, frames) == (
            ns["quantize_chunk"](chunk))


class _Recorder:
    """A stand-in ``Synthesizer`` that records what a batcher dispatches
    and answers each call with a small int16 wav (a torch tensor and no
    event for the port's batcher, an array for JAX's)."""
    device = "cpu"

    def __init__(self, port: bool):
        self.port = port
        self.calls = []

    def synthesize_async(self, texts, seed=0, pcm16=False,
                         prompt_codes=None):
        self.calls.append((list(texts), seed, pcm16, None if prompt_codes
                           is None else np.array(prompt_codes)))
        k = len(self.calls)
        wav = (np.arange(len(texts) * 5, dtype=np.int16) * k).reshape(
            len(texts), 5)
        return (torch.from_numpy(wav), None) if self.port else wav


@pytest.mark.parametrize("prompted", [False, True])
def test_batcher_is_jax(prompted):
    """The port's ``_Batcher`` against JAX's on the same requests: the
    batch padded to ``max_batch`` with empty texts, the first request's
    seed for all, zero prompt rows for the padding, pcm16, and each
    request's own row back."""
    from prompt_tts_tpu.cli import serve as jax_serve
    got = {}
    for name, cls in (("port", serve._Batcher), ("jax", jax_serve._Batcher)):
        synth = _Recorder(port=name == "port")
        batcher = cls(synth, 4, 0.5, prompted=prompted, max_queue=8)
        slots = [batcher.submit(
            f"text {i}", seed=10 + i, prompt_codes=np.full(
                (8, 3), i + 1, np.int32) if prompted else None)
            for i in range(3)]
        for slot in slots:
            assert slot["done"].wait(30) and "error" not in slot
        got[name] = (synth.calls, [slot["wav"] for slot in slots])
        if name == "port":
            batcher.close()
    (port_calls, port_wavs), (jax_calls, jax_wavs) = got["port"], got["jax"]
    assert len(port_calls) == len(jax_calls) == 1
    (texts, seed, pcm16, prompts), want = port_calls[0], jax_calls[0]
    assert (texts, seed, pcm16) == want[:3] == (
        ["text 0", "text 1", "text 2", ""], 10, True)
    if prompted:
        np.testing.assert_array_equal(prompts, want[3])
        assert not prompts[3].any()
    else:
        assert prompts is None and want[3] is None
    for a, b in zip(port_wavs, jax_wavs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sigterm_drains_in_flight_then_exits_0(servers):
    """Runs last in this module: it stops the main server.  A request in
    its batch window when SIGTERM arrives still gets its WAV."""
    proc, port = servers["procs"]["main"], servers["ports"]["main"]
    result = {}

    def call():
        result["r"] = _post(port, {"text": "in flight"})

    t = threading.Thread(target=call)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        _, body, _ = _request(port, "GET", "/stats")
        if json.loads(body)["requests_in_flight"]:
            break
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)
    t.join(120)
    assert not t.is_alive()
    assert result["r"][0] == 200 and result["r"][1][:4] == b"RIFF"
    assert proc.wait(timeout=60) == 0
