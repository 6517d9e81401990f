"""Minimal WAV read/write (PCM16 / float32) in pure numpy.

Replaces the reference's soundfile/torchaudio usage for the core paths
(reference decode_codec.py:29-33, generate_code.py:25) — neither package is
a dependency of this framework.
"""

import struct
import wave
from typing import Tuple

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono/multichannel float audio in [-1, 1] as PCM16 WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def wav_header(n_samples, sample_rate: int, channels: int = 1) -> bytes:
    """PCM16 WAV header for a known total length (streaming writers emit
    this first, then raw PCM16 frames).

    ``n_samples=None`` emits the standard unknown-length streaming header
    (RIFF and data sizes 0xFFFFFFFF): players treat it as
    read-until-connection-close, which is how a server streams audio
    whose final length (e.g. post-trim long-form) isn't known upfront."""
    if n_samples is None:
        data_bytes = 0xFFFFFFFF             # conventional "unknown" marker
    else:
        data_bytes = n_samples * channels * 2
    return b"".join([
        b"RIFF", struct.pack("<I", min(36 + data_bytes, 0xFFFFFFFF)),
        b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             sample_rate * channels * 2, channels * 2, 16),
        b"data", struct.pack("<I", data_bytes),
    ])


def pcm16_bytes(audio: np.ndarray) -> bytes:
    """float audio in [-1, 1] -> raw little-endian PCM16 frames."""
    return np.clip(np.round(np.asarray(audio) * 32767.0),
                   -32768, 32767).astype("<i2").tobytes()


def read_wav(path_or_file) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 audio [T, C] in [-1, 1], sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE float32 (manual RIFF parse for the
    float case, which the wave module rejects).
    """
    data = (open(path_or_file, "rb").read()
            if isinstance(path_or_file, str) else path_or_file.read())
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:          # IEEE float
        audio = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):             # PCM / extensible
        if bits == 16:
            audio = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            audio = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            audio = (np.frombuffer(raw, "u1").astype(np.float32) - 128) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            audio = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format {audio_format}")

    audio = audio.reshape(-1, channels)
    return audio, sample_rate


def trim_trailing_silence(wav: np.ndarray, frame: int = 1024,
                          threshold_db: float = -40.0) -> np.ndarray:
    """Drop trailing frames whose RMS is below ``threshold_db`` of peak.

    Used by long-form synthesis to cut the padded tail each fixed-length
    chunk carries (the model always emits its full 12 s window).
    """
    n = (len(wav) // frame) * frame
    if n == 0:
        return wav
    # float32 for the RMS math: squaring int16 PCM in its own dtype wraps
    frames = np.asarray(wav[:n], dtype=np.float32).reshape(-1, frame)
    rms = np.sqrt((frames ** 2).mean(axis=1) + 1e-12)
    floor = rms.max() * (10.0 ** (threshold_db / 20.0))
    active = np.nonzero(rms > floor)[0]
    if len(active) == 0:
        return wav
    end = min(len(wav), int(active[-1] + 2) * frame)
    return wav[:end]


def crossfade_join(pieces, n: int) -> np.ndarray:
    """Join 1-D wav pieces with an ``n``-sample equal-power crossfade.

    Adjacent long-form windows are synthesized from INDEPENDENT noise, so
    their seams are uncorrelated signals: an equal-power (sin/cos) fade
    keeps the summed energy constant through the overlap, where a linear
    fade would dip up to 3 dB at the midpoint.  Each join consumes ``n``
    samples of overlap (output length = sum(len) - (k-1) * n for k
    pieces, when every piece is longer than ``n``).

    Works for float wavs and int16 PCM alike: the blend math runs in
    float32 and int16 inputs are re-quantized round-half-to-even on the
    way out (same rounding as :func:`pcm16_bytes`).
    """
    pieces = [np.asarray(p) for p in pieces if len(p)]
    if not pieces:
        return np.zeros(0, np.float32)
    int_out = all(p.dtype == np.int16 for p in pieces)
    out = pieces[0].astype(np.float32)
    for p in pieces[1:]:
        p = p.astype(np.float32)
        k = min(int(n), len(out), len(p))
        if k <= 0:
            out = np.concatenate([out, p])
            continue
        theta = (np.arange(k, dtype=np.float32) + 0.5) * (np.pi / 2 / k)
        blend = out[-k:] * np.cos(theta) + p[:k] * np.sin(theta)
        out = np.concatenate([out[:-k], blend, p[k:]])
    if int_out:
        out = np.clip(np.round(out), -32768, 32767).astype(np.int16)
    return out
