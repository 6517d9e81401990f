"""Mel spectrograms + mel distance (host-side numpy).

The port's copy of ``prompt_tts_tpu/utils/mel.py``, with the same output
bits: log-mel spectrograms (librosa-style Slaney mel filterbank, HTK off)
and an L1/L2 distance between two waveforms, the decoded-audio fidelity
measure of BASELINE.md.  A waveform shorter than one FFT frame raises
``ValueError`` here.
"""

import numpy as np


def _hz_to_mel(f):
    # Slaney scale: linear below 1 kHz, log above
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                             * (m - 15.0)), f)
    return f


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular Slaney-normalized filterbank."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, mid, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(mid - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - mid, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # Slaney area normalization
    return fb.astype(np.float32)


def log_mel(wav: np.ndarray, sr: int = 24000, n_fft: int = 1024,
            hop: int = 256, n_mels: int = 80) -> np.ndarray:
    """Waveform [T] -> log-mel [frames, n_mels]."""
    wav = np.asarray(wav, np.float32)
    # the JAX module tests n_frames < 1, which never holds, and indexes
    # past the end of a shorter waveform (IndexError)
    if len(wav) < n_fft:
        raise ValueError("waveform shorter than one FFT frame")
    n_frames = 1 + (len(wav) - n_fft) // hop
    window = np.hanning(n_fft).astype(np.float32)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels)
    mel = spec @ fb.T
    return np.log(np.maximum(mel, 1e-10)).astype(np.float32)


def mel_distance(wav_a: np.ndarray, wav_b: np.ndarray, sr: int = 24000,
                 ord: int = 1) -> float:
    """Mean L1 (or L2) log-mel distance between two same-length waveforms."""
    n = min(len(wav_a), len(wav_b))
    ma = log_mel(np.asarray(wav_a)[:n], sr)
    mb = log_mel(np.asarray(wav_b)[:n], sr)
    d = np.abs(ma - mb) if ord == 1 else (ma - mb) ** 2
    return float(d.mean())
