"""Polyphase windowed-sinc resampling (host-side numpy).

Equivalent role to the reference's ``encodec.utils.convert_audio``
(torchaudio sinc resampling, used at generate_code.py:28) for converting
corpus audio (e.g. LJSpeech 22.05 kHz) to the codec's 24 kHz.
"""

import math

import numpy as np


def resample(audio: np.ndarray, orig_sr: int, target_sr: int,
             zeros: int = 24, beta: float = 14.77) -> np.ndarray:
    """Resample mono/``[T, C]`` audio with a Kaiser-windowed sinc kernel."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g

    squeeze = audio.ndim == 1
    x = audio[:, None] if squeeze else audio
    T, C = x.shape

    # build polyphase kernel: cutoff at the lower Nyquist
    cutoff = 0.5 * min(1.0, up / down)
    half_width = zeros / (2.0 * cutoff)
    kernel_width = int(2 * half_width * up) + 1
    t = (np.arange(kernel_width) - (kernel_width - 1) / 2) / up
    window = np.kaiser(kernel_width, beta)
    kernel = np.sinc(2 * cutoff * t) * 2 * cutoff * window
    kernel /= kernel.sum() / up  # unity gain after upsampling

    out_len = int(math.ceil(T * up / down))
    pad = (kernel_width // up) + 1
    xp = np.pad(x, ((pad, pad), (0, 0)))

    # output sample n lands at input position n*down/up
    n = np.arange(out_len)
    pos = n * down  # in units of 1/up input samples
    in_idx = pos // up + pad
    phase = (-pos) % up  # kernel tap offset

    taps = np.arange(0, kernel_width, up)
    out = np.zeros((out_len, C), np.float32)
    for p in range(up):
        sel = phase == p
        if not sel.any():
            continue
        k = kernel[p::up]
        base = in_idx[sel] - (len(k) // 2)
        acc = np.zeros((sel.sum(), C), np.float32)
        for j in range(len(k)):
            idx = np.clip(base + j, 0, xp.shape[0] - 1)
            acc += k[j] * xp[idx]
        out[sel] = acc
    return out[:, 0] if squeeze else out
