"""Wrapper of the hand-written LSTM recurrence kernel (``csrc/lstm.cu``).

Port of the TPU kernel ``prompt_tts_tpu/ops/pallas/lstm.py:
lstm_recurrence``: one layer's recurrence over precomputed input
projections, gate order i, f, g, o (torch's), zero initial state, f32.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`lstm_recurrence_plain`.  ``lstm_recurrence.launches`` counts calls
that launched the kernel (one per layer; the library issues one step
kernel per timestep inside that call).
"""

import ctypes

import torch

from prompt_tts_tpu_torch.ops.cuda import _build


def lstm_recurrence_plain(x_proj: torch.Tensor,
                          w_hh: torch.Tensor) -> torch.Tensor:
    """x_proj ``[T, B, 4H]``, w_hh ``[H, 4H]`` -> h ``[T, B, H]`` (f32).

    The per-step scan of ``CodecLSTM`` (prompt_tts_tpu/codec/layers.py:
    154-169) written as a Python loop.
    """
    T, B, G = x_proj.shape
    H = w_hh.shape[0]
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    out = []
    for t in range(T):
        gates = x_proj[t] + h @ w_hh
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


def _fn():
    lib = _build.load("lstm")
    fn = lib.ptts_lstm_recurrence
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lstm_recurrence(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Run the LSTM recurrence: x_proj ``[T,B,4H]`` f32, w_hh ``[H,4H]`` f32
    -> hidden states ``[T,B,H]`` f32."""
    if x_proj.dim() != 3 or w_hh.dim() != 2:
        raise ValueError("lstm_recurrence: x_proj [T,B,4H], w_hh [H,4H]")
    T, B, G = x_proj.shape
    H = w_hh.shape[0]
    if G != 4 * H or w_hh.shape[1] != G:
        raise ValueError(f"lstm_recurrence: x_proj last dim {G} and w_hh "
                         f"{tuple(w_hh.shape)} do not match 4*H ({4 * H})")
    if x_proj.device.type == "cpu":
        return lstm_recurrence_plain(x_proj, w_hh)
    if x_proj.device.type != "cuda" or w_hh.device != x_proj.device:
        raise ValueError(f"lstm_recurrence: x_proj on {x_proj.device}, "
                         f"w_hh on {w_hh.device}")
    if x_proj.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise ValueError("lstm_recurrence: x_proj and w_hh must be float32")
    if not (x_proj.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm_recurrence: inputs must be contiguous")
    if H % 16 or H > 1280:
        raise ValueError(f"lstm_recurrence: hidden size {H} must be a "
                         f"multiple of 16 and at most 1280")
    out = torch.empty(T, B, H, device=x_proj.device, dtype=torch.float32)
    c = torch.empty(B, H, device=x_proj.device, dtype=torch.float32)
    with torch.cuda.device(x_proj.device):
        err = _fn()(x_proj.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                    c.data_ptr(), T, B, H,
                    _build.stream_handle(x_proj.device))
    _build.check(err, "LSTM kernel launch")
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
