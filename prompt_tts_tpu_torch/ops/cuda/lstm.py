"""Wrappers of the two hand-written LSTM recurrence kernels.

One layer's recurrence over precomputed input projections, gate order i,
f, g, o (torch's), zero initial state, f32, in two schedules:

* :func:`lstm_recurrence` (``csrc/lstm.cu``), the port of the TPU kernel
  ``prompt_tts_tpu/ops/pallas/lstm.py:lstm_recurrence``: w_hh ``[H, 4H]``,
  one step kernel per timestep;
* :func:`lstm_recurrence_t` (``csrc/lstm_t.cu``), the port of
  ``lstm_recurrence_t``: w_hh_t ``[4H, H]`` in torch layout, one persistent
  cooperative launch with a grid barrier per step.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  ``.launches`` counts the calls that launched a kernel (one per
layer).
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


def lstm_recurrence_t_plain(x_proj: torch.Tensor,
                            w_hh_t: torch.Tensor) -> torch.Tensor:
    """x_proj ``[T, B, 4H]``, w_hh_t ``[4H, H]`` -> h ``[T, B, H]`` (f32):
    the recurrence with ``h @ w_hh_t.T``, as a Python loop."""
    T, B, G = x_proj.shape
    H = w_hh_t.shape[1]
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    out = []
    for t in range(T):
        gates = x_proj[t] + h @ w_hh_t.T
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


def _lib_t():
    lib = _build.load("lstm_t")
    if lib.ptts_lstm_recurrence_t.argtypes is None:
        lib.ptts_lstm_t_max_ctas.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ptts_lstm_t_max_ctas.restype = ctypes.c_int
        lib.ptts_lstm_recurrence_t.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ptts_lstm_recurrence_t.restype = ctypes.c_int
    return lib


# hidden units a CTA of the persistent kernel owns (csrc/lstm_t.cu: K)
UNITS_PER_CTA = 4


def lstm_t_grid(B: int, H: int, device=None):
    """``(grid, max_ctas)`` of the persistent kernel at batch ``B`` on
    ``device``: ``H / UNITS_PER_CTA`` CTAs, which must all be resident, and
    the most the card holds at once.  Raises where the grid does not fit: a
    grid barrier over CTAs that are not co-resident would deadlock."""
    m = ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib_t().ptts_lstm_t_max_ctas(B, H, ctypes.byref(m))
    _build.check(err, "lstm_recurrence_t occupancy")
    grid = H // UNITS_PER_CTA
    if grid > m.value:
        raise RuntimeError(
            f"lstm_recurrence_t: H={H} at B={B} cannot be covered by "
            f"co-resident CTAs ({grid} CTAs, {m.value} fit on this card)")
    return grid, m.value


def lstm_recurrence_t(x_proj: torch.Tensor,
                      w_hh_t: torch.Tensor) -> torch.Tensor:
    """The persistent schedule: x_proj ``[T,B,4H]`` f32, w_hh_t ``[4H,H]``
    f32 -> hidden states ``[T,B,H]`` f32."""
    if x_proj.dim() != 3 or w_hh_t.dim() != 2:
        raise ValueError("lstm_recurrence_t: x_proj [T,B,4H], w_hh_t [4H,H]")
    T, B, G = x_proj.shape
    H = w_hh_t.shape[1]
    if G != 4 * H or w_hh_t.shape[0] != G:
        raise ValueError(f"lstm_recurrence_t: x_proj last dim {G} and "
                         f"w_hh_t {tuple(w_hh_t.shape)} do not match 4*H "
                         f"({4 * H})")
    if x_proj.device.type == "cpu":
        return lstm_recurrence_t_plain(x_proj, w_hh_t)
    if x_proj.device.type != "cuda" or w_hh_t.device != x_proj.device:
        raise ValueError(f"lstm_recurrence_t: x_proj on {x_proj.device}, "
                         f"w_hh_t on {w_hh_t.device}")
    if x_proj.dtype != torch.float32 or w_hh_t.dtype != torch.float32:
        raise ValueError("lstm_recurrence_t: x_proj and w_hh_t must be "
                         "float32")
    if not (x_proj.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_recurrence_t: inputs must be contiguous")
    if H % UNITS_PER_CTA:
        raise ValueError(f"lstm_recurrence_t: hidden size {H} must be a "
                         f"multiple of {UNITS_PER_CTA}")
    lstm_t_grid(B, H, x_proj.device)
    out = torch.empty(T, B, H, device=x_proj.device, dtype=torch.float32)
    barrier = torch.empty(2, device=x_proj.device, dtype=torch.int32)
    with torch.cuda.device(x_proj.device):
        err = _lib_t().ptts_lstm_recurrence_t(
            x_proj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(),
            barrier.data_ptr(), T, B, H,
            _build.stream_handle(x_proj.device))
    _build.check(err, "persistent LSTM kernel launch")
    lstm_recurrence_t.launches += 1
    return out


lstm_recurrence_t.launches = 0
