"""Wrappers of the two hand-written LSTM recurrence kernels.

One layer's recurrence over precomputed input projections, gate order i,
f, g, o (torch's), zero initial state, f32, in two schedules:

* :func:`lstm_recurrence` (``csrc/lstm.cu``), the port of the TPU kernel
  ``prompt_tts_tpu/ops/pallas/lstm.py:lstm_recurrence``: w_hh ``[H, 4H]``,
  one step kernel per timestep, chained by programmatic dependent launch;
* :func:`lstm_recurrence_t` (``csrc/lstm_t.cu``), the port of
  ``lstm_recurrence_t``: w_hh_t ``[4H, H]`` in torch layout, one persistent
  cooperative launch with a grid barrier per step.

Both stage h_{t-1} in shared memory once a step and share the step's
arithmetic (``csrc/lstm.cuh``); :func:`lstm_plan` is their launch shape.
A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  ``.launches`` counts the calls that launched a kernel (one per
layer).

Each kernel is also an op, ``torch.ops.ptts.lstm_recurrence(x_proj, w_hh)``
and ``torch.ops.ptts.lstm_recurrence_t(x_proj, w_hh_t)``: the launcher
(its checks, launch plan and the persistent grid's occupancy query) on
CUDA tensors, the plain version on CPU ones (``ops/cuda/library.py``).
"""

import ctypes

import torch

from prompt_tts_tpu_torch.ops.cuda import _build, opcount
from prompt_tts_tpu_torch.ops.cuda.library import LIB, traced

# csrc/lstm.cuh: hidden units a CTA owns (both kernels), the most batch
# rows of h_{t-1} it stages at once
UNITS_PER_CTA = 4
_ROWS, _CHUNK = 4 * UNITS_PER_CTA, 32
# The most shared memory a CTA of the step kernel may take so that two fit
# an SM, as programmatic dependent launch needs (the next step's CTAs wait
# beside the running ones): an H100's 228 KB an SM, less 1 KB reserved a
# CTA, halved.
STEP_SMEM_MAX = (233472 - 2 * 1024) // 2


def lstm_plan(schedule: str, B: int, H: int) -> dict:
    """The launch shape of the ``schedule`` kernel ("step" or
    "persistent") at batch ``B`` and hidden size ``H``: ``ctas`` (H /
    UNITS_PER_CTA), ``chunk`` (the batch rows of h_{t-1} a CTA stages at
    once, padded to its register tile's 4 or 8 rows) and ``smem`` (a
    CTA's shared memory in bytes, as ``csrc/lstm.cuh:layout`` lays it
    out).

    Raises ``ValueError`` where H is not a multiple of UNITS_PER_CTA, or
    where a step kernel's CTA would leave no room for a second on an SM
    (``STEP_SMEM_MAX``: H <= 576 at B >= 32, H <= 1436 at B <= 4).  The
    persistent grid's co-residency is the card's to decide
    (:func:`lstm_t_grid`)."""
    if schedule not in ("step", "persistent"):
        raise ValueError(f"lstm_plan: unknown schedule {schedule!r}")
    if B <= 0 or H <= 0 or H % UNITS_PER_CTA:
        raise ValueError(f"LSTM kernels: hidden size {H} must be a positive "
                         f"multiple of {UNITS_PER_CTA} (batch {B})")
    chunk = min(-(-B // 4) * 4 if B <= 8 else -(-B // 8) * 8, _CHUNK)
    tile = 4 if chunk <= 8 else 8
    parts = 2 if (_ROWS // tile) * (chunk // tile) <= 4 else 1
    state_rows = chunk if schedule == "step" else B
    floats = (_ROWS * H + chunk * H + _ROWS * chunk + parts * _ROWS * chunk
              + UNITS_PER_CTA * state_rows)
    plan = {"ctas": H // UNITS_PER_CTA, "chunk": chunk, "smem": 4 * floats}
    if schedule == "step" and plan["smem"] > STEP_SMEM_MAX:
        raise ValueError(
            f"lstm_recurrence: hidden size {H} at batch {B} needs "
            f"{plan['smem']} bytes of shared memory a CTA, more than the "
            f"{STEP_SMEM_MAX} that leave room for two CTAs an SM")
    return plan


def _check_shapes(name, x_proj, w, transposed):
    """``(T, B, H)`` of x_proj ``[T,B,4H]`` and w ``[H,4H]`` (``[4H,H]``
    when ``transposed``); raises where they do not fit."""
    wants = "w_hh_t [4H,H]" if transposed else "w_hh [H,4H]"
    if x_proj.dim() != 3 or w.dim() != 2:
        raise ValueError(f"{name}: x_proj [T,B,4H], {wants}")
    T, B, G = x_proj.shape
    H = w.shape[1] if transposed else w.shape[0]
    if G != 4 * H or w.shape[0 if transposed else 1] != G:
        raise ValueError(f"{name}: x_proj last dim {G} and {wants.split()[0]} "
                         f"{tuple(w.shape)} do not match 4*H ({4 * H})")
    return T, B, H


def _check_inputs(name, x_proj, w):
    if x_proj.device.type != "cuda" or w.device != x_proj.device:
        raise ValueError(f"{name}: x_proj on {x_proj.device}, weights on "
                         f"{w.device}")
    if x_proj.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name}: x_proj and the weights must be float32")
    if not (x_proj.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if x_proj.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned (the "
                         f"kernel reads them in 16-byte pieces)")


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


def _lib():
    lib = _build.load("lstm")
    if lib.ptts_lstm_recurrence.argtypes is None:
        lib.ptts_lstm_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ptts_lstm_smem_bytes.restype = ctypes.c_longlong
        lib.ptts_lstm_recurrence.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ptts_lstm_recurrence.restype = ctypes.c_int
    return lib


def lstm_recurrence(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Run the LSTM recurrence: x_proj ``[T,B,4H]`` f32, w_hh ``[H,4H]`` f32
    -> hidden states ``[T,B,H]`` f32."""
    _check_shapes("lstm_recurrence", x_proj, w_hh, transposed=False)
    if traced():
        return torch.ops.ptts.lstm_recurrence(x_proj, w_hh)
    if x_proj.device.type == "cpu":
        return lstm_recurrence_plain(x_proj, w_hh)
    return _launch(x_proj, w_hh)


def _launch(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Check the inputs and launch the step kernel."""
    T, B, H = _check_shapes("lstm_recurrence", x_proj, w_hh, False)
    _check_inputs("lstm_recurrence", x_proj, w_hh)
    lstm_plan("step", B, H)
    out = torch.empty(T, B, H, device=x_proj.device, dtype=torch.float32)
    c = torch.empty(B, H, device=x_proj.device, dtype=torch.float32)
    with torch.cuda.device(x_proj.device):
        err = _lib().ptts_lstm_recurrence(
            x_proj.data_ptr(), w_hh.data_ptr(), out.data_ptr(), c.data_ptr(),
            T, B, H, _build.stream_handle(x_proj.device))
    _build.check(err, "LSTM kernel launch")
    lstm_recurrence.launches += 1
    opcount.record(opcount.lstm(T, B, H))
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
        lib.ptts_lstm_t_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ptts_lstm_t_smem_bytes.restype = ctypes.c_longlong
        lib.ptts_lstm_t_max_ctas.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ptts_lstm_t_max_ctas.restype = ctypes.c_int
        lib.ptts_lstm_recurrence_t.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ptts_lstm_recurrence_t.restype = ctypes.c_int
    return lib


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
    _check_shapes("lstm_recurrence_t", x_proj, w_hh_t, transposed=True)
    if traced():
        return torch.ops.ptts.lstm_recurrence_t(x_proj, w_hh_t)
    if x_proj.device.type == "cpu":
        return lstm_recurrence_t_plain(x_proj, w_hh_t)
    return _launch_t(x_proj, w_hh_t)


def _launch_t(x_proj: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """Check the inputs and launch the persistent kernel."""
    T, B, H = _check_shapes("lstm_recurrence_t", x_proj, w_hh_t, True)
    _check_inputs("lstm_recurrence_t", x_proj, w_hh_t)
    lstm_plan("persistent", B, H)
    lstm_t_grid(B, H, x_proj.device)
    out = torch.empty(T, B, H, device=x_proj.device, dtype=torch.float32)
    counter = torch.empty(1, device=x_proj.device, dtype=torch.int32)
    with torch.cuda.device(x_proj.device):
        err = _lib_t().ptts_lstm_recurrence_t(
            x_proj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(),
            counter.data_ptr(), T, B, H,
            _build.stream_handle(x_proj.device))
    _build.check(err, "persistent LSTM kernel launch")
    lstm_recurrence_t.launches += 1
    opcount.record(opcount.lstm(T, B, H))
    return out


lstm_recurrence_t.launches = 0


def _fake(x_proj: torch.Tensor, w: torch.Tensor, H) -> torch.Tensor:
    T, B, _ = x_proj.shape
    return x_proj.new_empty(T, B, H, dtype=torch.float32)


LIB.define("lstm_recurrence(Tensor x_proj, Tensor w_hh) -> Tensor")
LIB.impl("lstm_recurrence", lstm_recurrence_plain, "CPU")
LIB.impl("lstm_recurrence", _launch, "CUDA")
torch.library.register_fake(
    "ptts::lstm_recurrence", lambda x, w: _fake(x, w, w.shape[0]), lib=LIB)
LIB.define("lstm_recurrence_t(Tensor x_proj, Tensor w_hh_t) -> Tensor")
LIB.impl("lstm_recurrence_t", lstm_recurrence_t_plain, "CPU")
LIB.impl("lstm_recurrence_t", _launch_t, "CUDA")
torch.library.register_fake(
    "ptts::lstm_recurrence_t", lambda x, w: _fake(x, w, w.shape[1]), lib=LIB)
