"""The full-f32 scope: TF32 off for f32 convolutions and matmuls.

The synthesis programs (``pipeline.py``) and an exported artifact's loader
(``aot.py``) enter it around the same pieces, since a traced graph does not
record the process-wide TF32 flags.
"""

import contextlib
import threading

import torch

# full_f32's process-wide scope: how many entries are open, and the flags
# saved at the first of them
_f32_lock = threading.Lock()
_f32_scope = {"depth": 0, "saved": None}


@contextlib.contextmanager
def full_f32():
    """Run f32 convolutions and matmuls in full f32, not TF32.

    cuDNN convolutions default to TF32 on the card (about three decimal
    digits), which would miss the codec's 1e-5 decode contract.  The flags
    are process-global, so the scope is too: they go off at the first
    entry from any thread and come back at the last exit, and a thread
    still inside never has them restored under it.  A thread outside the
    scope may meanwhile compute without TF32: only more exact.
    """
    with _f32_lock:
        if _f32_scope["depth"] == 0:
            _f32_scope["saved"] = (torch.backends.cudnn.allow_tf32,
                                   torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_scope["depth"] += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_scope["depth"] -= 1
            if _f32_scope["depth"] == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _f32_scope["saved"]


def denoise_scope(dtype: torch.dtype):
    """The scope of the conditioning and the sampler steps: full f32 for
    an f32 denoiser, none for bf16."""
    return full_f32() if dtype == torch.float32 else contextlib.nullcontext()
