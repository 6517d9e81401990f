"""The operations of each hand-written kernel's call: one formula each.

``chip_smoke.py`` divides them by the card's peak rate for a call's least
time, and ``cli/profile.py`` adds them to the FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts: a kernel is a
``ctypes`` launch, which no PyTorch dispatch mode sees.  Each formula
counts two operations a multiply-add of the products the kernel computes,
which is what the counter gives the plain versions' ``einsum``, ``@`` and
``conv1d`` on a CPU tensor; the LSTM's adds its gate arithmetic as well.

Each wrapper calls :func:`record` where it launches its kernel;
:class:`KernelOps` sums what is recorded while it is open.
"""

import threading
from typing import List

_lock = threading.Lock()
_open: List["KernelOps"] = []


def attention_fwd(B: int, Tq: int, Tk: int, H: int, D: int) -> int:
    """q k^T and p v: two [Tq, Tk, D] products a head."""
    return 4 * B * H * Tq * Tk * D


def attention_bwd(B: int, Tq: int, Tk: int, H: int, D: int) -> int:
    """The recomputed scores, dv, dp, dq and dk: five [Tq, Tk, D]
    products a head."""
    return 10 * B * H * Tq * Tk * D


def lstm(T: int, B: int, H: int) -> int:
    """T steps of h @ W_hh ([B, H] x [H, 4H]) and the gates' ten
    elementwise operations an element of h."""
    return T * B * (2 * H * 4 * H + 10 * H)


def resnet_block(B: int, T: int, cin: int, cout: int) -> int:
    """conv1 (k3, cin -> cout), conv2 (k3, cout -> cout) and the 1x1
    shortcut where the widths differ, over B x T positions."""
    w = 3 * cin * cout + 3 * cout * cout + (cin * cout if cin != cout else 0)
    return 2 * B * T * w


def rvq_encode(N: int, n_q: int, K: int, D: int) -> int:
    """Each of N vectors against each of K codes of each of n_q layers."""
    return 2 * N * n_q * K * D


def record(ops: int) -> None:
    """Add one kernel launch's operations to every open :class:`KernelOps`."""
    if not _open:       # the common case: nothing counts
        return
    with _lock:
        for counter in _open:
            counter.total += ops


class KernelOps:
    """``with KernelOps() as k: ...``: ``k.total`` is the operations of the
    kernel launches made inside."""

    def __init__(self):
        self.total = 0

    def __enter__(self) -> "KernelOps":
        with _lock:
            _open.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            _open.remove(self)
