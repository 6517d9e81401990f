"""The ``ptts`` op namespace: each hand-written kernel as a
``torch.library`` op.

Each wrapper module of ``ops/cuda/`` defines its kernel's op here, with a
CUDA implementation (the launcher: its checks, scratch, launch count and
operation count), a CPU one (the kernel's plain version) and a fake one
(shapes, dtypes and strides alone).  ``torch.export`` traces the ops as
single nodes, so an exported program runs the same kernels as the live
path, and the same plain versions on the CPU.  Eager calls skip the
dispatcher and call the launcher directly (:func:`traced` is False).
"""

import torch

LIB = torch.library.Library("ptts", "DEF")


def traced() -> bool:
    """Whether the caller is being traced (``torch.export``,
    ``torch.compile``): a wrapper then calls its op, which a graph can
    hold, in place of its launcher, which reads raw pointers."""
    return torch.compiler.is_compiling()
