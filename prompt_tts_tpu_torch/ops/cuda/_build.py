"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``.  The hash covers the
source, the headers of ``csrc/`` and the compiler flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Each
source has its own lock, so several sources build at once from several
threads (:func:`load_all`).  Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()   # guards _locks
_locks: dict = {}
_libs: dict = {}
# seconds spent compiling each library in this process (0.0 = loaded as built)
build_seconds: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        # the headers of csrc/ are part of every source they may reach
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        build_seconds[name] = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            # build into a temporary name, then rename: a concurrent or
            # interrupted build never leaves a half-written library behind
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                (BUILD_DIR / f"{name}.log").write_text(proc.stdout
                                                       + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {src}:\n"
                                       f"{proc.stderr[-4000:]}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_seconds[name] = time.perf_counter() - t0
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def load_all(names) -> None:
    """Build and load several sources at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load, names))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def stream_handle(device) -> int:
    """The ``cudaStream_t`` of torch's current stream on ``device`` (a
    CUDA ``torch.device``), for a kernel's C entry point: the raw handle,
    without building a ``torch.cuda.Stream`` (a tenth of a microsecond
    against some ten on the host)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
