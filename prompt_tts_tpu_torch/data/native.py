"""ctypes bindings for the native data-loading core (``native/ptts_io.cpp``).

The port's copy of ``prompt_tts_tpu/data/native.py``.  The library is built
on first use with ``g++`` into ``build/native/libptts_io-<hash>.so`` at the
root of the checkout (the hash covers the source and the flags), through a
temporary file and ``os.replace``, so two processes building at once never
load a half-written library.  The JAX package builds its own
``native/libptts_io.so``; the port never writes or loads that file.

Every entry point keeps the JAX module's numpy fallback, taken when no
compiler is present; :func:`available` says which path runs.  The build
turns off floating-point contraction, so the native collate gives numpy's
bits (the JAX package's build may fuse a multiply-add, one ulp away).
"""

import ctypes
import hashlib
import io
import os
import subprocess
import tarfile
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "ptts_io.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# no FMA contraction: the collate's c * scale - 1 then rounds twice, as
# numpy does, so its latents are the in-RAM dataset's bits
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_lib_failed = False


class _TarEntry(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 256),
        ("offset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
    ]


def _build() -> Optional[Path]:
    """The built library's path (compiling it if needed), or None when the
    source or the compiler is missing or the build fails."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libptts_io-{digest[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if
    unavailable (the numpy fallbacks run instead)."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build()
        if so is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _lib_failed = True
            return None
        lib.ptts_tar_index.restype = ctypes.c_int64
        lib.ptts_tar_index.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_TarEntry), ctypes.c_int64]
        lib.ptts_read_at.restype = ctypes.c_int
        lib.ptts_read_at.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.ptts_npy_to_i16.restype = ctypes.c_int
        lib.ptts_npy_to_i16.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.ptts_collate_codes.restype = None
        lib.ptts_collate_codes.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library runs, False when the numpy fallbacks
    do."""
    return get_lib() is not None


def tar_index(path: str, max_entries: int = 1 << 20
              ) -> List[Tuple[str, int, int]]:
    """``[(member_name, payload_offset, size)]`` of a plain tar file."""
    lib = get_lib()
    if lib is None:
        return _tar_index_py(path)
    entries = (_TarEntry * max_entries)()
    n = lib.ptts_tar_index(path.encode(), entries, max_entries)
    if n < 0:
        raise IOError(f"cannot index tar {path}")
    return [(entries[i].name.decode(), entries[i].offset, entries[i].size)
            for i in range(n)]


def _tar_index_py(path: str) -> List[Tuple[str, int, int]]:
    with tarfile.open(path, "r:") as tf:
        return [(m.name, m.offset_data, m.size) for m in tf.getmembers()
                if m.isfile()]


def read_at(path: str, offset: int, size: int) -> bytes:
    """``size`` bytes of ``path`` at ``offset`` (a ``pread``)."""
    lib = get_lib()
    if lib is None:
        return _read_at_py(path, offset, size)
    buf = (ctypes.c_uint8 * size)()
    rc = lib.ptts_read_at(path.encode(), offset, size, buf)
    if rc != 0:
        raise IOError(f"read_at failed rc={rc}")
    return bytes(buf)


def _read_at_py(path: str, offset: int, size: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(size)


def npy_to_i16(buf: bytes) -> np.ndarray:
    """Parse an integer ``[n_q, T]`` .npy buffer into an int16 array."""
    lib = get_lib()
    if lib is None:
        return _npy_to_i16_py(buf)
    # worst case: all of the payload is int16 data
    out = np.empty(len(buf) // 2 + 16, np.int16)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    src = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    rc = lib.ptts_npy_to_i16(
        src, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"npy parse failed rc={rc}")
    return out[: rows.value * cols.value].reshape(rows.value,
                                                   cols.value).copy()


def _npy_to_i16_py(buf: bytes) -> np.ndarray:
    return np.load(io.BytesIO(buf)).astype(np.int16)


def collate_codes(codes: np.ndarray) -> np.ndarray:
    """int16 ``[B, n_q, T]`` -> float32 latents ``[B, T, n_q]`` in [-1, 1]."""
    codes = np.ascontiguousarray(codes, np.int16)
    B, n_q, T = codes.shape
    lib = get_lib()
    if lib is None:
        from prompt_tts_tpu_torch.data.dataset import collate_codes as py
        return py(codes)
    out = np.empty((B, T, n_q), np.float32)
    lib.ptts_collate_codes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), B, n_q, T,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
