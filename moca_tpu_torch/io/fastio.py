"""ctypes bindings for the in-repo host library native/fastio.cpp.

Port of moca_tpu/io/fastio.py. The port builds the library itself at first
use, with the host C++ compiler ($CXX, else g++) and native/Makefile's flags,
into build/fastio/ under the checkout (the file name carries a digest of the
source and flags, so an edit rebuilds); it never writes into native/ and
never loads a library built elsewhere. Without a compiler `available()` is
false and io/video.py takes its numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "fastio.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "fastio")
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")  # native/Makefile
ABI_VERSION = 1

_LIB = None  # the loaded library, or the OSError that its build or load raised


def _build() -> str:
    """The library's path, compiled first if no build of this source exists."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libfastio-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *FLAGS, "-o", tmp, SOURCE, "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise OSError(f"{' '.join(cmd)} failed: {out.stderr[-2000:]}")
        os.replace(tmp, path)  # atomic: concurrent builds race harmlessly
    except FileNotFoundError as exc:  # no compiler
        raise OSError(f"cannot build {SOURCE}: {exc}") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _LIB
    if _LIB is None:
        try:
            lib = ctypes.CDLL(_build())
            lib.float_to_uint8.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
            lib.float_to_uint8.restype = None
            lib.uint8_to_float.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            lib.uint8_to_float.restype = None
            lib.pack_frames.argtypes = [
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t, ctypes.c_size_t]
            lib.pack_frames.restype = None
            lib.fastio_abi_version.argtypes = []
            lib.fastio_abi_version.restype = ctypes.c_int
            if lib.fastio_abi_version() != ABI_VERSION:
                raise OSError(f"fastio ABI {lib.fastio_abi_version()} != {ABI_VERSION}")
            _LIB = lib
        except OSError as exc:
            _LIB = exc
    if isinstance(_LIB, OSError):
        raise _LIB
    return _LIB


def available() -> bool:
    """True when the library builds and loads (tried once a process)."""
    try:
        _load()
        return True
    except OSError:
        return False


def float_to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float32 -> uint8, ((x + 1) * 127.5) clamped (funcs.py:630-640)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.uint8)
    lib.float_to_uint8(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), x.size)
    return out


def uint8_to_float(x: np.ndarray) -> np.ndarray:
    """uint8 -> [-1, 1] float32 as x * (2/255) - 1 (funcs.py:565; within one
    float32 rounding of numpy's (x / 255 - 0.5) * 2)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.uint8)
    out = np.empty(x.shape, np.float32)
    lib.uint8_to_float(x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
    return out


def pack_frames(frames) -> np.ndarray:
    """Equally shaped uint8 frames -> one contiguous [T, ...] clip buffer
    (a threaded copy in native/fastio.cpp in place of np.stack's)."""
    lib = _load()
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    shape = frames[0].shape
    if any(f.shape != shape for f in frames):
        raise ValueError("pack_frames requires equally-shaped frames")
    out = np.empty((len(frames),) + shape, np.uint8)
    ptr_t = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (ptr_t * len(frames))(*[f.ctypes.data_as(ptr_t) for f in frames])
    lib.pack_frames(ptrs, out.ctypes.data_as(ptr_t), len(frames), frames[0].nbytes)
    return out
