"""The port's CUDA libraries: their build, their loading, and the kernel
wrappers' launch tallies.

Every hand-written kernel in `moca_tpu_torch/csrc/` is compiled from the
repository's sources with `nvcc` for `sm_90a` (one process per source,
started together, then linked into one library per kernel) into
`build/kernels/` beside the package, at first use, and loaded with ctypes.
`LIBRARIES` is the one table of what is built: each library's sources and
its C entry points with their argtypes, which `load_library` sets once, so a
wrapper calls `load_library(name).<entry point>` directly.

The op modules sit on this one and it imports none of them: ops/flash_attention.py
(K1-K4), ops/norms.py (GroupNorm, LayerNorm), ops/geglu.py (GEGLU) and
ops/moca_scan.py (MoCA's window step over every FIFO window). A kernel
adds its row to `LIBRARIES`, its own source and its own op module, which
imports only the public names below. Each CUDA wrapper is registered with
`tallied` and keeps a `launches` tally, {shape key: launches}, to which
`tally` adds one a launch: the wrapper's shape with "fp32" or "fp16"
appended for those types (`launch_key`). `reset_launch_counts` empties every
registered tally.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HEADERS = ("mma.cuh", "hopper.cuh", "flash_hopper.cuh", "attention_f32.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class Library(NamedTuple):
    sources: tuple  # file names under CSRC
    entries: dict   # C entry point -> its argtypes (each returns an int error code)


def _with_f32(fn: str, argtypes) -> dict:
    """K1-K4's entries: `fn` (bfloat16) and "<fn>_f32", which takes the same."""
    return {fn: argtypes, fn + "_f32": argtypes}


_ATTENTION = [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _p]  # K1's and K4's arguments
# K2's two designs are two units so that they compile in parallel (the span
# design alone took nvcc longer than any other library)
LIBRARIES = {
    "flash": Library(("flash_attention.cu",),
                     {**_with_f32("moca_flash_attention", _ATTENTION),
                      "moca_flash_attention_plan": [_i] * 5}),
    "packed": Library(("packed_attention.cu", "packed_span.cu"),
                      {**_with_f32("moca_packed_attention",
                                   [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i, _p]),
                       "moca_packed_attention_plan": [_i], "moca_packed_empty": [_p]}),
    "fused": Library(("fused_qkv_attention.cu",),
                     _with_f32("moca_fused_qkv_attention",
                               [_p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _f, _p])),
    "onepass": Library(("flash_onepass.cu",),
                       {**_with_f32("moca_flash_onepass", _ATTENTION),
                        "moca_flash_onepass_plan": [_i] * 5}),
    "norms": Library(("norms.cu",),
                     {"moca_group_norm": [_p, _p, _p, _p, _p, _i, _i, _ll, _ll, _i, _i, _i, _i,
                                          _i, _ll, _f, _i, _p],
                      "moca_layer_norm": [_p, _p, _p, _p, _i, _i, _ll, _i, _i, _f, _p]}),
    "geglu": Library(("geglu.cu",), {"moca_geglu": [_p, _p, _i, _ll, _ll, _i, _i, _i, _p]}),
    "moca_scan": Library(("moca_scan.cu",),
                         {"moca_scan": [_p] * 10 + [_i] * 4 + [_ll, _i, _i, _i, _f, _f, _f,
                                                              _i, _i, _i, _p]}),
}

# the `dtype` argument of moca_group_norm, moca_layer_norm and moca_geglu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: dict = {}
build_log: dict = {}  # name -> {"seconds": .., "ptxas": ..} of the last build


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in tuple(sources) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict:
    """Compile every library of `LIBRARIES` that has no up-to-date file yet.

    One nvcc per source, all started together, then one link per library;
    returns {name: library path}. A library's file name carries a digest of
    its sources and flags, so an edited source is rebuilt and a stale
    library is never loaded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: BUILD_DIR / f"libmoca_{name}_{_digest(lib.sources)}.so"
               for name, lib in LIBRARIES.items()}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            procs[name] = []
            for src in LIBRARIES[name].sources:
                obj = path.with_name(f"{path.stem}.{Path(src).stem}.{os.getpid()}.o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                       str(CSRC / src)]
                procs[name].append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True), obj))
        failed = []
        for name, units in procs.items():
            logs = [proc.communicate()[0] for proc, _ in units]
            ok = all(proc.returncode == 0 for proc, _ in units)
            if ok:
                tmp = todo[name].with_suffix(f".{os.getpid()}.tmp")
                link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                       *(str(obj) for _, obj in units)],
                                      capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                ok = link.returncode == 0
                if ok:
                    os.replace(tmp, todo[name])
            for _, obj in units:
                obj.unlink(missing_ok=True)
            build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": "\n".join(logs)}
            if not ok:
                failed.append(f"{', '.join(LIBRARIES[name].sources)}:\n" + "\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load_library(name: str):
    """Library `name` of `LIBRARIES`, built and loaded at first use, with
    every entry's argtypes set."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_kernels()[name]))
        for sym, argtypes in LIBRARIES[name].entries.items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = _i
        lib.moca_cuda_error_string.argtypes = [_i]
        lib.moca_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def raise_on(lib, err: int, what: str):
    """Raise on an entry point's non-zero CUDA error code `err`."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.moca_cuda_error_string(err).decode()}")


def vector(itemsize: int, c: int, *ptrs: int) -> int:
    """Values a thread loads at once: a 16-byte vector where C is whole
    vectors and every pointer is 16-byte aligned, else one."""
    vec = 16 // itemsize
    return vec if c % vec == 0 and all(p % 16 == 0 for p in ptrs) else 1


# ---------------------------------------------------------------------------
# Launch tallies
# ---------------------------------------------------------------------------

_TAGS = {torch.float32: ("fp32",), torch.float16: ("fp16",), torch.bfloat16: ()}
TALLIED: list = []  # every registered wrapper, in the order its module was imported


def tallied(fn):
    """Register kernel wrapper `fn`: give it an empty `launches` tally, which
    `reset_launch_counts` empties. Returns `fn` itself."""
    fn.launches = {}
    TALLIED.append(fn)
    return fn


def launch_key(shape: tuple, dtype) -> tuple:
    """The tally key of a launch at `shape` in `dtype`."""
    return shape + _TAGS[dtype]


def tally(fn, shape: tuple, dtype):
    """Add one launch of `fn` under `launch_key(shape, dtype)`."""
    key = shape + _TAGS[dtype]  # launch_key, inline: the norms launch ~265 times a DDIM step
    fn.launches[key] = fn.launches.get(key, 0) + 1


def reset_launch_counts():
    """Empty every registered wrapper's launch tally."""
    for fn in TALLIED:
        fn.launches = {}
