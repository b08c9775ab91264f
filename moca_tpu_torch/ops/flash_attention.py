"""Hand-written Hopper attention kernels, their plain versions and their build.

Port of moca_tpu/ops/flash_attention.py. The seven Pallas kernels there
collapse into two CUDA kernels here (sources in `moca_tpu_torch/csrc/`, each
with a note on what it replaces, what bounds it and how it is designed):

  * K1 `flash_attention(q, k, v)` — attention of q [B, Sq, H, D] over
    k, v [B, Sk, H, D], D in {64, 128}; serves `_fa_kernel` and
    `_fa_small_kernel` (csrc/flash_attention.cu);
  * K2 `packed_attention(q, k, v, heads)` — [N, S, H*64] tiny-S attention on
    packed heads, S in {8, 16, 24, 32}; serves `_packed_slice_kernel` and
    `_packed_lane_kernel` (csrc/packed_attention.cu).

Each wrapper runs its plain PyTorch version only when handed CPU tensors. On
CUDA tensors it launches the kernel or raises — there is no fallback — and
adds one to its `launches` tally, keyed by shape, per launch.

The kernels are compiled from the repository's sources with `nvcc` for
`sm_90a` (one process per source, started together) into `build/kernels/`
beside the package, at first use, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = {"flash": "flash_attention.cu", "packed": "packed_attention.cu"}
_HEADERS = ("mma.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOG2E = 1.4426950408889634

_libs: dict = {}
build_log: dict = {}  # name -> {"seconds": .., "ptxas": ..} of the last build


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels must reproduce)
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v on [B, S, H, D], softmax in fp32.

    The reference's `_xla_attention` (moca_tpu/ops/attention.py:25-36):
    fp32 logits, probabilities cast to v's type before the PV product."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def packed_attention_plain(q, k, v, heads: int):
    """[N, S, H*D] packed-heads self-attention via the plain path."""
    n, s, c = q.shape
    d = c // heads
    split = lambda t: t.reshape(n, s, heads, d)
    return attention_plain(split(q), split(k), split(v)).reshape(n, s, c)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the attention kernels are built from source at first use")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict:
    """Compile every kernel source that has no up-to-date library yet.

    One nvcc per source, all started together; returns {name: library path}.
    A library's file name carries a digest of its sources and flags, so an
    edited source is rebuilt and a stale library is never loaded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: BUILD_DIR / f"libmoca_{name}_{_digest(src)}.so"
               for name, src in _SOURCES.items()}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / _SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
            if proc.returncode != 0:
                failed.append(f"{_SOURCES[name]}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def _lib(name: str):
    if name not in _libs:
        path = build_kernels()[name]
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash":
            lib.moca_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
            lib.moca_flash_attention.restype = i
        else:
            lib.moca_packed_attention.argtypes = [p, p, p, p, ctypes.c_longlong,
                                                  i, i, f, p]
            lib.moca_packed_attention.restype = i
        lib.moca_cuda_error_string.argtypes = [i]
        lib.moca_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check_inputs(q, k, v, what: str):
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: q, k, v must lie on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _raise_on(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.moca_cuda_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def flash_attention(q, k, v):
    """K1: attention of q [B, Sq, H, D] over k, v [B, Sk, H, D] (D in
    {64, 128}); softmax in fp32.

    CPU tensors take `attention_plain`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check_inputs(q, k, v, "flash_attention")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128) or k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention: batch and heads must be < 65536")
    lib = _lib("flash")
    o = torch.empty_like(q)
    err = lib.moca_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, d,
        d ** -0.5 * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_attention")
    key = (b, sq, sk, h, d)
    flash_attention.launches[key] = flash_attention.launches.get(key, 0) + 1
    return o


def packed_attention(q, k, v, heads: int):
    """K2: self-attention on packed heads [N, S, heads*64], S in {8,16,24,32}.

    CPU tensors take `packed_attention_plain`; CUDA tensors launch the
    kernel."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, heads)
    _check_inputs(q, k, v, "packed_attention")
    n, s, c = q.shape
    if (c != heads * 64 or s not in (8, 16, 24, 32) or k.shape != q.shape
            or v.shape != q.shape):
        raise ValueError(f"packed_attention: unsupported shape {tuple(q.shape)} "
                         f"with {heads} heads (needs d=64, S in 8/16/24/32)")
    lib = _lib("packed")
    o = torch.empty_like(q)
    err = lib.moca_packed_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, s, heads,
        64 ** -0.5 * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "packed_attention")
    key = (n, s, c)
    packed_attention.launches[key] = packed_attention.launches.get(key, 0) + 1
    return o


def reset_launch_counts():
    """Empty both wrappers' launch tallies, {shape: launches} with shape
    (B, Sq, Sk, H, D) for flash and (N, S, C) for packed."""
    for fn in (flash_attention, packed_attention):
        fn.launches = {}


reset_launch_counts()

