"""The U-Net feed-forward's GEGLU: y = x * gelu_tanh(gate) on the two halves
of the projection's output h [..., 2F] -> [..., F].

Port of the reference's `GEGLU` (moca_tpu/models/unet3d.py:410-420), whose
`nn.gelu` is the tanh approximation. `geglu_plain` is the arithmetic as the
port's `GEGLU` ran it in plain PyTorch (`chunk`, `F.gelu(approximate="tanh")`,
the product), which CPU tensors take; `geglu` launches the hand-written CUDA
kernel (csrc/geglu.cu, the "geglu" library of ops/cuda_libs.py) on CUDA
tensors: there is no fallback. The kernel reads h once and writes y once,
and keeps the gelu and the product in float32, rounded once to h's type
(bfloat16, float16 or float32; the plain version rounds the gelu to h's type
before the product). Each call adds one to `geglu.launches`, keyed by (R, F)
(with "fp32" or "fp16" appended for those types).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from moca_tpu_torch.ops.cuda_libs import (DTYPE_CODES, load_library, raise_on, tally,
                                          tallied, vector)

GEGLU_THREADS = 256      # a block's threads (the .cu's kMaxThreads)
GEGLU_BLOCKS = 8 * 132   # blocks a launch aims for: 8 of 256 threads fill a streaming
                         # multiprocessor of an H100
GEGLU_IN_FLIGHT = 2      # vectors a thread loads before it stores


def geglu_plain(h):
    """x * gelu(gate) on the halves of h [..., 2F], as the port's `GEGLU`
    computed it: the gelu rounded to h's type, then the product."""
    x, gate = h.chunk(2, dim=-1)
    # flax's nn.gelu default (tanh approximation), as the reference port
    return x * F.gelu(gate, approximate="tanh")


@functools.lru_cache(maxsize=None)
def geglu_plan(r: int, f: int, vec: int):
    """(threads, blocks) of the kernel on h [r, 2f] with `vec` values a
    thread: GEGLU_THREADS threads a block, and as many blocks as give each
    thread GEGLU_IN_FLIGHT of the r * f / vec vectors, at most GEGLU_BLOCKS
    (past that each thread walks more with the grid stride)."""
    if f % vec:
        raise ValueError(f"geglu: F = {f} is not whole vectors of {vec}")
    vectors = r * (f // vec)
    per_block = GEGLU_THREADS * GEGLU_IN_FLIGHT
    return GEGLU_THREADS, max(1, min(GEGLU_BLOCKS, -(-vectors // per_block)))


@tallied
def geglu(h):
    """x * gelu_tanh(gate) on the halves of h [..., 2F] (`geglu_plain`'s
    function).

    CPU tensors take `geglu_plain`; CUDA tensors launch the kernel."""
    if h.device.type == "cpu":
        return geglu_plain(h)
    code = DTYPE_CODES.get(h.dtype)
    if code is None:
        raise ValueError(f"geglu: the kernel takes bfloat16, float16 or float32, got {h.dtype}")
    if h.get_device() < 0:
        raise ValueError("geglu: the input must lie on a CUDA device")
    if h.ndim == 0 or h.shape[-1] % 2:
        raise ValueError(f"geglu: the last axis must be 2F, got shape {tuple(h.shape)}")
    if not h.is_contiguous():
        h = h.contiguous()
    f = h.shape[-1] // 2
    y = torch.empty(h.shape[:-1] + (f,), dtype=h.dtype, device=h.device)
    if y.numel() == 0:
        return y
    r = y.numel() // f
    vec = vector(h.element_size(), f, h.data_ptr(), y.data_ptr())
    threads, blocks = geglu_plan(r, f, vec)
    lib = load_library("geglu")
    err = lib.moca_geglu(h.data_ptr(), y.data_ptr(), code, r, f, vec, blocks, threads,
                         torch._C._cuda_getCurrentRawStream(h.get_device()))
    raise_on(lib, err, "geglu")
    tally(geglu, (r, f), h.dtype)
    return y
