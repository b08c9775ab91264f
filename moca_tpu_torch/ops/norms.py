"""Normalization layers with the reference's fp32-statistics semantics.

Port of moca_tpu/ops/norms.py (`GroupNorm32`, :74-135) and of the U-Net's
`_LayerNorm32` (moca_tpu/models/unet3d.py:439-449). Both take channels-last
input [N, ..., C], compute statistics and the affine map in float32 and cast
back to the input's type. Parameter names are torch's (`weight`, `bias`) so
checkpoint keys map one to one. A norm whose `span` its owning network set
(the U-Net's: `unet.norm`) runs inside that trace range; the others open none.

Each norm is a function with a plain PyTorch version (`group_norm_plain`,
`layer_norm_plain`), which CPU tensors take, and a hand-written CUDA kernel
(csrc/norms.cu, built into the "norms" library of ops/flash_attention.py's
build), which CUDA tensors take: there is no fallback. The kernels read and
write the input's type (bfloat16, float16 or float32) and keep the
statistics, the affine map and SiLU in float32, as the plain versions do.
Each wrapper adds one to its `launches` tally, keyed by shape (with "fp32"
or "fp16" appended for those types), per call.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.ops import flash_attention as fa
from moca_tpu_torch.utils.profiling import annotate

# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels must reproduce)
# ---------------------------------------------------------------------------


def group_norm_plain(x, weight, bias, groups: int, eps: float, act: str | None = None):
    """GroupNorm over channels-last x [N, ..., C]: `groups` groups of C / groups
    channels, statistics over every axis between N and C in fp32, the affine
    map and SiLU (act="silu") in fp32, cast back to x's type."""
    n, c = x.shape[0], x.shape[-1]
    x32 = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(x32, dim=(1, 3), correction=0, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def layer_norm_plain(x, weight, bias, eps: float):
    """LayerNorm over the last axis of x in fp32, cast back to x's type."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Launch plans (pure arithmetic on shapes; tests/test_torch_models.py models them)
# ---------------------------------------------------------------------------

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GN_THREADS = 512        # a block's threads, where a row's vectors take fewer
GN_MAX_THREADS = 1024   # a row's vectors, one thread each, at most
GN_BLOCKS = 8 * 132     # blocks a launch aims for: 8 a streaming multiprocessor of an H100
GN_MIN_ROWS = 4         # rows a thread walks in a chunk, at least (where M allows)
LN_VECTORS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)  # 16-byte vectors a lane can hold
LN_MAX_VALUES = 64      # values a lane holds in registers, at most


def _vector(itemsize: int, c: int, *ptrs: int) -> int:
    """Values a thread loads at once: a 16-byte vector where C is whole
    vectors and every pointer is 16-byte aligned, else one."""
    vec = 16 // itemsize
    return vec if c % vec == 0 and all(p % 16 == 0 for p in ptrs) else 1


@functools.lru_cache(maxsize=None)
def group_norm_plan(n: int, m: int, c: int, vec: int):
    """(rows, chunks, rows_per_chunk) of the GroupNorm kernels on [n, m, c]
    with `vec` values a thread: each n is cut into `chunks` chunks of
    `rows_per_chunk` rows (the last one ragged), as many as make GN_BLOCKS
    blocks where each of a block's thread rows still walks GN_MIN_ROWS rows;
    each block has c / vec threads across the channels and `rows` thread rows,
    as many as its chunk gives GN_MIN_ROWS rows each, with c / vec * rows <=
    GN_THREADS where the row allows, and never fewer than a whole warp (the
    statistics kernel combines a group's entries in whole warps)."""
    v = c // vec
    if v > GN_MAX_THREADS:
        raise ValueError(f"group_norm: {c} channels at {vec} a thread exceed "
                         f"{GN_MAX_THREADS} threads")
    chunks = max(1, min(-(-GN_BLOCKS // n), m // GN_MIN_ROWS))
    rpc = -(-m // chunks)
    rows = max(-(-32 // v), min(GN_THREADS // v, rpc // GN_MIN_ROWS))  # a whole warp at least
    return rows, -(-m // rpc), rpc


@functools.lru_cache(maxsize=None)
def layer_norm_vectors(c: int, vec: int) -> int:
    """16-byte vectors a lane holds for a row of c values (the smallest of
    LN_VECTORS that holds the row, at most LN_MAX_VALUES values), or 0 for the
    any-row kernel: where the row is not whole 16-byte vectors (vec 1) or
    does not fit."""
    if vec == 1:
        return 0
    need = -(-(c // vec) // 32)
    return next((nv for nv in LN_VECTORS if nv >= need and nv * vec <= LN_MAX_VALUES), 0)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _operands(what: str, x, weight, bias):
    """(x contiguous, weight, bias, the dtype's code, w_f32, the device's
    index): the affine in x's type or fp32 (any other type is widened to
    fp32, which keeps every value); raises on what the kernels do not take.
    Cheap checks only: the clip's U-Net makes ~265 of these calls a step."""
    code = KERNEL_DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"{what}: the kernel takes bfloat16, float16 or float32, got {x.dtype}")
    if weight is None or bias is None:
        raise ValueError(f"{what}: the kernel needs a weight and a bias")
    dev = x.get_device()
    if dev < 0 or weight.get_device() != dev or bias.get_device() != dev:
        raise ValueError(f"{what}: all inputs must lie on one CUDA device")
    if weight.dtype is not x.dtype and weight.dtype is not torch.float32:
        weight = weight.float()
    if bias.dtype is not weight.dtype:
        bias = bias.to(weight.dtype)
    if not x.is_contiguous():
        x = x.contiguous()
    if not (weight.is_contiguous() and bias.is_contiguous()):
        weight, bias = weight.contiguous(), bias.contiguous()
    return x, weight, bias, code, int(weight.dtype is not x.dtype), dev


_DTYPE_TAGS = {torch.float32: ("fp32",), torch.float16: ("fp16",), torch.bfloat16: ()}


def _tally(fn, key, dtype):
    key = key + _DTYPE_TAGS[dtype]
    fn.launches[key] = fn.launches.get(key, 0) + 1


def group_norm(x, weight, bias, groups: int, eps: float, act: str | None = None):
    """GroupNorm over channels-last x [N, ..., C] (`group_norm_plain`'s
    function), SiLU where act="silu".

    CPU tensors take `group_norm_plain`; CUDA tensors launch the kernels
    (statistics, their combination, the map) from one C call."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: act must be None or 'silu', got {act!r}")
    x, weight, bias, code, w_f32, dev = _operands("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[-1]
    m = x.numel() // max(1, n * c)
    if c % groups or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm: {c} channels, {groups} groups, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    vec = _vector(x.element_size(), c, x.data_ptr())
    rows, chunks, rpc = group_norm_plan(n, m, c, vec)
    scratch = x.new_empty(n * groups * (chunks + 1) * 2, dtype=torch.float32)
    lib = fa.load_library("norms")
    err = lib.moca_group_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                              scratch.data_ptr(), code, w_f32, n, m, c, groups, vec, rows, chunks,
                              rpc, eps, act == "silu", torch._C._cuda_getCurrentRawStream(dev))
    fa._raise_on(lib, err, "group_norm")
    _tally(group_norm, (n, m, c, groups), x.dtype)
    return y


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last axis of x (`layer_norm_plain`'s function).

    CPU tensors take `layer_norm_plain`; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    x, weight, bias, code, w_f32, dev = _operands("layer_norm", x, weight, bias)
    c = x.shape[-1]
    r = x.numel() // max(1, c)
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm: {c} channels, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    vec = _vector(x.element_size(), c, x.data_ptr(), weight.data_ptr(), bias.data_ptr())
    lib = fa.load_library("norms")
    err = lib.moca_layer_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                              code, w_f32, r, c, layer_norm_vectors(c, vec), eps,
                              torch._C._cuda_getCurrentRawStream(dev))
    fa._raise_on(lib, err, "layer_norm")
    _tally(layer_norm, (r, c), x.dtype)
    return y


KERNELS = (group_norm, layer_norm)


def reset_launch_counts():
    """Empty both wrappers' launch tallies, {shape: launches} with shape
    (N, M, C, groups) for `group_norm` and (R, C) for `layer_norm`, with
    "fp32" or "fp16" appended for those types."""
    for fn in KERNELS:
        fn.launches = {}


reset_launch_counts()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _in_span(forward):
    """Run `forward` inside the module's `span` range, where one is set."""
    @functools.wraps(forward)
    def run(self, x):
        if self.span is None:
            return forward(self, x)
        with annotate(self.span):
            return forward(self, x)
    return run


class GroupNorm32(nn.Module):
    """GroupNorm over channels-last [N, ..., C] with fp32 statistics.

    Groups partition the channel axis as in torch.nn.GroupNorm; statistics
    run over every axis between N and C. Widths that 32 does not divide (tiny
    test configs) fall back to gcd(C, 32) groups, as the reference does.
    act="silu" applies SiLU in fp32 before the cast back."""

    span = None

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: str | None = None):
        super().__init__()
        self.groups = (num_groups if num_channels % num_groups == 0
                       else math.gcd(num_channels, num_groups))
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    @_in_span
    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.act)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last axis with fp32 statistics, cast back."""

    span = None

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    @_in_span
    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
