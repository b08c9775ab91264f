"""The port's attention kernels (moca_tpu_torch.ops) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held here
to the Pallas kernel bodies run with `interpret=True` (the pattern of
tests/test_flash_interpret.py) and to `_xla_attention`. The CUDA kernels
themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and by chip_smoke.py.

Tolerance: 1e-5 absolute — both sides compute the same fp32 softmax
attention on fp32 inputs and differ only in summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import moca_tpu.ops.flash_attention as jfa
from moca_tpu.ops.attention import _xla_attention
from moca_tpu_torch.ops import attention as tatt
from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nomax", [False, True])
def test_flash_plain_matches_fa_kernel_interpret(nomax):
    """K1's plain version vs `_fa_kernel` (two kv blocks: online softmax)."""
    b, s, h, d = 1, 16, 2, 8
    bq = bkv = 8
    q, k, v = (_rand((b, s, h, d), i) for i in range(3))
    kernel = functools.partial(jfa._fa_kernel, scale=d**-0.5, nkv=s // bkv,
                               stat_lanes=128, nomax=nomax)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, h, s, d), jnp.float32),
        grid=(b, h, s // bq, s // bkv),
        in_specs=[
            pl.BlockSpec((1, 1, bq, d), lambda b_, h_, i, j: (b_, h_, i, 0)),
            pl.BlockSpec((1, 1, bkv, d), lambda b_, h_, i, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, bkv, d), lambda b_, h_, i, j: (b_, h_, j, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, bq, d), lambda b_, h_, i, j: (b_, h_, i, 0)),
        scratch_shapes=[
            pltpu.VMEM((8, 128) if nomax else (bq, 128), jnp.float32),
            pltpu.VMEM((bq, 128), jnp.float32),
            pltpu.VMEM((bq, d), jnp.float32),
        ],
        interpret=True,
    )(*(jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)))
    port = tfa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(port, np.asarray(out).transpose(0, 2, 1, 3), atol=ATOL)


@pytest.mark.parametrize("nomax", [False, True])
def test_flash_plain_matches_fa_small_kernel_interpret(nomax):
    """K1's plain version vs `_fa_small_kernel` on (b*h)-folded rows."""
    b, s, h, d = 2, 16, 2, 8
    q, k, v = (_rand((b, s, h, d), 10 + i) for i in range(3))
    fold = lambda t: jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    out = pl.pallas_call(
        functools.partial(jfa._fa_small_kernel, scale=d**-0.5, nomax=nomax),
        out_shape=jax.ShapeDtypeStruct((b * h, s, d), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((b * h, s, d), lambda i: (i, 0, 0))] * 3,
        out_specs=pl.BlockSpec((b * h, s, d), lambda i: (i, 0, 0)),
        interpret=True,
    )(fold(q), fold(k), fold(v))
    ref = np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    port = tfa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(port, ref, atol=ATOL)


@pytest.mark.parametrize("nomax", [False, True])
def test_packed_plain_matches_packed_slice_kernel_interpret(nomax):
    """K2's plain version vs `_packed_slice_kernel` (the C=320 product path)."""
    nb, s, heads, d = 4, 8, 5, 8
    q, k, v = (_rand((nb, s, heads * d), 20 + i) for i in range(3))
    out = pl.pallas_call(
        functools.partial(jfa._packed_slice_kernel, scale=d**-0.5, heads=heads, d=d,
                          nomax=nomax),
        out_shape=jax.ShapeDtypeStruct((nb, s, heads * d), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((nb, s, heads * d), lambda i: (i, 0, 0))] * 3,
        out_specs=pl.BlockSpec((nb, s, heads * d), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port = tfa.packed_attention(_t(q), _t(k), _t(v), heads).numpy()
    np.testing.assert_allclose(port, np.asarray(out), atol=ATOL)


@pytest.mark.parametrize("hpb", [1, 2])
def test_packed_plain_matches_packed_lane_kernel_interpret(hpb):
    """K2's plain version vs `_packed_lane_kernel` (C % 128 == 0 widths)."""
    nb, s, heads, d = 4, 8, 4, 8
    c, bc = heads * d, hpb * d
    q, k, v = (_rand((nb, s, c), 30 + i) for i in range(3))
    out = pl.pallas_call(
        functools.partial(jfa._packed_lane_kernel, scale=d**-0.5, hpb=hpb, d=d),
        out_shape=jax.ShapeDtypeStruct((nb, s, c), jnp.float32),
        grid=(1, c // bc),
        in_specs=[pl.BlockSpec((nb, s, bc), lambda i, j: (i, 0, j))] * 3,
        out_specs=pl.BlockSpec((nb, s, bc), lambda i, j: (i, 0, j)),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port = tfa.packed_attention(_t(q), _t(k), _t(v), heads).numpy()
    np.testing.assert_allclose(port, np.asarray(out), atol=ATOL)


@pytest.mark.parametrize("sq,sk,with_bias", [
    (160, 160, False),   # spatial self-attention (small path)
    (40, 40, False),     # the mid block's S=40
    (64, 77, False),     # text cross-attention, kv = 77
    (16, 16, True),      # biased (causal-style) attention
])
def test_plain_attention_matches_xla_attention(sq, sk, with_bias):
    b, h, d = 2, 3, 16
    q = _rand((b, sq, h, d), 40)
    k, v = _rand((b, sk, h, d), 41), _rand((b, sk, h, d), 42)
    bias = None
    if with_bias:
        bias = np.where(np.tril(np.ones((sq, sk), bool)), 0.0, -np.inf)[None, None]
        bias = bias.astype(np.float32)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if bias is None else jnp.asarray(bias))
    port = tatt.dot_product_attention(_t(q), _t(k), _t(v),
                                      None if bias is None else _t(bias))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


def test_dispatch_routes_like_the_reference():
    """K1 at the spatial self-attention shapes, the plain path for S=40,
    kv=77 and a bias; K2 for the temporal widths at every head width, not
    for kv != S."""
    for s in (2560, 640, 160):
        assert tatt.flash_shape_ok(s, s, 64, None)
    assert not tatt.flash_shape_ok(40, 40, 64, None)       # mid block
    assert not tatt.flash_shape_ok(2560, 77, 64, None)     # text cross-attention
    assert tatt.flash_shape_ok(2560, 154, 64, None)        # ... with a conditioned prompt
    assert not tatt.flash_shape_ok(2560, 2560, 64, 0.0)    # biased
    assert not tatt.flash_shape_ok(2560, 2560, 8, None)    # head width
    for c in (320, 512, 640, 1280):
        assert tatt.packed_shape_ok(16, 16, None, c, c // 64)
    for c, heads in ((32, 4), (64, 2), (320, 8), (256, 2), (80, 2)):  # d = 8, 32, 40, 128, 40
        assert tatt.packed_shape_ok(16, 16, None, c, heads)
    assert not tatt.packed_shape_ok(16, 77, None, 320, 5)
    assert not tatt.packed_shape_ok(40, 40, None, 1280, 20)
    assert not tatt.packed_shape_ok(16, 16, 0.0, 320, 5)
    assert not tatt.packed_shape_ok(16, 16, None, 2048, 32)
    assert tatt.packed_shape_ok(16, 16, None, 72, 2)        # d = 36: K2's span design
    assert tatt.packed_shape_ok(16, 16, None, 272, 2)       # d = 136: K2's span design
    q = torch.zeros(4, 16, 320)
    assert not tatt.use_packed_tiny(q, 16, 16, None, 320, 5)  # CPU tensors: plain


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    cuda_libs.reset_launch_counts()
    q, k, v = (_t(_rand((2, 16, 2, 64), 50 + i)) for i in range(3))
    np.testing.assert_array_equal(tfa.flash_attention(q, k, v).numpy(),
                                  tfa.attention_plain(q, k, v).numpy())
    np.testing.assert_array_equal(tfa.flash_attention_onepass(q, k, v).numpy(),
                                  tfa.flash_attention_onepass_plain(q, k, v).numpy())
    p = _t(_rand((3, 16, 128), 60))
    np.testing.assert_array_equal(tfa.packed_attention(p, p, p, 2).numpy(),
                                  tfa.packed_attention_plain(p, p, p, 2).numpy())
    w = [_t(_rand((128, 128), 61 + i) * 0.1) for i in range(4)]
    bo = _t(_rand((128,), 65))
    np.testing.assert_array_equal(tfa.fused_qkv_attention(p, *w, bo, 2).numpy(),
                                  tfa.fused_qkv_attention_plain(p, *w, bo, 2).numpy())
    for fn in cuda_libs.TALLIED:
        assert fn.launches == {}


def test_kernel_shape_choices_at_the_main_path_and_their_limits():
    """The head split that the K3 wrapper passes to its C entry point (the
    CTAs of a cluster that share one tile): at the switched main path's
    shapes, and at its limits."""
    k3_fifo = [(40960, 16, 320), (10240, 16, 640), (2560, 16, 1280), (40960, 16, 512),
               (640, 16, 1280), (5120, 16, 320), (1280, 16, 640), (320, 16, 1280),
               (5120, 16, 512)]
    for n, s, c in k3_fifo:  # these grids fill the card: no split
        assert tfa.fused_qkv_head_split(n, s, c) == 1
    assert tfa.fused_qkv_head_split(80, 16, 1280) == 4    # the middle block: 20 tiles
    assert tfa.fused_qkv_head_split(132, 16, 1280) == 4   # 33 tiles x 4 = 132 CTAs
    assert tfa.fused_qkv_head_split(136, 16, 1280) == 2   # 34 tiles: x 4 > 132, x 2 <= 132
    assert tfa.fused_qkv_head_split(300, 16, 1280) == 1   # 75 tiles: x 2 > 132
    assert tfa.fused_qkv_head_split(3, 16, 1280) == 4     # below one tile
    assert tfa.fused_qkv_head_split(8, 24, 1280) == 4     # S = 24: 48-token tiles, 4 of them
    assert tfa.fused_qkv_head_split(80, 16, 640) == 1     # only at C = 1280


def test_every_included_header_is_in_the_build_digest():
    """Each `#include "..."` of a kernel source, and of the headers those
    include, is listed in `HEADERS`: the library's file name carries a
    digest of only those files, so an unlisted header could leave a stale
    library loaded after an edit."""
    import re

    seen, todo = set(), [src for lib in cuda_libs.LIBRARIES.values() for src in lib.sources]
    while todo:
        name = todo.pop()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              (cuda_libs.CSRC / name).read_text(), re.M):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    assert seen, "no kernel source includes a header of the package"
    assert seen <= set(cuda_libs.HEADERS), sorted(seen - set(cuda_libs.HEADERS))
