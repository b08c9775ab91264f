"""K2 (`packed_attention`) at every head width the reference takes.

The reference routes every tiny self-attention (S <= 32, S % 8 == 0, no
bias, C <= 1280) to `_packed_tiny_kernel` whatever the head width; the port's
K2 takes every width too. Here, on the CPU:

  (a) the plain version against `_packed_tiny_kernel` run with
      `interpret=True`, inputs from a seed with numpy, in fp32 (1e-5
      absolute: both compute the same fp32 softmax attention and differ in
      summation order only) and on bf16 inputs (worst-row relative L2 of the
      d-vectors <= 2e-2: both round the probabilities and the output to bf16,
      at other points);
  (b) the port's route (`packed_shape_ok`) against the reference's
      `use_packed_tiny` as it reads on a TPU, for every head count;
  (c) the span design's copy plan (`span_ctas`, `span_row_chunks`,
      `span_ldr`, `span_lg` below: a Python model of `stage_span` and
      `write_span` in csrc/packed_span.cu), for every group of heads a
      CTA may stage, against direct slicing: each
      CTA's 16-byte chunks are aligned and inside the row's slab, each head
      sits at the offset the kernel computes inside them, and the write-back
      covers every element of the slab exactly once;
  (d) the port's small U-Net at num_head_channels=20 (inner = heads * d
      differs from the channels) against the JAX package's, with its
      temporal attention sent through `packed_attention` as on the card.

The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_sampling import one_torch_thread  # noqa: F401  (fixture)
from test_torch_unet_options import _close, _unet_pair

import moca_tpu.ops.attention as jatt
import moca_tpu.ops.flash_attention as jfa
from moca_tpu_torch.models import unet3d as tunet
from moca_tpu_torch.ops import attention as tatt
from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5
BF16_ROW_TOL = 2e-2
# (S, C, heads) at N = 4: odd C, C % 8 == 4, d > 128, d = C, and S = 8, 24, 32
CASES = [(16, 320, 16), (16, 297, 9), (16, 300, 3), (16, 272, 2), (16, 320, 2),
         (16, 1280, 1), (8, 297, 9), (24, 297, 9), (32, 297, 9)]


# The span design's copy plan in Python, a model of csrc/packed_span.cu
# (`launch_span`, `span_ldr`, `span_lg`, `stage_span`, `write_span`, `Span`),
# with the kernel's own constants read from its source.

_CU = (cuda_libs.CSRC / "packed_span.cu").read_text()
SPAN_SLICE, SPAN_MAX_WARPS = (
    int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))
    for name in ("SPAN_SLICE", "SPAN_MAX_WARPS"))


def span_ctas(heads: int, d: int, group: int):
    """The span design's CTAs over one row, each as (the columns its staged
    rows are sized for, the column spans it stages in turn): `group` heads
    at d <= SPAN_SLICE, one span; above, one head in blocks of
    warps * SPAN_SLICE columns."""
    if d <= SPAN_SLICE:
        return [(group * d, [(h0 * d, min(h0 + group, heads) * d)])
                for h0 in range(0, heads, group)]
    bw = min(SPAN_MAX_WARPS, -(-d // SPAN_SLICE)) * SPAN_SLICE
    return [(bw, [(h * d + b, h * d + min(b + bw, d)) for b in range(0, d, bw)])
            for h in range(heads)]


def span_ldr(cols: int, itemsize: int) -> int:
    """Elements of one staged row: the 16-byte chunks a row of `cols`
    columns can straddle, rounded up to 1 mod 8 chunks."""
    e = 16 // itemsize
    rch = (cols + 2 * e - 2) // e
    rch += (9 - rch % 8) % 8
    return rch * e


def span_lg(cols: int, itemsize: int) -> int:
    """log2 of the chunks the copy loops visit in a row."""
    e = 16 // itemsize
    return max(0, ((cols + 2 * e - 2) // e - 1).bit_length())


def span_row_chunks(seq_len: int, channels: int, b0: int, b1: int, itemsize: int):
    """For columns [b0, b1) of one row's [seq_len, channels] slab, each token
    row r's (first chunk, end chunk, offset): the slab-relative 16-byte
    chunks covering elements r*C + b0 .. r*C + b1 - 1, staged in that order
    from element r * ldr, and the offset of element (r, b0) in them."""
    e = 16 // itemsize
    plan = []
    for r in range(seq_len):
        a, end = r * channels + b0, r * channels + b1
        plan.append((a // e, -(-end // e), a % e))
    return plan


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_packed_tiny(q, k, v, heads):
    """`_packed_tiny_kernel` on the whole [N, S, C] in one program, interpreted."""
    n, s, c = q.shape
    d = c // heads
    return pl.pallas_call(
        functools.partial(jfa._packed_tiny_kernel, scale=d ** -0.5, heads=heads, d=d),
        out_shape=jax.ShapeDtypeStruct((n, s, c), q.dtype),
        grid=(1,),
        in_specs=[pl.BlockSpec((n, s, c), lambda i: (i, 0, 0))] * 3,
        out_specs=pl.BlockSpec((n, s, c), lambda i: (i, 0, 0)),
        interpret=True,
    )(q, k, v)


def _worst_row(out, ref, d):
    out, ref = out.reshape(-1, d), ref.reshape(-1, d)
    norm = np.linalg.norm(ref, axis=1)
    return float((np.linalg.norm(out - ref, axis=1) / np.maximum(norm, 1e-6 * norm.max())).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,c,heads", CASES)
def test_packed_plain_matches_packed_tiny_kernel_interpret(s, c, heads, dtype):
    q, k, v = (_rand((4, s, c), 70 + i) for i in range(3))
    fp32 = dtype == "float32"
    jdt, tdt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16, torch.bfloat16)
    ref = _jax_packed_tiny(*(jnp.asarray(a, jdt) for a in (q, k, v)), heads)
    port = tfa.packed_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), heads)
    assert port.dtype == tdt and port.shape == (4, s, c)
    ref, port = np.asarray(ref, np.float32), port.float().numpy()
    if fp32:
        np.testing.assert_allclose(port, ref, atol=ATOL)
    else:
        assert _worst_row(port, ref, c // heads) <= BF16_ROW_TOL


@pytest.mark.parametrize("c", [33, 60, 64, 297, 300, 320, 1280, 1281, 2048])
def test_packed_route_equals_the_reference(monkeypatch, c):
    """`packed_shape_ok` is the reference's `use_packed_tiny` as it reads on a
    TPU, for every head count that divides C, and K2 takes every shape that
    either routes (no head width is left to the plain path)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("MOCA_TPU_NO_PALLAS", raising=False)
    divisors = [h for h in range(1, c + 1) if c % h == 0]
    routed = 0
    for s in (1, 4, 8, 12, 16, 24, 32, 40, 64):
        for kv in (s, 77):
            for bias in (None, 0.0):
                ref = jatt.use_packed_tiny(s, kv, bias, c)
                for heads in divisors:
                    assert tatt.packed_shape_ok(s, kv, bias, c, heads) == ref, (s, kv, bias, heads)
                    if ref:
                        assert tfa.packed_kernel_takes(s, c, heads)
                        routed += 1
    assert routed == (4 * len(divisors) if c <= 1280 else 0)  # S = 8, 16, 24, 32
    # the route is for CUDA tensors only: the CPU takes the plain version
    assert not tatt.use_packed_tiny(torch.zeros(2, 16, c), 16, 16, None, c, 1)


def _write_back(written, c0, c1, a, end, e):
    """`write_span` for one staged row: whole chunks inside [a, end), and the
    edge chunks element by element, only inside [a, end)."""
    for ch in range(c0, c1):
        lo = ch * e
        if lo >= a and lo + e <= end:
            written[lo:lo + e] += 1
        else:
            for x in range(lo, lo + e):
                if a <= x < end:
                    written[x] += 1


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("s,c,heads", CASES + [(16, 320, 40)])
def test_span_copy_plan_matches_slicing(s, c, heads, itemsize):
    """Every group of heads a CTA may stage at d <= SPAN_SLICE (the library
    picks one by `span_group`), one head a CTA above."""
    d, e = c // heads, 16 // itemsize
    slab = np.arange(s * c)  # element ids of one row's [S, C] slab
    for group in range(1, heads + 1) if d <= SPAN_SLICE else (1,):
        written = np.zeros(s * c, np.int64)
        ctas = span_ctas(heads, d, group)
        assert len(ctas) == -(-heads // group)
        for cols, spans in ctas:
            ldr, lg = span_ldr(cols, itemsize), span_lg(cols, itemsize)
            assert ldr % e == 0 and (ldr // e) % 8 == 1  # rows 16 bytes apart mod 128
            for b0, b1 in spans:
                assert 0 < b1 - b0 <= cols
                raw = np.full(s * ldr, -1)
                for r, (c0, c1, off) in enumerate(span_row_chunks(s, c, b0, b1, itemsize)):
                    assert 0 <= c0 < c1 <= s * c // e           # aligned chunks in the slab
                    assert c1 - c0 <= min(ldr // e, 2 ** lg)    # the staged row holds them
                    assert off == ((r * (c % e) + b0 % e) & (e - 1))  # the kernel's Span::row
                    if d % 2 == 0:
                        assert off % 2 == 0                     # 32-bit (and float2) loads
                    if d % e == 0:
                        assert off == 0                         # ldmatrix rows / float4 loads
                    for j, ch in enumerate(range(c0, c1)):
                        raw[r * ldr + j * e:r * ldr + (j + 1) * e] = slab[ch * e:(ch + 1) * e]
                    got = raw[r * ldr + off:r * ldr + off + (b1 - b0)]
                    np.testing.assert_array_equal(got, slab[r * c + b0:r * c + b1])
                    _write_back(written, c0, c1, r * c + b0, r * c + b1, e)
        np.testing.assert_array_equal(written, np.ones(s * c, np.int64), err_msg=str(group))


def test_unet_at_head_width_20_matches_jax(monkeypatch):
    """The small U-Net of tests/test_torch_unet_options.py at
    num_head_channels=20 and 8 frames (the reference routes S = 8, not its
    4): 1 and 3 heads at 32 and 64 channels (inner 20 and 60), 8 at the init
    attention (inner 160). Every temporal attention goes through
    `packed_attention` (routed as on the card, its plain version on the CPU)
    with C = inner, and the forward matches the JAX package's (fp32, where
    the reference's CPU route is XLA's)."""
    f = 8
    junet3d, params, model, tcfg = _unet_pair(12, num_head_channels=20, temporal_length=f)
    x = _rand((2, f, 8, 8, 4), 1)
    ts = np.random.default_rng(2).integers(0, 1000, (2, f)).astype(np.int32)
    ctx = _rand((2, 7, tcfg.context_dim), 3)
    ref = jax.jit(functools.partial(junet3d.apply, fps=10))(
        params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    calls = []

    def packed(q, k, v, heads):
        calls.append((q.shape[1], q.shape[2], heads))
        return tfa.packed_attention(q, k, v, heads)

    monkeypatch.setattr(tunet, "use_packed_tiny",
                        lambda q, *shape: tatt.packed_shape_ok(*shape))
    monkeypatch.setattr(tunet, "packed_attention", packed)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(ts).long(), torch.from_numpy(ctx),
                    fps=10)
    _close(out.numpy(), ref)
    temporal = [m for tt in model.modules() if isinstance(tt, tunet.TemporalTransformer)
                for m in tt.modules() if isinstance(m, tunet.CrossAttention)]
    assert {(m.heads * m.dim_head, m.heads) for m in temporal} == {(20, 1), (60, 3), (160, 8)}
    assert sorted(call for call in calls if call[0] == f) == sorted(
        (f, m.heads * m.dim_head, m.heads) for m in temporal)
    assert all(c == heads * 20 for _, c, heads in calls)
