"""The arithmetic of K1's and K4's fp32 design on the tensor cores (3xTF32,
moca_tpu_torch/csrc/attention_f32.cuh), emulated on the CPU.

The kernel cannot run here; its arithmetic can. `_split` is the kernel's
`split_tf32` (hi is x rounded to the nearest tf32 value on its bit pattern,
11 significant bits; lo = x - hi exactly), `_tf32` what the tensor cores read
of a 32-bit operand (its top 19 bits), and each product is
hi*hi + hi*lo + lo*hi summed in fp32. Over it run K1's online softmax and
K4's two sweeps on 64-row kv tiles, as the kernel runs them. The mma.sync
fragment layouts and the kernel's relabelling of the contraction index are
checked on one 16x8x8 tile each.

Tolerance: FP32_TOL = 1e-4 worst-row relative L2, the fp32 paths' limit on
the card (chip_smoke.py, tests/test_torch_cuda.py). 3xTF32 products are
within ~2^-21 of fp32 ones, a few 1e-6 here. One TF32 product (hi*hi
alone) rounds each input to a 2^-11 unit and reads ~5e-4 to 9e-4: above the
limit, which is why the kernel takes three. Inputs come from numpy with a
seed.
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
from moca_tpu_torch.ops import flash_attention as tfa

FP32_TOL = 1e-4
BN = 64  # the kernel's kv tile
LOG2E = 1.4426950408889634


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _tf32(x):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split_tf32: hi = (bits(x) + 2^12) with the low 13 bits
    cleared, x rounded to the nearest tf32 on its bit pattern; lo = x - hi
    (fp32)."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def _mm(a, b, products=3):
    """a @ b on the tensor cores in 3xTF32 (or, with products=1, plain TF32:
    the inputs rounded to tf32, hi*hi alone)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if products == 1:
        return _tf32(ah) @ _tf32(bh)
    return _tf32(al) @ _tf32(bh) + _tf32(ah) @ _tf32(bl) + _tf32(ah) @ _tf32(bh)


def _emulate(q, k, v, onepass=False, products=3):
    """K1 (online softmax) or K4 (two sweeps) of the 3xTF32 design on
    [B, S, H, D] fp32: q scaled by scale*log2(e) in fp32, base-2 exponents,
    kv tiles of BN rows with the last one ragged."""
    d, sk = q.shape[-1], k.shape[1]
    qs = (q * (d ** -0.5 * LOG2E)).permute(0, 2, 1, 3)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    m = torch.full(qs.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    logits = lambda j: _mm(qs, kt[:, :, j:j + BN].transpose(-1, -2), products)
    if onepass:  # sweep 1: the row max alone
        for j in range(0, sk, BN):
            m = torch.maximum(m, logits(j).amax(-1, keepdim=True))
    for j in range(0, sk, BN):
        s = logits(j)
        if not onepass:  # a new max rescales what came before; exp2(-inf) = 0 at the first tile
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mn)
            l, acc, m = l * alpha, acc * alpha, mn
        p = torch.exp2(s - m)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + _mm(p, vt[:, :, j:j + BN], products)
    return (acc / l).permute(0, 2, 1, 3)


def _row_err(out, ref):
    """max over rows of ||out - ref|| / ||ref||, rows being D-vectors."""
    d = ref.shape[-1]
    out, ref = out.double().reshape(-1, d), ref.double().reshape(-1, d)
    norm = ref.norm(dim=1)
    return ((out - ref).norm(dim=1) / norm.clamp_min(1e-6 * norm.max())).max().item()


def _qkv(b, sq, sk, h, d, seed):
    return _rand((b, sq, h, d), seed), _rand((b, sk, h, d), seed + 1), _rand((b, sk, h, d), seed + 2)


def test_split_is_exact_and_hi_is_tf32():
    """hi is a tf32 value (low 13 bits zero) within half its unit of x,
    hi + lo == x exactly, and the tensor cores' read of lo loses at most
    2^-22 |x|."""
    x = _rand((4096,), 0) * torch.exp2(_rand((4096,), 1) * 20)
    hi, lo = _split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    xd = x.double()
    assert torch.equal(hi.double() + lo.double(), xd)
    assert ((xd - hi.double()).abs() <= xd.abs() * 2.0 ** -11).all()
    assert ((lo.double() - _tf32(lo).double()).abs() <= xd.abs() * 2.0 ** -22).all()


def _mma(a_frag, b_frag, c_frag):
    """One mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 by its PTX fragment
    layouts: with g = lane // 4, t = lane % 4, A a0 (g, t), a1 (g+8, t),
    a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0, c1
    (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1). Fragments are [32 lanes, regs]."""
    a, bm, c = torch.zeros(16, 8), torch.zeros(8, 8), torch.zeros(16, 8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_frag[lane]
        bm[t, g], bm[t + 4, g] = b_frag[lane]
        c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1] = c_frag[lane]
    d = c + a.double().matmul(bm.double()).float()
    return torch.stack([torch.stack([d[lane // 4, 2 * (lane % 4)], d[lane // 4, 2 * (lane % 4) + 1],
                                     d[lane // 4 + 8, 2 * (lane % 4)],
                                     d[lane // 4 + 8, 2 * (lane % 4) + 1]]) for lane in range(32)])


def test_fragment_relabelling_computes_qk_and_pv():
    """The kernel's fragments on one tile: for QK^T the two k8 steps of a
    pair load q and K columns 16j + 4t .. + 3 (one 16-byte load a lane:
    k = t, t+4 of step 2j are columns 4t, 4t+1; of step 2j+1, 4t+2, 4t+3);
    for PV the logits' C fragment (columns 2t, 2t+1) is taken as the A
    fragment {c0, c2, c1, c3} (k = t is kv row 2t, k = t+4 kv row 2t+1),
    with V's rows 2t and 2t+1 as b0 and b1."""
    q, kk, v = _rand((16, 16), 10), _rand((8, 16), 11), _rand((8, 8), 12)
    s = torch.zeros(32, 4)
    for step in range(2):
        a = torch.stack([torch.stack([q[lane // 4, 4 * (lane % 4) + 2 * step],
                                      q[lane // 4 + 8, 4 * (lane % 4) + 2 * step],
                                      q[lane // 4, 4 * (lane % 4) + 2 * step + 1],
                                      q[lane // 4 + 8, 4 * (lane % 4) + 2 * step + 1]])
                         for lane in range(32)])
        b = torch.stack([torch.stack([kk[lane // 4, 4 * (lane % 4) + 2 * step],
                                      kk[lane // 4, 4 * (lane % 4) + 2 * step + 1]])
                         for lane in range(32)])
        s = _mma(a, b, s)
    ref = q.double() @ kk.double().T
    for lane in range(32):
        g, t = lane // 4, lane % 4
        got = [s[lane, 0], s[lane, 1], s[lane, 2], s[lane, 3]]
        want = [ref[g, 2 * t], ref[g, 2 * t + 1], ref[g + 8, 2 * t], ref[g + 8, 2 * t + 1]]
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5,
                                   atol=1e-5)
    p = s  # the logits' C fragments, as P
    a = p[:, [0, 2, 1, 3]]
    b = torch.stack([torch.stack([v[2 * (lane % 4), lane // 4], v[2 * (lane % 4) + 1, lane // 4]])
                     for lane in range(32)])
    o = _mma(a, b, torch.zeros(32, 4))
    pm = torch.zeros(16, 8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        pm[g, 2 * t], pm[g, 2 * t + 1], pm[g + 8, 2 * t], pm[g + 8, 2 * t + 1] = p[lane]
    ref = pm.double() @ v.double()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        want = [ref[g, 2 * t], ref[g, 2 * t + 1], ref[g + 8, 2 * t], ref[g + 8, 2 * t + 1]]
        np.testing.assert_allclose(o[lane].tolist(), [float(x) for x in want], rtol=1e-5,
                                   atol=1e-4)


SHAPES = [
    (2, 160, 154, 2, 64),    # text cross-attention at kv = 154: a ragged third tile
    (2, 200, 17, 2, 128),    # Sk not a multiple of 8, D = 128
    (1, 100, 1, 2, 64),      # one key
    (1, 40, 300, 2, 128),    # five tiles, D = 128
    (1, 256, 640, 1, 64),    # ten whole tiles
]


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_emulated_k1_matches_plain(b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, 20)
    assert _row_err(_emulate(q, k, v), tfa.attention_plain(q, k, v)) <= FP32_TOL


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_emulated_k4_matches_plain(b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, 30)
    out = _emulate(q, k, v, onepass=True)
    assert _row_err(out, tfa.flash_attention_onepass_plain(q, k, v)) <= FP32_TOL


@pytest.mark.parametrize("onepass", [False, True])
def test_one_tf32_product_misses_the_limit(onepass):
    """hi*hi alone (plain TF32) reads above the limit where 3xTF32 reads
    far below it, on the same inputs."""
    q, k, v = _qkv(2, 160, 154, 2, 64, 40)
    plain = tfa.flash_attention_onepass_plain if onepass else tfa.attention_plain
    ref = plain(q, k, v)
    assert _row_err(_emulate(q, k, v, onepass), ref) <= FP32_TOL / 10
    assert _row_err(_emulate(q, k, v, onepass, products=1), ref) > FP32_TOL


def _bh(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 1, 3))


@pytest.mark.parametrize("d", [64, 128])
def test_emulated_k1_matches_fa_kernel_interpret(d):
    """The emulation against `_fa_kernel` run with interpret=True on fp32:
    Sq = 40 in one q block, Sk = 77 in 7 kv blocks of 11 (the Pallas online
    softmax), against the emulation's tiles of 64 and 13."""
    b, sq, sk, h, bkv = 1, 40, 77, 2, 11
    q, k, v = _qkv(b, sq, sk, h, d, 50)
    kernel = functools.partial(jfa._fa_kernel, scale=d ** -0.5, nkv=sk // bkv, stat_lanes=128)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, h, sq, d), jnp.float32),
        grid=(b, h, 1, sk // bkv),
        in_specs=[
            pl.BlockSpec((1, 1, sq, d), lambda b_, h_, i, j: (b_, h_, i, 0)),
            pl.BlockSpec((1, 1, bkv, d), lambda b_, h_, i, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, bkv, d), lambda b_, h_, i, j: (b_, h_, j, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, sq, d), lambda b_, h_, i, j: (b_, h_, i, 0)),
        scratch_shapes=[pltpu.VMEM((sq, 128), jnp.float32), pltpu.VMEM((sq, 128), jnp.float32),
                        pltpu.VMEM((sq, d), jnp.float32)],
        interpret=True,
    )(_bh(q), _bh(k), _bh(v))
    ref = torch.from_numpy(np.asarray(out).transpose(0, 2, 1, 3).copy())
    assert _row_err(_emulate(q, k, v), ref) <= FP32_TOL


@pytest.mark.parametrize("d", [64, 128])
def test_emulated_k4_matches_fa_onepass_kernel_interpret(d):
    """The two-sweep emulation against `_fa_onepass_kernel` (the whole kv row
    in one block) run with interpret=True on fp32, at a ragged Sk."""
    b, sq, sk, h = 1, 40, 154, 2
    q, k, v = _qkv(b, sq, sk, h, d, 60)
    out = pl.pallas_call(
        functools.partial(jfa._fa_onepass_kernel, scale=d ** -0.5),
        out_shape=jax.ShapeDtypeStruct((b, h, sq, d), jnp.float32),
        grid=(b, h),
        in_specs=[
            pl.BlockSpec((1, 1, sq, d), lambda b_, h_: (b_, h_, 0, 0)),
            pl.BlockSpec((1, 1, sk, d), lambda b_, h_: (b_, h_, 0, 0)),
            pl.BlockSpec((1, 1, sk, d), lambda b_, h_: (b_, h_, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, sq, d), lambda b_, h_: (b_, h_, 0, 0)),
        interpret=True,
    )(_bh(q), _bh(k), _bh(v))
    ref = torch.from_numpy(np.asarray(out).transpose(0, 2, 1, 3).copy())
    assert _row_err(_emulate(q, k, v, onepass=True), ref) <= FP32_TOL


def _attention_f64(q, k, v):
    """softmax(q k^T / sqrt(d)) v in float64: the function the fp32 inputs define."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("kind", ["overflow", "underflow", "denom_overflow"])
def test_emulated_softmax_hazards(onepass, kind):
    """The softmax hazards of tests/test_torch_cuda.py on the emulation:
    logits of 1e4 in magnitude, equal across a row (underflow,
    denom_overflow) or spread by hundreds (overflow). The output is finite
    and as close to the float64 function as FP32_TOL, or as twice the fp32
    plain version's error where that is further (an fp32 logit of 1e4 is
    only good to ~1e-3)."""
    q, k, v = _qkv(2, 160, 200, 2, 64, 50)
    if kind == "overflow":
        q[0] = q[0].abs() + 40.0
        k[0] = k[0].abs() + 40.0
    elif kind == "denom_overflow":
        q.fill_(3.25)
        k.fill_(3.25)
        v = v * 1e-5
    else:
        q.fill_(-40.0)
        k.fill_(40.0)
    plain = tfa.flash_attention_onepass_plain if onepass else tfa.attention_plain
    exact = _attention_f64(q, k, v)
    tol = max(FP32_TOL, 2 * _row_err(plain(q, k, v), exact))
    out = _emulate(q, k, v, onepass)
    assert torch.isfinite(out).all()
    assert _row_err(out, exact) <= tol
