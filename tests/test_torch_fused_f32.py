"""The arithmetic of K3's fp32 design (3xTF32 on the tensor cores,
`f32::tf32x3_fwd` in moca_tpu_torch/csrc/fused_qkv_attention.cu), emulated
on the CPU.

The kernel cannot run here; its arithmetic can. `_emulate` follows the
kernel through K3's whole chain: tiles of 128 token rows (whole sequences:
120 at S = 24) whose rows past the tile or the tensor are clamped copies;
each CTA of a head-split cluster taking its share of the heads; per head one
[T, C] x [C, 192] product (Wq, Wk, Wv rows) in 3xTF32 (`_mm` of
tests/test_torch_f32_split.py: the split to the nearest tf32, hi*hi + hi*lo + lo*hi,
what the tensor cores read of each part); the S x S attention by the
kernel's units (16 rows at S <= 16, masked block-diagonally at S = 8; a
sequence at S = 24, 32) with its QK^T and PV in 3xTF32 and the softmax exact
in fp32 with base-2 exponents; the heads' outputs through a scratch; the out
projection in passes of up to three 64-column blocks of Wo, plus bo. The
kernel's fragments (the k relabelling of K1's QK^T, the warp tiles of 64
rows by a pass's columns over four, the staging of q | k | v) are checked
on one ring stage, lane by lane
(the attention's relabellings are K1's, checked in tests/test_torch_f32_split.py).

Tolerance: FP32_TOL = 1e-4 worst-row relative L2 (rows of 64 columns), the
fp32 paths' limit on the card (chip_smoke.py, tests/test_torch_cuda.py).
Against the plain version in fp32 and against `_fused_qkv_kernel` run with
interpret=True on fp32 the emulation reads ~1e-6; one TF32 product (hi*hi
alone) reads ~1e-3, above the limit. Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_f32_split import FP32_TOL, _mm, _mma, _row_err
from test_torch_switches import _fused_qkv_interpret

from moca_tpu_torch.ops import flash_attention as tfa

D, TM, NBW, KC = 64, 128, 3, 16  # head width, tile rows, blocks a pass, stage depth
LOG2E = 1.4426950408889634


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale)
                            .astype(np.float32))


def _inputs(n, s, c, seed):
    """x [n, s, c]; Wq, Wk, Wv, Wo [C, C] in nn.Linear's layout, N(0, 1/C);
    bo [C]."""
    return (_rand((n, s, c), seed), *(_rand((c, c), seed + 1 + i, c ** -0.5) for i in range(4)),
            _rand((c,), seed + 5, 0.1))


def _emulate(x, wq, wk, wv, wo, bo, split=1, products=3):
    """K3's fp32 kernel on x [N, S, C], tile by tile and head by head, with
    the heads of a tile split over `split` CTAs."""
    n, s, c = x.shape
    ntok, heads = n * s, c // D
    t_rows = TM // s * s
    x2 = x.reshape(ntok, c)
    scratch = torch.full_like(x2, float("nan"))
    out = torch.full_like(x2, float("nan"))
    hper = heads // split
    scale_log2 = D ** -0.5 * LOG2E
    # a warp's unit of the attention: 16 rows at S <= 16 (two sequences at
    # S = 8, their logits masked block-diagonally), else one sequence
    unit = 16 if s <= 16 else s
    seq = torch.arange(unit) // s
    mask = torch.where(seq[:, None] == seq[None, :], 0.0, -torch.inf)
    tiles = range(0, ntok, t_rows)
    rows = lambda tok0: torch.clamp(tok0 + torch.clamp(torch.arange(TM), max=t_rows - 1),
                                    max=ntok - 1)
    stored = lambda tok0: (tok0 + torch.arange(TM) < ntok) & (torch.arange(TM) < t_rows)
    for tok0 in tiles:  # the q | k | v product and the attention of each head
        a, keep = x2[rows(tok0)], stored(tok0)
        for rank in range(split):
            for h in range(rank * hper, (rank + 1) * hper):
                w3 = torch.cat([w[h * D:(h + 1) * D] for w in (wq, wk, wv)])
                qkv = _mm(a, w3.t(), products)[:t_rows].reshape(t_rows // unit, unit, 3 * D)
                q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
                logits = _mm(q, k.transpose(1, 2), products) * scale_log2 + mask
                p = torch.exp2(logits - logits.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                o = _mm(p, v, products).reshape(t_rows, D)
                idx = (tok0 + torch.arange(t_rows))[keep[:t_rows]]
                scratch[idx, h * D:(h + 1) * D] = o[keep[:t_rows]]
    for tok0 in tiles:  # the out projection, every head of the tile in
        a, keep = scratch[rows(tok0)], stored(tok0)
        for rank in range(split):
            for b0 in range(rank * hper, (rank + 1) * hper, NBW):
                cols = slice(b0 * D, min(b0 + NBW, (rank + 1) * hper) * D)
                y = _mm(a, wo[cols].t(), products) + bo[cols]
                out[(tok0 + torch.arange(TM))[keep], cols] = y[keep]
    return out.reshape(n, s, c)


SHAPES = [  # (N, S, C, split): ragged last tiles, the head split, S = 8 to 32
    (21, 16, 64, 1),    # 336 tokens: 2.625 tiles
    (20, 8, 128, 2),    # two sequences an m16 tile's worth, heads split over 2 CTAs
    (9, 16, 128, 1),    # below one and a half tiles
    (35, 8, 128, 1),    # 280 tokens: a ragged third tile at S = 8
    (11, 16, 64, 1),    # C = 64: one head, one out-projection block
    (11, 24, 64, 1),    # S = 24: 120-token tiles, 264 tokens
    (5, 32, 128, 2),    # S = 32: one tile, ragged, heads split
    (21, 16, 320, 5),   # C = 320's five heads over a cluster of 5
]


@pytest.mark.parametrize("n,s,c,split", SHAPES)
def test_emulated_k3_matches_plain(n, s, c, split):
    inputs = _inputs(n, s, c, 10)
    out = _emulate(*inputs, split=split)
    assert torch.isfinite(out).all()
    assert _row_err(out, tfa.fused_qkv_attention_plain(*inputs, c // D)) <= FP32_TOL


@pytest.mark.parametrize("n,s,c,split", SHAPES[:3])
def test_emulated_k3_matches_fused_qkv_kernel_interpret(n, s, c, split):
    """The emulation against `_fused_qkv_kernel` run with interpret=True on
    fp32 (weights in the JAX [in, out] layout)."""
    x, wq, wk, wv, wo, bo = _inputs(n, s, c, 20)
    nb = next(b for b in (4, 2, 1) if n % b == 0)
    ref = _fused_qkv_interpret(jnp.asarray(x.numpy()), *(jnp.asarray(w.numpy().T) for w in
                                                         (wq, wk, wv, wo)),
                               jnp.asarray(bo.numpy()), c // D, nb=nb)
    out = _emulate(x, wq, wk, wv, wo, bo, split=split)
    assert _row_err(out, torch.from_numpy(np.asarray(ref).copy())) <= FP32_TOL


def test_one_tf32_product_misses_the_limit():
    """hi*hi alone (plain TF32) reads above the limit where 3xTF32 reads far
    below it, on the same inputs."""
    inputs = _inputs(9, 16, 128, 30)
    ref = tfa.fused_qkv_attention_plain(*inputs, 2)
    assert _row_err(_emulate(*inputs), ref) <= FP32_TOL / 10
    assert _row_err(_emulate(*inputs, products=1), ref) > FP32_TOL


@pytest.mark.parametrize("nb", [3, 2, 1])
def test_stage_fragments_compute_the_products(nb):
    """One ring stage of the kernel's product, lane by lane: a stage holds
    128 A rows and nb 64-row weight blocks of KC = 16 columns; warp (wm, wn)
    = (warp // 4, warp % 4) takes A rows 64 wm + 16 mt + (g, g + 8) and
    weight rows cw wn + 8 nt + g, cw = 16 nb (a pass's columns spread evenly
    over the four wn), each lane reading columns 4t .. 4t + 3 (k = t, t + 4
    of step 0 are columns 4t, 4t + 1; of step 1, 4t + 2, 4t + 3); its C
    fragments land at row 64 wm + 16 mt + g (+ 8), column cw wn + 8 nt + 2t
    (+ 1). Together they must hold A @ W^T."""
    cw = 16 * nb
    a, w = _rand((TM, KC), 40), _rand((nb * D, KC), 41)
    staging = torch.full((TM, nb * D), float("nan"))
    lanes = torch.arange(32)
    g, t = lanes // 4, lanes % 4
    for warp in range(8):
        wm, wn = warp // 4, warp % 4
        for mt in range(4):
            r0 = wm * 64 + mt * 16
            for nt in range(cw // 8):
                n0 = wn * cw + nt * 8
                c = torch.zeros(32, 4)
                for step in range(2):
                    k0, k1 = 4 * t + 2 * step, 4 * t + 2 * step + 1
                    af = torch.stack([a[r0 + g, k0], a[r0 + g + 8, k0], a[r0 + g, k1],
                                      a[r0 + g + 8, k1]], dim=1)
                    bf = torch.stack([w[n0 + g, k0], w[n0 + g, k1]], dim=1)
                    c = _mma(af, bf, c)
                for i in range(4):
                    staging[r0 + g + 8 * (i // 2), n0 + 2 * t + i % 2] = c[:, i]
    ref = a.double() @ w.double().T
    np.testing.assert_allclose(staging.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_fp32_head_split_choices():
    """The clusters the wrapper asks of the fp32 path (128-token tiles, one
    CTA an SM): of the splits dividing the heads, the one that takes the
    fewest waves of 132 CTAs for the tile's work, each larger split only for
    more than a tenth fewer."""
    f32 = torch.float32
    for n, s, c in [(20480, 16, 320), (5120, 16, 640), (20480, 16, 512)]:
        assert tfa.fused_qkv_head_split(n, s, c, f32) == 1  # 19.4, 4.8, 19.4 waves: none saved
    assert tfa.fused_qkv_head_split(1280, 16, 1280, f32) == 4  # 160 tiles: 2 waves -> 1.25
    assert tfa.fused_qkv_head_split(320, 16, 1280, f32) == 5   # 40 tiles: 1 wave -> 0.4
    assert tfa.fused_qkv_head_split(256, 16, 512, f32) == 4    # 32 tiles, 8 heads
    assert tfa.fused_qkv_head_split(64, 16, 128, f32) == 2     # 8 tiles, 2 heads
    assert tfa.fused_qkv_head_split(21, 16, 320, f32) == 5     # 3 tiles, 5 heads
    assert tfa.fused_qkv_head_split(11, 16, 64, f32) == 1      # one head
    assert tfa.fused_qkv_head_split(1000, 16, 320, f32) == 1   # 125 tiles: 1 wave either way
    assert tfa.fused_qkv_head_split(512, 16, 1280, f32) == 2   # 64 tiles: 0.5 wave, 4 no better
    assert tfa.fused_qkv_head_split(1056, 16, 1280, f32) == 1  # 132 tiles: one whole wave
    assert tfa.fused_qkv_head_split(100, 24, 512, f32) == 4    # 120-token tiles: 20 of them
