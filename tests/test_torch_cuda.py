"""The port's CUDA kernels against their plain versions, on a card.

Needs an NVIDIA GPU and nvcc; skips without them. The file imports neither
JAX nor the JAX package, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the largest relative L2 error of one output row (the d-vector of
one query and head; for K3 a 64-column slice of one output token),
||kernel - plain|| / ||plain||, at most 2e-2. Kernel and plain version round
the probabilities and the output to bf16 at different points, a few 2^-8
relative. The same limit is held in chip_smoke.py, and each case also checks
that planted faults exceed it: for K1, K2 and K4 the last kv tile or key left
out and the softmax scale halved; for K3 Wq halved and the last head's Wv
rows zeroed. K1 and K4 are held to it on each of their designs.
"""

import pytest
import torch

from moca_tpu_torch.ops import flash_attention as tfa

TOL = 2e-2


def max_row_rel_err(out, ref, d=64):
    """max over rows of ||out - ref|| / ||ref||, rows being d-vectors."""
    out, ref = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    ref_norm = ref.norm(dim=1)
    return ((out - ref).norm(dim=1) / ref_norm.clamp_min(1e-6 * ref_norm.max())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("flash", (2, 160, 4, 64)),    # one row tile per warp, ragged tail
    ("flash", (2, 640, 2, 64)),    # two row tiles per warp
    ("flash", (2, 200, 2, 128)),   # D = 128
    ("packed", (64, 16, 320)),     # C = 320 (5 heads)
    ("packed", (64, 8, 128)),      # S = 8, padded to a whole tile
    ("packed", (64, 24, 1280)),    # S = 24, two row tiles
])
def test_cuda_kernel_matches_plain(kernel, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    tfa.reset_launch_counts()
    d = shape[-1] if kernel == "flash" else 64
    if kernel == "flash":
        out, ref = tfa.flash_attention(q, k, v), tfa.attention_plain(q, k, v)
        assert sum(tfa.flash_attention.launches.values()) == 1
        cut = k.shape[1] - 64  # the last kv tile left out
        faults = (tfa.flash_attention(q, k[:, :cut].contiguous(), v[:, :cut].contiguous()),
                  tfa.flash_attention(q * 0.5, k, v))
    else:
        heads = shape[-1] // 64
        out = tfa.packed_attention(q, k, v, heads)
        ref = tfa.packed_attention_plain(q, k, v, heads)
        assert sum(tfa.packed_attention.launches.values()) == 1
        v_cut = v.clone()
        v_cut[:, -1] = 0  # the last key left out of the PV product
        faults = (tfa.packed_attention(q, k, v_cut, heads),
                  tfa.packed_attention(q * 0.5, k, v, heads))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert max_row_rel_err(out, ref, d) <= TOL
    for fault in faults:
        assert max_row_rel_err(fault, ref, d) > TOL


def _check(out, ref, faults, d):
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert max_row_rel_err(out, ref, d) <= TOL
    for fault in faults:
        assert max_row_rel_err(fault, ref, d) > TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c,heads", [
    (64, 16, 40, 5),     # d = 8: padded to the mma depth
    (64, 16, 128, 4),    # d = 32
    (64, 16, 80, 2),     # d = 40: padded to 48
    (64, 16, 256, 2),    # d = 128
    (16, 32, 256, 2),    # d = 128 at S = 32: one warp a block
])
def test_cuda_packed_attention_at_other_head_widths(n, s, c, heads):
    """K2 at the head widths of `_packed_tiny_kernel`'s route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((n, s, c), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    tfa.reset_launch_counts()
    out = tfa.packed_attention(q, k, v, heads)
    assert tfa.packed_attention.launches == {(n, s, c, heads): 1}
    v_cut = v.clone()
    v_cut[:, -1] = 0
    faults = (tfa.packed_attention(q, k, v_cut, heads), tfa.packed_attention(q * 0.5, k, v, heads))
    _check(out, tfa.packed_attention_plain(q, k, v, heads), faults, c // heads)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c", [
    (65, 16, 320),     # 4 sequences a tile and a partial last tile, two tiles a CTA
    (33, 16, 1280),    # C = 1280: heads split over a cluster of 4, scratch
    (20, 8, 128),      # S = 8: two sequences in one m16 tile
    (7, 24, 384),      # S = 24: padded rows read past the sequence
    (3, 16, 320),      # N below one tile
    (21, 16, 320),     # 5.25 tiles: a CTA with one ragged tile
    (70, 16, 512),     # C = 512 (the init attention's width)
    (300, 16, 1280),   # C = 1280 without a split: one weight block a stage
    (80, 16, 1280),    # the middle block's shape: heads split over 4 CTAs
    (40, 8, 640),      # S = 8 at C = 640
    (30, 24, 640),     # S = 24 at C = 640: 48-token tiles
    (16, 32, 1280),    # S = 32 at C = 1280, heads split
    (4757, 16, 320),   # 3 tiles a CTA (attention from registers), a ragged last CTA
    (9515, 8, 320),    # S = 8: two sequences a warp, 3 tiles a CTA
    (3181, 16, 640),   # 2 tiles a CTA on one-block stages
    (3181, 16, 512),   # 2 tiles a CTA on three-block stages
    (1601, 32, 320),   # S = 32: 2 tiles a CTA with q/k/v staging
])
def test_cuda_fused_qkv_attention_matches_plain(n, s, c):
    """K3 against its plain version; weights N(0, 1/C) so that q, k, v and
    the logits are O(1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda")
                                     * scale).to(torch.bfloat16)
    heads = c // 64
    x = rnd(n, s, c)
    wq, wk, wv, wo = (rnd(c, c, scale=c ** -0.5) for _ in range(4))
    bo = rnd(c, scale=0.1)
    tfa.reset_launch_counts()
    out = tfa.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)
    assert tfa.fused_qkv_attention.launches == {(n, s, c): 1}
    wv_cut = wv.clone()
    wv_cut[-64:] = 0  # the last head's v rows
    faults = (tfa.fused_qkv_attention(x, wq * 0.5, wk, wv, wo, bo, heads),
              tfa.fused_qkv_attention(x, wq, wk, wv_cut, wo, bo, heads))
    _check(out, tfa.fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads), faults, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 2560, 2560, 2, 64),   # self-attention at S = 2560, two row tiles a warp
    (2, 640, 154, 4, 64),     # text cross-attention, kv = 154: ragged last tile
    (2, 160, 154, 2, 64),     # one row tile a warp
    (1, 300, 200, 2, 128),    # D = 128
    (1, 200, 2000, 2, 64),    # Sk = 2000: a ragged last tile of 16 keys
    (1, 100, 3000, 1, 64),    # Sk = 3000, ragged
    (1, 128, 8192, 1, 64),    # a long row, as the route sends at small Sq
])
def test_cuda_flash_attention_onepass_matches_plain(b, sq, sk, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    tfa.reset_launch_counts()
    out = tfa.flash_attention_onepass(q, k, v)
    assert tfa.flash_attention_onepass.launches == {(b, sq, sk, h, d): 1}
    cut = sk - 64
    faults = (tfa.flash_attention_onepass(q, k[:, :cut].contiguous(), v[:, :cut].contiguous()),
              tfa.flash_attention_onepass(q * 0.5, k, v))
    _check(out, tfa.flash_attention_onepass_plain(q, k, v), faults, d)


ATTENTION_SHAPES = [
    (2, 640, 154, 2, 64),     # Sk = 154: a partial last kv tile (of 64 and of 128 rows)
    (2, 256, 128, 2, 64),     # Sk = 128: exactly one 128-row kv tile
    (2, 160, 160, 4, 64),     # Sq = 160: a partial q tile, one warpgroup's rows wholly past Sq
    (2, 200, 200, 2, 64),     # Sq = 200: both warpgroups' q tiles partial
    (1, 2560, 2560, 2, 64),   # S = 2560 at a small B
    (2, 200, 300, 2, 128),    # D = 128
    (1, 640, 640, 2, 128),    # D = 128, whole tiles
    (8, 640, 640, 10, 64),    # 400 work tiles: several a persistent CTA
    (4, 2560, 154, 5, 64),    # 400 work tiles at a ragged kv row
]


def _attention(kernel, path, q, k, v):
    """K1 or K4 on the design `path` (None: the library's choice)."""
    wrapper = tfa.flash_attention_onepass if kernel == "onepass" else tfa.flash_attention
    return tfa._attention_call(wrapper, kernel, q, k, v, path=path)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "onepass"])
@pytest.mark.parametrize("b,sq,sk,h,d", ATTENTION_SHAPES)
def test_cuda_attention_designs_match_plain(kernel, b, sq, sk, h, d):
    """K1 and K4 on every design (mma.sync, wgmma with 64- and 128-row kv
    tiles, and the library's choice) against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    plain = tfa.flash_attention_onepass_plain if kernel == "onepass" else tfa.attention_plain
    ref = plain(q, k, v)
    cut = sk - 64
    for path in tfa.ATTENTION_PATHS + (None,):
        out = _attention(kernel, path, q, k, v)
        faults = (_attention(kernel, path, q, k[:, :cut].contiguous(), v[:, :cut].contiguous()),
                  _attention(kernel, path, q * 0.5, k, v))
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), path
        assert max_row_rel_err(out, ref, d) <= TOL, path
        for fault in faults:
            assert max_row_rel_err(fault, ref, d) > TOL, path


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "onepass"])
@pytest.mark.parametrize("kind", ["overflow", "underflow", "denom_overflow"])
def test_cuda_attention_designs_on_softmax_hazards(kernel, kind):
    """The softmax hazards of tests/test_flash_attention.py:212-228 on every
    design: finite output that matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 320, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
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
    plain = tfa.flash_attention_onepass_plain if kernel == "onepass" else tfa.attention_plain
    ref = plain(q, k, v)
    for path in tfa.ATTENTION_PATHS:
        out = _attention(kernel, path, q, k, v)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), path
        assert max_row_rel_err(out, ref) <= TOL, path


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q = torch.zeros(2, 160, 2, 64, device="cuda")  # fp32: no kernel, no fallback
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_onepass(q, q, q)
    p = torch.zeros(4, 16, 72, device="cuda", dtype=torch.bfloat16)  # d = 36
    with pytest.raises(ValueError, match="unsupported"):
        tfa.packed_attention(p, p, p, 2)
    p = torch.zeros(4, 40, 128, device="cuda", dtype=torch.bfloat16)  # S = 40
    with pytest.raises(ValueError, match="unsupported"):
        tfa.packed_attention(p, p, p, 2)
    x = torch.zeros(4, 16, 256, device="cuda", dtype=torch.bfloat16)  # d = 32
    w = torch.zeros(256, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.fused_qkv_attention(x, w, w, w, w, w[0], 8)
