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

The fp32 paths (every kernel takes float32 too) are held to their plain
versions computed in full fp32 (`allow_tf32` off while they run) at
FP32_TOL = 1e-4 worst-row relative L2: both sum fp32 products in other
orders, a few 1e-6 relative on an H100 (K1's, K3's and K4's 3xTF32 products
within ~2^-21 of fp32 products); plain TF32 products would round each input
to a 2^-11 (4.9e-4) unit, which the limit does not admit; the same planted
faults read far above it.
"""

import contextlib

import pytest
import torch

from moca_tpu_torch.ops import flash_attention as tfa

TOL = 2e-2
FP32_TOL = 1e-4


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
    # float16: no kernel takes it, and there is no fallback
    q = torch.zeros(2, 160, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
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
    # K1's and K4's fp32 path has one design: it takes no `path`
    q32 = torch.zeros(2, 160, 2, 64, device="cuda")
    for kernel in ("flash", "onepass"):
        for path in tfa.ATTENTION_PATHS:
            with pytest.raises(ValueError, match="one design"):
                _attention(kernel, path, q32, q32, q32)


@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls in full fp32 (no TF32) while the plain version runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _attention_faults(run, q, k, v):
    """Planted faults of K1 and K4 through their inputs: the last 64-row kv
    tile left out (at Sk <= 64, the last key left out of PV) and, where the
    output depends on q (Sk > 1), the softmax scale halved."""
    sk = k.shape[1]
    if sk > 64:
        faults = [run(q, k[:, :sk - 64].contiguous(), v[:, :sk - 64].contiguous())]
    else:
        v_cut = v.clone()
        v_cut[:, -1] = 0
        faults = [run(q, k, v_cut)]
    if sk > 1:
        faults.append(run(q * 0.5, k, v))
    return faults


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("flash", (1, 2560, 2560, 2, 64)),   # flash shape: S = 2560
    ("flash", (2, 160, 160, 4, 64)),     # small S: ragged q and kv tiles
    ("flash", (2, 640, 154, 2, 64)),     # text cross-attention, kv = 154
    ("flash", (2, 200, 300, 2, 128)),    # D = 128
    ("onepass", (1, 2560, 2560, 2, 64)),
    ("onepass", (2, 160, 154, 2, 64)),
    ("onepass", (2, 200, 300, 2, 128)),
    ("flash", (2, 160, 1, 2, 64)),       # Sk = 1: a tile of one key
    ("flash", (2, 200, 17, 2, 128)),     # Sk = 17: not a multiple of 8, D = 128
    ("flash", (2, 200, 77, 2, 64)),      # text cross-attention, kv = 77
    ("flash", (1, 2560, 154, 2, 64)),    # kv = 154 at Sq = 2560
    ("flash", (1, 160, 2560, 2, 128)),   # a long kv row at D = 128
    ("onepass", (2, 200, 1, 2, 128)),
    ("onepass", (2, 160, 17, 2, 64)),
    ("onepass", (2, 160, 77, 2, 128)),
    ("onepass", (1, 2560, 300, 2, 64)),
    ("onepass", (1, 200, 2560, 2, 64)),
    ("packed", (64, 16, 128, 4)),        # S = 16, d = 32
    ("packed", (64, 16, 320, 5)),        # S = 16, d = 64
    ("packed", (64, 16, 256, 2)),        # S = 16, d = 128
    ("packed", (64, 8, 128, 2)),         # S = 8: four lanes a row
    ("packed", (16, 24, 384, 6)),        # S = 24: a lane a row, 8 lanes idle
    ("packed", (16, 32, 256, 2)),        # S = 32, d = 128
    ("fused", (65, 16, 320)),            # C = 320, a partial last tile
    ("fused", (7, 24, 384)),             # S = 24: 48-token tiles
    ("fused", (20, 8, 128)),             # S = 8
    ("fused", (33, 16, 1280)),           # C = 1280
])
def test_cuda_fp32_paths_match_plain(kernel, shape):
    """Every kernel's fp32 path against its plain version in full fp32,
    within FP32_TOL, with the bf16 checks' planted faults above it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *sh, scale=1.0: torch.randn(sh, generator=gen, device="cuda") * scale
    tfa.reset_launch_counts()
    if kernel in ("flash", "onepass"):
        b, sq, sk, h, d = shape
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
        fn = tfa.flash_attention_onepass if kernel == "onepass" else tfa.flash_attention
        plain = tfa.flash_attention_onepass_plain if kernel == "onepass" else tfa.attention_plain
        out = fn(q, k, v)
        assert fn.launches == {shape + ("fp32",): 1}
        faults = _attention_faults(fn, q, k, v)
        with _full_fp32():
            ref = plain(q, k, v)
    elif kernel == "packed":
        n, s, c, heads = shape
        d = c // heads
        q, k, v = rnd(n, s, c), rnd(n, s, c), rnd(n, s, c)
        out = tfa.packed_attention(q, k, v, heads)
        assert tfa.packed_attention.launches == {shape + ("fp32",): 1}
        v_cut = v.clone()
        v_cut[:, -1] = 0
        faults = (tfa.packed_attention(q, k, v_cut, heads),
                  tfa.packed_attention(q * 0.5, k, v, heads))
        with _full_fp32():
            ref = tfa.packed_attention_plain(q, k, v, heads)
    else:
        n, s, c = shape
        d, heads = 64, c // 64
        x = rnd(n, s, c)
        wq, wk, wv, wo = (rnd(c, c, scale=c ** -0.5) for _ in range(4))
        bo = rnd(c, scale=0.1)
        out = tfa.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)
        assert tfa.fused_qkv_attention.launches == {shape + ("fp32",): 1}
        wv_cut = wv.clone()
        wv_cut[-64:] = 0
        faults = (tfa.fused_qkv_attention(x, wq * 0.5, wk, wv, wo, bo, heads),
                  tfa.fused_qkv_attention(x, wq, wk, wv_cut, wo, bo, heads))
        with _full_fp32():
            ref = tfa.fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert max_row_rel_err(out, ref, d) <= FP32_TOL
    for fault in faults:
        assert max_row_rel_err(fault, ref, d) > FP32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c,split", [
    (20, 8, 64, 1),       # S = 8, one head: 160 tokens, a ragged second tile
    (9, 32, 64, 1),       # S = 32: 288 tokens, a ragged third tile
    (21, 16, 320, 5),     # a ragged last tile, the 5 heads over clusters of 5
    (11, 24, 320, 5),     # S = 24: 120-token tiles, 264 tokens
    (40, 32, 320, 5),     # S = 32 at C = 320: 10 whole tiles
    (1000, 16, 320, 1),   # 125 tiles: no split
    (64, 16, 128, 2),     # 8 tiles: the heads split over 2 CTAs
    (256, 16, 512, 4),    # phase 3's init attention: 32 tiles, clusters of 4
    (5, 8, 1280, 5),      # S = 8 at C = 1280, below one tile, clusters of 5
    (7, 24, 1280, 5),     # S = 24 at C = 1280: 168 tokens, clusters of 5
    (240, 16, 1280, 4),   # C = 1280, 30 tiles: clusters of 4
    (512, 16, 1280, 2),   # 64 tiles: clusters of 2
    (300, 16, 1280, 5),   # 38 tiles: clusters of 5
    (1100, 16, 1280, 4),  # 138 tiles: 2 waves unsplit, 5 of 4x as many CTAs
    (1056, 16, 1280, 1),  # 132 tiles: one whole wave, no split
])
def test_cuda_fused_qkv_fp32_matches_plain(n, s, c, split):
    """K3's fp32 path (3xTF32) against its plain version in full fp32 within
    FP32_TOL, with its planted faults far above it; `split` is the cluster
    size the wrapper asks for (`fused_qkv_head_split`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert tfa.fused_qkv_head_split(n, s, c, torch.float32) == split
    gen = torch.Generator(device="cuda").manual_seed(8)
    rnd = lambda *sh, scale=1.0: torch.randn(sh, generator=gen, device="cuda") * scale
    heads = c // 64
    x = rnd(n, s, c)
    wq, wk, wv, wo = (rnd(c, c, scale=c ** -0.5) for _ in range(4))
    bo = rnd(c, scale=0.1)
    tfa.reset_launch_counts()
    out = tfa.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)
    assert tfa.fused_qkv_attention.launches == {(n, s, c, "fp32"): 1}
    wv_cut = wv.clone()
    wv_cut[-64:] = 0
    faults = (tfa.fused_qkv_attention(x, wq * 0.5, wk, wv, wo, bo, heads),
              tfa.fused_qkv_attention(x, wq, wk, wv_cut, wo, bo, heads))
    with _full_fp32():
        ref = tfa.fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert max_row_rel_err(out, ref) <= FP32_TOL
    for fault in faults:
        assert max_row_rel_err(fault, ref) > 100 * FP32_TOL


def _attention_f64(q, k, v):
    """softmax(q k^T / sqrt(d)) v in float64: the function the fp32 inputs define."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "onepass"])
@pytest.mark.parametrize("kind", ["overflow", "underflow", "denom_overflow"])
def test_cuda_fp32_on_softmax_hazards(kernel, kind):
    """The softmax hazards in fp32: logits of 1e4 in
    magnitude, equal across a row (underflow, denom_overflow) or spread by
    hundreds (overflow). The output must be finite and as close to the
    float64 function as FP32_TOL, or as the fp32 plain version is where
    that is further: at logits of 1e4 an fp32 logit is only good to ~1e-3
    (2^-24 relative), and the softmax carries that error to every row
    whose weights are split over keys within a few units of each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((2, 320, 2, 64), generator=gen, device="cuda") for _ in range(3))
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
    exact = _attention_f64(q, k, v)
    with _full_fp32():
        tol = max(FP32_TOL, 2 * max_row_rel_err(plain(q, k, v), exact))
    out = _attention(kernel, None, q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert max_row_rel_err(out, exact) <= tol
