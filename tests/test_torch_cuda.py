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
import math

import pytest
import torch

from moca_tpu_torch.ops import flash_attention as tfa
from moca_tpu_torch.ops import geglu as tg
from moca_tpu_torch.ops import norms as tn

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


_WIDTHS = [
    (64, 16, 40, 5),     # d = 8: the span design, 5 heads a CTA
    (64, 16, 128, 4),    # d = 32: the head tile
    (64, 16, 80, 2),     # d = 40: padded to 48
    (64, 16, 72, 2),     # d = 36: the span design, 32-bit fragment loads
    (64, 16, 256, 2),    # d = 128
    (16, 32, 256, 2),    # d = 128 at S = 32: one warp a block
    (64, 16, 320, 16),   # d = 20: 32-bit fragment loads, 8 heads a CTA
    (64, 16, 297, 9),    # d = 33, odd C: 16-bit loads, unaligned heads
    (64, 16, 300, 3),    # d = 100, C % 8 == 4: two warps a head
    (64, 16, 272, 2),    # d = 136: three warps a head, ldmatrix
    (16, 16, 1280, 1),   # d = 1280: five blocks of four slices stream through
    (64, 8, 297, 9),     # S = 8
    (64, 24, 297, 9),    # S = 24: one fp32 lane a row, 8 idle
    (16, 32, 1280, 8),   # S = 32, d = 160
    (64, 16, 60, 3),     # the num_head_channels=20 U-Net's widths: 60, 120, 160
    (64, 16, 7, 7),      # d = 1 (bf16 only: in fp32 its one-element rows measure
                         # the cancellation in outputs near 0, not the kernel)
    (64, 8, 2048, 1),    # d = 2048 (C past the reference's 1280)
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c,heads,dtype", [
    shape + (dtype,) for shape in _WIDTHS for dtype in (torch.bfloat16, torch.float32)
    if dtype == torch.bfloat16 or shape[2] // shape[3] > 1])
def test_cuda_packed_attention_at_other_head_widths(n, s, c, heads, dtype):
    """K2 at the head widths of `_packed_tiny_kernel`'s route: every width,
    in bf16 (TOL) and fp32 (FP32_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    d = c // heads
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((n, s, c), generator=gen, device="cuda").to(dtype) for _ in range(3))
    tfa.reset_launch_counts()
    out = tfa.packed_attention(q, k, v, heads)
    key = (n, s, c, heads) + (("fp32",) if dtype == torch.float32 else ())
    assert tfa.packed_attention.launches == {key: 1}
    v_cut = v.clone()
    v_cut[:, -1] = 0
    faults = (tfa.packed_attention(q, k, v_cut, heads), tfa.packed_attention(q * 0.5, k, v, heads))
    with _full_fp32():
        ref = tfa.packed_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    tol = FP32_TOL if dtype == torch.float32 else TOL
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert max_row_rel_err(out, ref, d) <= tol
    for fault in faults:
        assert max_row_rel_err(fault, ref, d) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,s,c,heads", [(64, 16, 40, 5), (64, 16, 320, 5), (16, 24, 384, 6),
                                         (16, 32, 256, 2), (64, 8, 128, 4)])
def test_cuda_packed_attention_designs_agree(n, s, c, heads, dtype):
    """Where both K2 designs take the width (d % 8 == 0 up to 128), each is
    held to the plain version, whichever the library picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((n, s, c), generator=gen, device="cuda").to(dtype) for _ in range(3))
    with _full_fp32():
        ref = tfa.packed_attention_plain(q, k, v, heads)
    tol = FP32_TOL if dtype == torch.float32 else TOL
    for path in tfa.PACKED_PATHS:
        out = tfa._packed_call(q, k, v, heads, path=path)
        torch.cuda.synchronize()
        assert max_row_rel_err(out, ref, c // heads) <= tol, path


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
    p = torch.zeros(4, 16, 72, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfa.packed_attention(p, p, p, 2)
    p = torch.zeros(4, 16, 72, device="cuda", dtype=torch.bfloat16)  # d = 36
    with pytest.raises(RuntimeError, match="invalid argument"):  # the head tile's widths only
        tfa._packed_call(p, p, p, 2, path="head_tile")
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


# ---------------------------------------------------------------------------
# The norms (csrc/norms.cu) against their plain versions in the working type
# ---------------------------------------------------------------------------

# Largest |kernel - plain| over the output, relative to max |plain|: both
# compute the statistics in fp32 in other orders and round once to the working
# type, so they differ by at most one unit of that rounding (2^-8 in bf16,
# 2^-11 in fp16) and in fp32 by the statistics' rounding (~1e-6 at |mean| =
# 100 std). Planted faults (eps swapped, a group boundary one channel off,
# SiLU dropped) read far above it.
NORM_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}
NORM_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def norm_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _norm_inputs(shape, c, dtype, seed, scale=2.0, shift=0.5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.5 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def _groups(c):
    return 32 if c % 32 == 0 else math.gcd(c, 32)


# channels-last shapes of the U-Net's GroupNorms (per-frame [BT, H, W, C] and
# whole-row [B, T, H, W, C] slabs; group sizes 10, 20, 30, 40, 60, 80), then
# the gcd fallback: C = 20 (4 groups of 5) and 100 (4 of 25), not whole
# 16-byte vectors, and C = 48 (16 groups of 3, a vector across groups)
_GN_CASES = [(32, 40, 64, 320), (2, 16, 40, 64, 320), (32, 20, 32, 640), (32, 10, 16, 1280),
             (32, 20, 32, 960), (32, 10, 16, 1920), (2, 16, 10, 16, 1280), (32, 5, 8, 2560),
             (4, 6, 7, 20), (4, 6, 7, 100), (4, 6, 7, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("act,eps", [(None, 1e-6), ("silu", 1e-5), (None, 1e-5), ("silu", 1e-6)])
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", _GN_CASES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_group_norm_matches_plain(shape, dtype, act, eps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    c = shape[-1]
    x, w, b = _norm_inputs(shape, c, dtype, seed=len(shape) * 7 + c)
    tn.reset_launch_counts()
    out = tn.group_norm(x, w, b, _groups(c), eps, act)
    torch.cuda.synchronize()
    assert sum(tn.group_norm.launches.values()) == 1 and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert norm_err(out, tn.group_norm_plain(x, w, b, _groups(c), eps, act)) <= NORM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [(32, 40, 64, 320), (2, 16, 10, 16, 1280), (4, 6, 7, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_group_norm_faults_fail_the_tolerance(shape, dtype):
    """Inputs whose variance within a group (1e-5) is near eps and whose groups
    sit at different offsets: the kernel holds the tolerance, and with eps
    swapped, its groups shifted by one channel (input, weight and bias rolled
    by one channel, the output rolled back) or SiLU dropped it must fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    c = shape[-1]
    groups, eps = _groups(c), 1e-5
    x, w, b = _norm_inputs(shape, c, torch.float32, seed=3, scale=3.2e-3, shift=0.0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (x + torch.randn(groups, generator=gen, device="cuda").repeat_interleave(c // groups))
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    ref = tn.group_norm_plain(x, w, b, groups, eps, "silu")
    assert norm_err(tn.group_norm(x, w, b, groups, eps, "silu"), ref) <= NORM_TOL[dtype]
    roll = lambda t, k: torch.roll(t, k, dims=-1)
    faults = {
        "eps swapped": tn.group_norm(x, w, b, groups, 1e-6, "silu"),
        "group boundary": roll(tn.group_norm(roll(x, 1), roll(w, 1), roll(b, 1), groups, eps,
                                             "silu"), -1),
        "silu dropped": tn.group_norm(x, w, b, groups, eps, None),
    }
    for what, fault in faults.items():
        assert norm_err(fault, ref) > NORM_TOL[dtype], what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
def test_cuda_norms_on_awkward_inputs(dtype):
    """Non-contiguous inputs, |mean| = 100 std (the statistics' stability),
    and an affine in fp32 beside a bf16 or fp16 input."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _norm_inputs((32, 64, 40, 320), 320, dtype, seed=5)
    xt = x.transpose(1, 2)  # [32, 40, 64, 320], not contiguous
    assert not xt.is_contiguous()
    assert norm_err(tn.group_norm(xt, w, b, 32, 1e-6, "silu"),
                    tn.group_norm_plain(xt, w, b, 32, 1e-6, "silu")) <= NORM_TOL[dtype]
    rows = torch.randn(4096, 640, device="cuda").to(dtype)[:, :320]  # rows of stride 640
    assert norm_err(tn.layer_norm(rows, w, b, 1e-5),
                    tn.layer_norm_plain(rows, w, b, 1e-5)) <= NORM_TOL[dtype]
    far, _, _ = _norm_inputs((2, 16, 40, 64, 320), 320, dtype, seed=6, scale=1.0, shift=100.0)
    assert norm_err(tn.group_norm(far, w, b, 32, 1e-5, None),
                    tn.group_norm_plain(far, w, b, 32, 1e-5, None)) <= NORM_TOL[dtype]
    far_rows = far.reshape(-1, 320)[:8192]
    assert norm_err(tn.layer_norm(far_rows, w, b, 1e-5),
                    tn.layer_norm_plain(far_rows, w, b, 1e-5)) <= NORM_TOL[dtype]
    if dtype != torch.float32:
        w32, b32 = w.float() * 1.001, b.float()
        assert norm_err(tn.group_norm(x, w32, b32, 32, 1e-6, "silu"),
                        tn.group_norm_plain(x, w32, b32, 32, 1e-6, "silu")) <= NORM_TOL[dtype]
        flat = x.reshape(-1, 320)[:8192]
        assert norm_err(tn.layer_norm(flat, w32, b32, 1e-5),
                        tn.layer_norm_plain(flat, w32, b32, 1e-5)) <= NORM_TOL[dtype]


# [R, C] of the LayerNorms: the U-Net's transformers (320, 640, 1280, the init
# attention's 512), the text tower (77 tokens, 1024), the ViT-H/14 (257
# tokens, 1280); rows that are not whole vectors (C = 100) or too wide for a
# lane's registers (C = 4096)
_LN_CASES = [(8192, 320), (4096, 640), (2048, 1280), (1024, 512), (154, 1024), (514, 1280),
             (300, 100), (64, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("r,c", _LN_CASES)
def test_cuda_layer_norm_matches_plain(r, c, dtype, eps):
    """The kernel within NORM_TOL of the plain version; with eps swapped
    (rows whose variance is near eps) or the weight and bias swapped, beyond
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _norm_inputs((r, c), c, dtype, seed=r + c)
    tn.reset_launch_counts()
    out = tn.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    assert tn.layer_norm.launches == {(r, c) + tn._DTYPE_TAGS[dtype]: 1}
    assert torch.isfinite(out.float()).all() and out.dtype == dtype
    assert norm_err(out, tn.layer_norm_plain(x, w, b, eps)) <= NORM_TOL[dtype]
    assert norm_err(tn.layer_norm(x, b, w, eps), tn.layer_norm_plain(x, w, b, eps)) > NORM_TOL[dtype]
    small = (x.float() * 1.6e-3).to(dtype)
    other = 1e-6 if eps == 1e-5 else 1e-5
    assert norm_err(tn.layer_norm(small, w, b, other),
                    tn.layer_norm_plain(small, w, b, eps)) > NORM_TOL[dtype]


@pytest.mark.cuda
def test_cuda_layer_norm_unaligned_rows():
    """An input 2 bytes off a 16-byte boundary takes one value a lane (the
    any-row kernel) and still matches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _norm_inputs((1, 1 + 256 * 320), 320, torch.bfloat16, seed=8)
    x = x.reshape(-1)[1:].view(256, 320)
    assert x.data_ptr() % 16 and tn.layer_norm_vectors(320, tn._vector(2, 320, x.data_ptr())) == 0
    assert norm_err(tn.layer_norm(x, w, b, 1e-5), tn.layer_norm_plain(x, w, b, 1e-5)) <= 1e-2
    g = tn.group_norm(x.reshape(4, 64, 320), w, b, 32, 1e-6, "silu")
    assert norm_err(g, tn.group_norm_plain(x.reshape(4, 64, 320), w, b, 32, 1e-6, "silu")) <= 1e-2


@pytest.mark.cuda
def test_cuda_norm_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x = torch.zeros(2, 8, 64, device="cuda", dtype=torch.float64)
    w = torch.ones(64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        tn.group_norm(x, w, w, 32, 1e-5)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        tn.layer_norm(x, w, w, 1e-5)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        tn.layer_norm(xb, wb.cpu(), wb, 1e-5)
    with pytest.raises(ValueError, match="groups"):
        tn.group_norm(xb, wb, wb, 5, 1e-5)


@pytest.mark.cuda
def test_cuda_unet_forward_launches_one_kernel_a_norm(monkeypatch):
    """A full-width U-Net forward (the shipped config, bf16, 1 row of 16
    frames at a 16 x 16 latent) on the card: one launch of each norm module,
    166 GroupNorms and 99 LayerNorms, and no call of the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig

    def refuse(*args, **kwargs):
        raise AssertionError("a plain norm ran on the card")

    monkeypatch.setattr(tn, "group_norm_plain", refuse)
    monkeypatch.setattr(tn, "layer_norm_plain", refuse)
    with torch.device("cuda"):
        model = UNet3D(UNetConfig()).to(torch.bfloat16).eval()
    gns = sum(isinstance(m, tn.GroupNorm32) for m in model.modules())
    lns = sum(isinstance(m, tn.LayerNorm32) for m in model.modules())
    assert (gns, lns) == (166, 99)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1, 16, 16, 16, 4), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((1, 77, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    ts = torch.full((1, 16), 500, device="cuda", dtype=torch.long)
    tn.reset_launch_counts()
    with torch.inference_mode():
        out = model(x, ts, ctx, fps=16)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert sum(tn.group_norm.launches.values()) == gns
    assert sum(tn.layer_norm.launches.values()) == lns


# ---------------------------------------------------------------------------
# The feed-forward's GEGLU (csrc/geglu.cu) against its plain version
# ---------------------------------------------------------------------------

# Largest |kernel - plain| over the output, relative to max |plain| (as
# NORM_TOL): the kernel rounds the product once, the plain version the gelu and
# then the product, at most one and a half units of the working type apart
# (2^-8 in bf16, 2^-11 in fp16); in fp32 both compute one expression, a few
# units of 2^-24 apart. Planted faults read far above it.
GEGLU_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _ff_shapes(rows, lat, f=16):
    """[R, F] of every feed-forward of the shipped U-Net at `rows` rows of f
    frames on an h x w latent: the spatial and temporal transformers of each
    level (the same tokens), the middle block and the init attention (512
    channels)."""
    shapes = {(rows * f * (lat[0] >> lvl) * (lat[1] >> lvl), 4 * ch)
              for lvl, ch in enumerate((320, 640, 1280))}
    shapes.add((rows * f * (lat[0] >> 3) * (lat[1] >> 3), 5120))
    shapes.add((rows * f * lat[0] * lat[1], 2048))
    return shapes


# the stream (16 rows, 40 x 64), the clip (2 rows, 40 x 64), DynamiCrafter
# 1024 (2 rows, 72 x 128); then the scalar path: F not whole vectors (F = 100)
_GEGLU_CASES = sorted(_ff_shapes(16, (40, 64)) | _ff_shapes(2, (40, 64))
                      | _ff_shapes(2, (72, 128))) + [(3000, 100)]


def geglu_err(out, ref, chunk=1 << 16):
    """max |out - ref| / max |ref| over rows, `chunk` rows at a time."""
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    diff = top = 0.0
    for i in range(0, ref.shape[0], chunk):
        o, r = out[i:i + chunk].float(), ref[i:i + chunk].float()
        diff, top = max(diff, (o - r).abs().max().item()), max(top, r.abs().max().item())
    return diff / top


def _geglu_input(r, f, dtype, seed, offset=0):
    """h [r, 2f] of N(0, 2.5^2) values, `offset` values past a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.empty(r * 2 * f + offset, device="cuda", dtype=dtype)
    return h[offset:].normal_(0.0, 2.5, generator=gen).view(r, 2 * f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("r,f", _GEGLU_CASES, ids=lambda v: str(v))
def test_cuda_geglu_matches_plain(r, f, dtype):
    """Every feed-forward shape of the three cells in each type: the kernel
    within GEGLU_TOL of `geglu_plain`, one launch tallied under its shape;
    the same input one value off a 16-byte boundary (one value a thread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    h = _geglu_input(r, f, dtype, seed=r + f)
    tg.reset_launch_counts()
    with torch.inference_mode():
        out = tg.geglu(h)
        torch.cuda.synchronize()
        assert tg.geglu.launches == {(r, f) + tn._DTYPE_TAGS[dtype]: 1}
        assert out.shape == (r, f) and out.dtype == dtype
        assert torch.isfinite(out).all()
        assert geglu_err(out, tg.geglu_plain(h)) <= GEGLU_TOL[dtype]
        if r * f <= 1 << 27:
            odd = _geglu_input(r, f, dtype, seed=r + f, offset=1)
            assert tn._vector(odd.element_size(), f, odd.data_ptr()) == 1
            assert geglu_err(tg.geglu(odd), tg.geglu_plain(odd)) <= GEGLU_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("r,f", [(5120, 1280), (2560, 2048), (1280, 2560), (640, 5120),
                                 (300, 100)], ids=lambda v: str(v))
def test_cuda_geglu_faults_fail_the_tolerance(r, f, dtype):
    """x and the gate swapped, and the gate read one column on (both planted
    through the input), must fail GEGLU_TOL; so must the erf gelu in place of
    the tanh form, on gates in the tail (-4 to -2.5) where the two part by
    ~10 % of the gelu (elsewhere by less than a bf16 unit), beside the
    kernel, which holds it there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    h = _geglu_input(r, f, dtype, seed=7 * f)
    x, gate = h.chunk(2, dim=-1)
    ref = tg.geglu_plain(h)
    with torch.inference_mode():
        assert geglu_err(tg.geglu(h), ref) <= GEGLU_TOL[dtype]
        faults = {"x and gate swapped": tg.geglu(torch.cat([gate, x], dim=-1)),
                  "gate one column on": tg.geglu(torch.cat([x, gate.roll(-1, dims=-1)], dim=-1))}
        gen = torch.Generator(device="cuda").manual_seed(f)
        tail = torch.cat([torch.rand((r, f), generator=gen, device="cuda") + 0.5,
                          torch.rand((r, f), generator=gen, device="cuda") * -1.5 - 2.5],
                         dim=-1).to(dtype)
        tail_ref = tg.geglu_plain(tail)
        assert geglu_err(tg.geglu(tail), tail_ref) <= GEGLU_TOL[dtype]
        tx, tgate = tail.float().chunk(2, dim=-1)
        erf = (tx * torch.nn.functional.gelu(tgate)).to(dtype)
        assert geglu_err(erf, tail_ref) > GEGLU_TOL[dtype], "erf gelu"
        for what, fault in faults.items():
            assert geglu_err(fault, ref) > GEGLU_TOL[dtype], what


@pytest.mark.cuda
def test_cuda_geglu_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        tg.geglu(torch.zeros(4, 16, device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError, match="2F"):
        tg.geglu(torch.zeros(4, 15, device="cuda", dtype=torch.bfloat16))
    strided = torch.randn(64, 64, device="cuda").to(torch.bfloat16)[:, ::2]  # not contiguous
    assert geglu_err(tg.geglu(strided), tg.geglu_plain(strided)) <= GEGLU_TOL[torch.bfloat16]


# (in_channels, image attention, rows, latent, context tokens) of each cell's
# U-Net call: the stream, the i2v clip (77 text + 16 image tokens), and
# DynamiCrafter 1024 (77 + 16 per frame)
_UNET_CELLS = {"vc2-fifo-davis": (4, False, 16, (40, 64), 154),
               "vc1-i2v-clip": (4, True, 2, (40, 64), 93),
               "dc1024-i2v-clip": (8, True, 2, (72, 128), 77 + 16 * 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(_UNET_CELLS))
def test_cuda_unet_forward_launches_one_geglu_a_feed_forward(cell, monkeypatch):
    """One full-width bf16 U-Net call at each cell's shape: 33 feed-forwards,
    one GEGLU launch each and no call of `geglu_plain`; the output within
    5e-2 (relative to its largest value) of the same call with the plain
    chain in the kernel's place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from moca_tpu_torch.models import unet3d as tunet

    cin, image, rows, (hh, ww), ctx_len = _UNET_CELLS[cell]
    with torch.device("cuda"):
        model = tunet.UNet3D(tunet.UNetConfig(in_channels=cin, use_image_attention=image))
        model = model.to(torch.bfloat16).eval()
    ffs = sum(isinstance(m, tunet.GEGLU) for m in model.modules())
    assert ffs == 33
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((rows, 16, hh, ww, cin), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((rows, ctx_len, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    ts = torch.full((rows, 16), 500, device="cuda", dtype=torch.long)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain GEGLU ran on the card")

    with torch.inference_mode():
        with monkeypatch.context() as m:
            m.setattr(tg, "geglu_plain", refuse)
            tg.reset_launch_counts()
            out = model(x, ts, ctx, fps=16)
            torch.cuda.synchronize()
            assert sum(tg.geglu.launches.values()) == ffs
        monkeypatch.setattr(tunet, "geglu", tg.geglu_plain)
        plain = model(x, ts, ctx, fps=16)
    assert torch.isfinite(out.float()).all()
    rel = ((out.float() - plain.float()).abs().max() / plain.float().abs().max()).item()
    assert rel <= 5e-2, rel
