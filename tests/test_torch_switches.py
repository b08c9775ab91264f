"""The kernels and routes behind the reference's attention switches, held to
the JAX package on the CPU.

  * K3 (`fused_qkv_attention`, MOCA_TPU_FA_FUSED_QKV), K4
    (`flash_attention_onepass`, MOCA_TPU_FA_ONEPASS) and K2 at head widths
    other than 64: their plain versions against `_fused_qkv_kernel`,
    `_fa_onepass_kernel` and `_packed_tiny_kernel` run with `interpret=True`;
  * the port's routing against the reference's gates (`use_fused_qkv`,
    `_choose_flash_blocks`);
  * the port's CrossAttention with the fused branch forced against the JAX
    CrossAttention.

Tolerances. fp32 inputs: both sides compute the same function and differ only
in summation order, so 1e-5 of the output's magnitude. bf16 inputs (K3): both
sides round at the same points, but an fp32 sum taken in another order can
land a value on the other side of a bf16 rounding boundary and move an output
by one bf16 step, 2^-7 of the output's magnitude, the limit used there (the
same chain without the bf16 roundings misses by ~1e-2 of it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import moca_tpu.ops.attention as jatt
import moca_tpu.ops.flash_attention as jfa
from moca_tpu import xla_opts
from moca_tpu.models import unet3d as junet
from moca_tpu_torch.models import unet3d as tunet
from moca_tpu_torch.models.convert import _attn as attn_from_jax
from moca_tpu_torch.ops import attention as tatt
from moca_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, rel):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(port, np.float32), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


# ---------------------------------------------------------------------------
# Plain versions against the Pallas bodies (interpret mode)
# ---------------------------------------------------------------------------

def _fused_qkv_interpret(x, wq, wk, wv, wo, bo, heads, nb):
    """`fused_qkv_attention`'s pallas_call (flash_attention.py:524-543) with
    interpret=True; weights in the JAX [in, out] layout."""
    n, s, c = x.shape
    d = c // heads
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    return pl.pallas_call(
        functools.partial(jfa._fused_qkv_kernel, scale=d**-0.5, heads=heads, d=d),
        out_shape=jax.ShapeDtypeStruct((n, s, c), x.dtype),
        grid=(n // nb,),
        in_specs=[pl.BlockSpec((nb, s, c), lambda i: (i, 0, 0)),
                  full((c, c)), full((c, c)), full((c, c)), full((c, c)), full((1, c))],
        out_specs=pl.BlockSpec((nb, s, c), lambda i: (i, 0, 0)),
        interpret=True,
    )(x, wq, wk, wv, wo, bo.reshape(1, c))


@pytest.mark.parametrize("n,s,heads,d,dtype,rel", [
    (4, 8, 5, 8, "float32", ATOL),     # C = 40: the exact per-head slices branch
    (2, 8, 4, 64, "float32", ATOL),    # C = 256: the 128-lane, 2-head-mask branch
    (4, 16, 5, 8, "bfloat16", 2**-7),  # the rounding points, in bf16
])
def test_fused_qkv_plain_matches_fused_qkv_kernel_interpret(n, s, heads, d, dtype, rel):
    """K3's plain version vs `_fused_qkv_kernel`: x [N, S, C], four [C, C]
    weights (transposed for the JAX [in, out] layout) and a bias."""
    c = heads * d
    x = _rand((n, s, c), 70)
    ws = [_rand((c, c), 71 + i, c**-0.5) for i in range(4)]  # [out, in], as nn.Linear
    bo = _rand((c,), 75, 0.1)
    jdt = jnp.dtype(dtype)
    ref = _fused_qkv_interpret(jnp.asarray(x, jdt), *(jnp.asarray(w.T, jdt) for w in ws),
                               jnp.asarray(bo, jdt), heads, nb=2)
    tdt = getattr(torch, dtype)
    port = tfa.fused_qkv_attention(_t(x).to(tdt), *(_t(w).to(tdt) for w in ws),
                                   _t(bo).to(tdt), heads)
    assert port.dtype == tdt and port.shape == (n, s, c)
    _close(port.float().numpy(), np.asarray(ref, np.float32), rel)


@pytest.mark.parametrize("nomax", [False, True])
def test_onepass_plain_matches_fa_onepass_kernel_interpret(nomax):
    """K4's plain version vs `_fa_onepass_kernel` (the pallas_call of
    flash_attention.py:713-732 with interpret=True): two q blocks, each over
    the whole kv, with and without the max shift."""
    b, s, h, d = 1, 16, 2, 8
    bq = 8
    q, k, v = (_rand((b, s, h, d), 80 + i) for i in range(3))
    out = pl.pallas_call(
        functools.partial(jfa._fa_onepass_kernel, scale=d**-0.5, nomax=nomax),
        out_shape=jax.ShapeDtypeStruct((b, h, s, d), jnp.float32),
        grid=(b, h, s // bq),
        in_specs=[
            pl.BlockSpec((1, 1, bq, d), lambda b_, h_, i: (b_, h_, i, 0)),
            pl.BlockSpec((1, 1, s, d), lambda b_, h_, i: (b_, h_, 0, 0)),
            pl.BlockSpec((1, 1, s, d), lambda b_, h_, i: (b_, h_, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, bq, d), lambda b_, h_, i: (b_, h_, i, 0)),
        interpret=True,
    )(*(jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)))
    port = tfa.flash_attention_onepass(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(port, np.asarray(out).transpose(0, 2, 1, 3), atol=ATOL)


@pytest.mark.parametrize("nomax", [False, True])
@pytest.mark.parametrize("qmask", [True, False])
def test_packed_plain_matches_packed_tiny_kernel_interpret(qmask, nomax):
    """K2's plain version vs `_packed_tiny_kernel` at d = 8 (masked
    full-width heads; the kernel the reference runs at head widths != 64)."""
    nb, s, heads, d = 4, 8, 3, 8
    c = heads * d
    q, k, v = (_rand((nb, s, c), 90 + i) for i in range(3))
    out = pl.pallas_call(
        functools.partial(jfa._packed_tiny_kernel, scale=d**-0.5, heads=heads, d=d,
                          qmask=qmask, nomax=nomax),
        out_shape=jax.ShapeDtypeStruct((nb, s, c), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((nb, s, c), lambda i: (i, 0, 0))] * 3,
        out_specs=pl.BlockSpec((nb, s, c), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port = tfa.packed_attention(_t(q), _t(k), _t(v), heads).numpy()
    np.testing.assert_allclose(port, np.asarray(out), atol=ATOL)


# ---------------------------------------------------------------------------
# Routing against the reference's gates
# ---------------------------------------------------------------------------

class _OnCuda:
    """Stands for a CUDA tensor: the gate reads only `is_cuda`."""
    is_cuda = True


@pytest.mark.parametrize("sel,s,c,heads,d", [
    ("1", 16, 320, 5, 64), ("1", 16, 512, 8, 64), ("1", 16, 640, 10, 64),
    ("1", 16, 1280, 20, 64), ("1", 16, 320, 10, 32),    # d != 64
    ("1", 16, 640, 5, 64),                              # inner != C
    ("1", 77, 320, 5, 64), ("1", 12, 320, 5, 64),       # not tiny-S / S % 8
    ("1", 8, 640, 10, 64), ("1", 24, 384, 6, 64), ("1", 32, 1280, 20, 64),
    ("1", 16, 1536, 24, 64),                            # > 1280
    ("1", 16, 192, 3, 64), ("1", 16, 768, 12, 64),      # C % 128 != 0 / == 0
    ("320,512", 16, 320, 5, 64), ("320,512", 16, 512, 8, 64),
    ("320,512", 16, 640, 10, 64),                       # not in the allowlist
    (" 640 , 1280", 16, 1280, 20, 64), ("0", 16, 320, 5, 64), ("", 16, 320, 5, 64),
])
def test_use_fused_qkv_matches_the_reference_gate(monkeypatch, sel, s, c, heads, d):
    """The cases of tests/test_flash_attention.py:73-108 and a few more, with
    the reference's backend stubbed to "tpu" and its big-VMEM option on (the
    port drops that TPU compile-option gate)."""
    monkeypatch.setenv("MOCA_TPU_FA_FUSED_QKV", sel)
    monkeypatch.setattr(jatt.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(xla_opts, "big_vmem_available", lambda: True)
    ref = jatt.use_fused_qkv(s, c, heads, d)
    assert tatt.use_fused_qkv(_OnCuda(), s, c, heads, d) == ref
    assert not tatt.use_fused_qkv(torch.zeros(1), s, c, heads, d)  # CPU tensors: plain path


@pytest.mark.parametrize("sq,sk", [
    (2560, 2560), (2560, 154), (640, 154), (160, 154), (2560, 77), (640, 640),
    (160, 160), (5120, 5120), (4096, 4096), (3000, 3000), (8192, 128), (1280, 1280),
    (2600, 2600), (640, 10240),
])
def test_onepass_full_kv_matches_choose_flash_blocks(sq, sk):
    assert tatt.onepass_full_kv(sq, sk) == (jfa._choose_flash_blocks(sq, sk, True)[1] == sk)


def test_onepass_routes_like_the_reference(monkeypatch):
    """With MOCA_TPU_FA_ONEPASS=1 the reference's one-pass kernel runs at the
    five flash shapes of the FIFO path outside the small-S path; off, none."""
    monkeypatch.setenv("MOCA_TPU_FA_ONEPASS", "1")
    for sq, sk in ((2560, 2560), (2560, 154), (640, 154), (160, 154)):
        assert tatt.use_onepass(sq, sk)
    for s in (640, 160, 256):  # `_small_attention`: K1
        assert not tatt.use_onepass(s, s)
    assert not tatt.use_onepass(5120, 5120)  # blocked kv
    monkeypatch.setenv("MOCA_TPU_FA_ONEPASS", "0")
    assert not tatt.use_onepass(2560, 2560)


# ---------------------------------------------------------------------------
# The U-Net's fused branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s,heads,d", [(3, 16, 2, 64), (2, 8, 5, 8)])
def test_cross_attention_fused_branch_matches_jax(monkeypatch, n, s, heads, d):
    """The port's CrossAttention with the fused branch forced (it runs K3's
    plain version on the CPU) against the JAX CrossAttention (XLA path) with
    the same weights; fp32, tolerance 1e-5 of the output's magnitude."""
    c = heads * d
    jmod = junet.CrossAttention(heads=heads, dim_head=d)
    x = _rand((n, s, c), 100)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + _rand(a.shape, a.size, 0.05), params)
    ref = jmod.apply(params, jnp.asarray(x))

    sd = {}
    attn_from_jax(sd, "m", params["params"])
    port = tunet.CrossAttention(c, heads, d).eval()
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return tatt.fused_qkv_attention(*args)

    monkeypatch.setattr(tunet, "use_fused_qkv", lambda *a: True)
    monkeypatch.setattr(tunet, "fused_qkv_attention", spy)
    with torch.no_grad():
        out = port(_t(x))
    assert calls == [(n, s, c)]
    _close(out.numpy(), ref, ATOL)
