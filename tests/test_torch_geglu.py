"""The feed-forward's GEGLU (moca_tpu_torch/ops/geglu.py) on the CPU.

`geglu_plain` against the reference's `GEGLU` (moca_tpu/models/unet3d.py:
410-420) with an identity projection, so that both see the same [.., 2F]
input; the port's `GEGLU` module taking the plain path on CPU tensors (no
launch); and the kernel's launch plan (csrc/geglu.cu), modelled here: the
vector width, the grid, and the grid-stride walk reaching every output vector
once, with x and the gate read where slicing finds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moca_tpu.models import unet3d as junet
from moca_tpu_torch.models import unet3d as tunet
from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import geglu as tg


def _jax_geglu(h: np.ndarray, dtype):
    """The reference's module on h [..., 2F], its projection the identity."""
    two_f = h.shape[-1]
    mod = junet.GEGLU(dim_out=two_f // 2, dtype=dtype, param_dtype=dtype)
    params = {"params": {"proj": {"kernel": jnp.eye(two_f, dtype=dtype),
                                  "bias": jnp.zeros((two_f,), dtype)}}}
    return np.asarray(mod.apply(params, jnp.asarray(h, dtype)).astype(jnp.float32))


# bf16: the reference rounds after each of the gelu's operations, the plain
# version once after the gelu; both round the product. A few bf16 units.
_JAX_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 16), (2, 5, 40), (3, 4, 2, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_geglu_plain_matches_jax_geglu(shape, dtype):
    gen = torch.Generator().manual_seed(sum(shape))
    h = (torch.randn(shape, generator=gen) * 2.5).to(dtype)
    out = tg.geglu_plain(h)
    assert out.shape == shape[:-1] + (shape[-1] // 2,) and out.dtype == dtype
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_geglu(h.float().numpy(), jdtype)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= _JAX_TOL[dtype], err
    # the erf gelu is not the reference's
    x, gate = h.float().chunk(2, dim=-1)
    erf = (x * torch.nn.functional.gelu(gate)).numpy()
    if dtype == torch.float32:
        assert np.abs(erf - ref).max() / np.abs(ref).max() > 20 * _JAX_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_geglu_module_on_cpu_takes_the_plain_path(dtype):
    """The U-Net's GEGLU on CPU tensors: the plain chain on its projection,
    bit for bit, no launch tallied; its parameters keep the checkpoint's names."""
    torch.manual_seed(0)
    mod = tunet.GEGLU(32, 48).to(dtype)
    assert [k for k, _ in mod.named_parameters()] == ["proj.weight", "proj.bias"]
    x = torch.randn(3, 10, 32).to(dtype)
    cuda_libs.reset_launch_counts()
    with torch.inference_mode():
        out = mod(x)
        want = tg.geglu_plain(mod.proj(x))
    assert tg.geglu.launches == {}
    assert out.shape == (3, 10, 48) and torch.equal(out, want)
    ff = tunet.FeedForward(32)
    assert isinstance(ff.net[0], tunet.GEGLU)
    with torch.inference_mode():
        ff(torch.randn(2, 5, 32))
    assert tg.geglu.launches == {}


def _walk(r, f, vec, threads, blocks):
    """The kernel's grid-stride walk (`geglu_rows`): for each thread, the
    vectors it takes, two in flight and then the one left; each as (y
    offset, x offset, gate offset) in elements."""
    fv, stride = f // vec, threads * blocks
    nvec, seen = r * fv, []
    for t in range(stride):
        v = t
        while v + stride < nvec:
            seen += [v, v + stride]
            v += 2 * stride
        if v < nvec:
            seen.append(v)
    return [(v * vec, (v + v // fv * fv) * vec, (v + v // fv * fv) * vec + fv * vec)
            for v in seen]


@pytest.mark.parametrize("r,f,vec", [(3, 40, 8), (3, 40, 4), (3, 40, 1), (5, 24, 8),
                                     (5, 24, 4), (5, 24, 1), (2, 13, 1), (64, 8, 8), (64, 8, 4),
                                     (1, 1, 1)])
def test_geglu_walk_reaches_every_vector_once(r, f, vec):
    """Small shapes and small grids (so that threads take several vectors):
    every output vector once, x and the gate where slicing finds them."""
    h = np.arange(r * 2 * f).reshape(r, 2 * f)
    x, gate, y = h[:, :f].reshape(-1), h[:, f:].reshape(-1), np.arange(r * f)
    for threads, blocks in ((1, 1), (3, 2), (32, 1), tg.geglu_plan(r, f, vec)):
        walked = _walk(r, f, vec, threads, blocks)
        assert sorted(o for o, _, _ in walked) == list(range(0, r * f, vec))
        for oy, ox, og in walked:
            assert (h.reshape(-1)[ox:ox + vec] == x[oy:oy + vec]).all()
            assert (h.reshape(-1)[og:og + vec] == gate[oy:oy + vec]).all()
            assert (y[oy:oy + vec] == np.arange(oy, oy + vec)).all()


# rows of the U-Net's feed-forwards: the stream's level 0 (16 rows x 16
# frames x 40 x 64 tokens), the clip's mid block (2 x 16 x 5 x 8), the init
# attention's 16 frames a pixel; F: 4 x the widths 320, 640, 1280 and the
# init attention's 512
@pytest.mark.parametrize("r,f", [(655360, 1280), (40960, 2560), (2560, 5120), (1280, 5120),
                                 (40960, 2048), (81920, 1280)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_geglu_plan_at_the_unets_widths(r, f, itemsize):
    """Every F of the U-Net is whole 16-byte vectors: VEC = 16 / itemsize on
    aligned pointers; one value a thread where a pointer is off by one
    value; the grid gives each thread two vectors, up to the card's blocks."""
    vec = cuda_libs.vector(itemsize, f, 0, 4096)
    assert vec == 16 // itemsize
    assert cuda_libs.vector(itemsize, f, itemsize, 4096) == 1
    for v in (vec, 1):
        threads, blocks = tg.geglu_plan(r, f, v)
        vectors = r * f // v
        assert threads == tg.GEGLU_THREADS and 1 <= blocks <= tg.GEGLU_BLOCKS
        want = -(-vectors // (threads * tg.GEGLU_IN_FLIGHT))
        assert blocks == min(want, tg.GEGLU_BLOCKS)
    # the stream's level 0 fills the card and walks with the grid stride
    if r * f >= tg.GEGLU_BLOCKS * tg.GEGLU_THREADS * tg.GEGLU_IN_FLIGHT * vec:
        assert tg.geglu_plan(r, f, vec)[1] == tg.GEGLU_BLOCKS


def test_geglu_plan_off_the_vector():
    """F not whole vectors (F % 8 != 0 in bf16, % 4 in fp32) takes one value a
    thread; the plan refuses a width the vectors do not divide."""
    for itemsize, f in ((2, 100), (2, 1284), (4, 6), (2, 7)):
        assert cuda_libs.vector(itemsize, f, 0, 0) == 1
        threads, blocks = tg.geglu_plan(3, f, 1)
        assert blocks == -(-(3 * f) // (threads * tg.GEGLU_IN_FLIGHT))
    with pytest.raises(ValueError, match="whole vectors"):
        tg.geglu_plan(3, 100, 8)


def test_geglu_stays_out_of_the_attention_tally():
    """The benchmark's `attn_roofline` reads K1-K4's tallies alone."""
    from moca_tpu_torch.ops import flash_attention as tfa

    assert tg.geglu not in tfa.KERNELS and tg.geglu in cuda_libs.TALLIED
    geglu = cuda_libs.LIBRARIES["geglu"]
    assert geglu.sources == ("geglu.cu",) and "moca_geglu" in geglu.entries
