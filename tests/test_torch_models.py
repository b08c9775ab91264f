"""The port's models (moca_tpu_torch.models) against the JAX package's.

Weights are made by the JAX modules' own init (zero-initialised last layers
randomised, tests/test_models.randomize_zero_params) and carried into the
port with `*_from_jax`; inputs come from numpy seeds. Everything runs in
fp32 on the CPU, where both sides compute the same function and differ only
in summation order: tolerances are stated per test relative to the output's
magnitude.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import randomize_zero_params
from test_torch_sampling import one_torch_thread  # noqa: F401  (fixture)

from moca_tpu.models import clip_text as jclip
from moca_tpu.models import unet3d as junet
from moca_tpu.models import vae as jvae
from moca_tpu.models.convert import convert_unet
from moca_tpu.models.tokenizer import HashTokenizer
from moca_tpu.ops.norms import GroupNorm32 as JGroupNorm32
from moca_tpu_torch.models import clip_text as tclip
from moca_tpu_torch.models import unet3d as tunet
from moca_tpu_torch.models import vae as tvae
from moca_tpu_torch.models.convert import clip_from_jax, unet_from_jax, vae_from_jax
from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import norms as tnorms
from moca_tpu_torch.ops.norms import GroupNorm32, LayerNorm32

# GroupNorm(32)-compatible widths, two levels with attention at both,
# addition_attention and fps_cond on (tests/test_oracle_unet.py:31-40)
UNET = dict(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_head_channels=32, context_dim=64,
            temporal_length=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def unet_pair():
    jcfg, tcfg = junet.UNetConfig(**UNET), tunet.UNetConfig(**UNET)
    init = jax.jit(functools.partial(junet.UNet3D(jcfg).init, fps=16))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8, 4)),
                  jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 7, 64)))
    params = _np_tree(randomize_zero_params(params))
    model = tunet.UNet3D(tcfg).eval()
    model.load_state_dict(unet_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model


def test_unet_matches_jax(unet_pair):
    """Per-frame timesteps, fps_cond and addition_attention; tolerance 1e-4
    of the output's magnitude."""
    jcfg, _, params, model = unet_pair
    x = _rand((2, 4, 8, 8, 4), 1)
    ts = np.random.default_rng(2).integers(0, 1000, (2, 4)).astype(np.int32)
    ctx = _rand((2, 7, 64), 3)
    apply = jax.jit(functools.partial(junet.UNet3D(jcfg).apply, fps=10))
    ref = apply(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(ts).long(),
                    torch.from_numpy(ctx), fps=10)
    assert out.shape == (2, 4, 8, 8, 4)
    _close(out.numpy(), ref, 1e-4)


def test_unet_state_dict_round_trip(unet_pair):
    """port state_dict -> moca_tpu convert_unet -> the original JAX tree."""
    jcfg, _, params, model = unet_pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_unet(sd, jcfg, prefix="")
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_unet_upstream_key_names(unet_pair):
    keys = set(unet_pair[3].state_dict())
    for key in ("input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight",
                "input_blocks.1.0.temopral_conv.conv1.2.weight",
                "input_blocks.1.0.temopral_conv.conv4.3.weight",
                "init_attn.0.proj_in.weight", "middle_block.1.proj_out.bias",
                "output_blocks.1.3.conv.weight", "input_blocks.2.0.op.weight",
                "fps_embedding.2.weight", "out.2.weight"):
        assert key in keys, key
    assert unet_pair[3].state_dict()["init_attn.0.proj_in.weight"].ndim == 3  # Conv1d


@pytest.mark.parametrize("attn_resolutions", [(), (8,)])
def test_vae_decode_matches_jax(attn_resolutions):
    """Decoder + post_quant_conv (mid attention, optional level attention);
    tolerance 1e-4 of the output's magnitude."""
    kw = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=32,
              attn_resolutions=attn_resolutions)
    jcfg, tcfg = jvae.VAEConfig(**kw), tvae.VAEConfig(**kw)
    jmodel = jvae.AutoencoderKL(jcfg)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    params = _np_tree(randomize_zero_params(params))
    z = _rand((2, 4, 4, 4), 5)
    ref = jax.jit(functools.partial(jmodel.apply, method=jmodel.decode))(params, jnp.asarray(z))
    model = tvae.AutoencoderKL(tcfg).eval()
    model.load_state_dict(vae_from_jax(params, tcfg), strict=True)
    with torch.no_grad():
        out = model.decode(torch.from_numpy(z))
    assert out.shape == (2, 32, 32, 3)
    _close(out.numpy(), ref, 1e-4)


def test_clip_text_matches_jax():
    """Penultimate-layer features with the causal mask; tolerance 1e-4."""
    kw = dict(width=64, heads=4, layers=3)
    jcfg, tcfg = jclip.CLIPTextConfig(**kw), tclip.CLIPTextConfig(**kw)
    tokens = HashTokenizer()(["a cat surfing", "a dog"])
    jmodel = jclip.CLIPTextEncoder(jcfg)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(6), jnp.asarray(tokens)))
    ref = jmodel.apply(params, jnp.asarray(tokens))
    model = tclip.CLIPTextEncoder(tcfg).eval()
    model.load_state_dict(clip_from_jax(params, tcfg), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.shape == (2, 77, 64)
    _close(out.numpy(), ref, 1e-4)


@pytest.mark.parametrize("channels,act", [(64, None), (20, "silu")])
def test_groupnorm32_matches_jax(channels, act):
    """fp32 statistics, the gcd group fallback (C=20 -> 4 groups) and the
    fused SiLU; tolerance 1e-5."""
    x = _rand((2, 3, 5, channels), 7) * 3 + 1
    norm = JGroupNorm32(32, act=act)
    params = _np_tree(randomize_zero_params(norm.init(jax.random.PRNGKey(8), x), scale=0.5))
    params = jax.tree.map(lambda a: a + 1.0, params)  # non-trivial scale and bias
    ref = norm.apply(params, jnp.asarray(x))
    port = GroupNorm32(32, channels, act=act)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["params"]["GroupNorm_0"]["scale"]))
        port.bias.copy_(torch.from_numpy(params["params"]["GroupNorm_0"]["bias"]))
        out = port(torch.from_numpy(x))
    _close(out.numpy(), ref, 1e-5)


def test_layernorm32_keeps_input_dtype():
    x = torch.from_numpy(_rand((2, 5, 16), 9)).to(torch.bfloat16)
    out = LayerNorm32(16)(x)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (16,))
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


def _affine(c, seed):
    w, b = _rand((2, c), seed)
    return torch.from_numpy(1 + 0.3 * w), torch.from_numpy(0.5 * b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels,act,eps", [(64, None, 1e-6), (20, "silu", 1e-5)])
def test_group_norm_plain_keeps_its_results(channels, act, eps, dtype):
    """`group_norm_plain` is GroupNorm32's former body, bit for bit, and the
    module on CPU tensors takes it and launches nothing."""
    x = torch.from_numpy(_rand((2, 3, 5, channels), 11) * 3 + 1).to(dtype)
    w, b = _affine(channels, 12)
    groups = 32 if channels % 32 == 0 else math.gcd(channels, 32)
    x32 = x.float().reshape(2, -1, groups, channels // groups)  # the former body
    var, mean = torch.var_mean(x32, dim=(1, 3), correction=0, keepdim=True)
    want = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w + b
    want = (torch.nn.functional.silu(want) if act else want).to(dtype)
    assert torch.equal(tnorms.group_norm_plain(x, w, b, groups, eps, act), want)
    norm = GroupNorm32(32, channels, eps=eps, act=act)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    cuda_libs.reset_launch_counts()
    with torch.no_grad():
        assert torch.equal(norm(x), want)
    assert tnorms.group_norm.launches == {} and tnorms.layer_norm.launches == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_layer_norm_plain_keeps_its_results(dtype):
    """`layer_norm_plain` is LayerNorm32's former body, bit for bit, and the
    module on CPU tensors takes it and launches nothing."""
    x = torch.from_numpy(_rand((2, 5, 48), 13) * 2 - 3).to(dtype)
    w, b = _affine(48, 14)
    want = torch.nn.functional.layer_norm(x.float(), (48,), w, b, 1e-5).to(dtype)
    assert torch.equal(tnorms.layer_norm_plain(x, w, b, 1e-5), want)
    norm = LayerNorm32(48)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    cuda_libs.reset_launch_counts()
    with torch.no_grad():
        assert torch.equal(norm(x), want)
    assert tnorms.group_norm.launches == {} and tnorms.layer_norm.launches == {}


# [N, M, C] of the U-Net's GroupNorms in the stream (16 rows) and the clip (2
# rows): per-frame slabs at each level, whole rows (temporal blocks), the
# decoder's concatenations; the VAE's 8-frame decode
_GN_SHAPES = [(256, 2560, 320), (16, 40960, 320), (32, 2560, 320), (2, 40960, 320),
              (256, 640, 640), (256, 640, 960), (256, 160, 1280), (256, 160, 1920),
              (256, 40, 1280), (256, 40, 2560), (16, 640, 1280), (8, 163840, 128),
              (2, 7, 20), (3, 1, 100)]


@pytest.mark.parametrize("n,m,c", _GN_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_group_norm_plan_covers_every_row(n, m, c, itemsize):
    """The GroupNorm kernels' plan: the chunks cover each n's rows once, none
    empty; a block has at most 1024 threads and its statistics fit in shared
    memory; each thread row walks GN_MIN_ROWS rows where the chunk has them;
    the launch comes within a tenth of GN_BLOCKS blocks where the rows allow."""
    vec = cuda_libs.vector(itemsize, c, 0)
    assert vec == (16 // itemsize if c % (16 // itemsize) == 0 else 1)
    rows, chunks, rpc = tnorms.group_norm_plan(n, m, c, vec)
    assert (chunks - 1) * rpc < m <= chunks * rpc
    assert 32 <= c // vec * rows <= 1024 and 2 * 4 * rows * c <= 64 * 1024
    assert c // vec * (rows - 1) < 32 or rows * tnorms.GN_MIN_ROWS <= rpc
    want = min(tnorms.GN_BLOCKS, n * max(1, m // tnorms.GN_MIN_ROWS))
    assert 0.9 * want <= n * chunks <= n * -(-tnorms.GN_BLOCKS // n)
    assert cuda_libs.vector(itemsize, c, 8) == 1  # an unaligned input takes one value a thread


def _combine(entries):
    """(count, mean, M2) of the union of disjoint sets given as (count, mean,
    M2) entries, as csrc/norms.cu combines them: the weighted mean, then M2
    about it, sum of M2_e + count_e * (mean_e - mean)^2."""
    total = sum(e[0] for e in entries)
    mean = sum(e[0] * e[1] for e in entries) / total
    return total, mean, sum(e[2] + e[0] * (e[1] - mean) ** 2 for e in entries)


@pytest.mark.parametrize("n,m,c", [(2, 2000, 320), (3, 1000, 20), (2, 700, 96), (1, 5, 40),
                                   (2, 42, 20)])
def test_group_norm_kernel_statistics_model(n, m, c):
    """A model of csrc/norms.cu's statistics on the plan's chunks: thread row
    rr of a block walks rows rr, rr + R, ... of its chunk (base + (rr < extra)
    of them), each group's (thread row, channel) entries combine into a
    chunk's partial, the partials of an n combine with counts chunk rows x
    group size. The mean and variance must be var_mean's over each group."""
    groups = 32 if c % 32 == 0 else math.gcd(c, 32)
    gs = c // groups
    x = _rand((n, m, c), 15).astype(np.float64) * 2 + 5
    vec = cuda_libs.vector(2, c, 0)
    rows, chunks, rpc = tnorms.group_norm_plan(n, m, c, vec)
    assert c // vec * rows >= 32  # a whole warp combines each group
    for i in range(n):
        parts = []
        for k in range(chunks):
            chunk = x[i, k * rpc:(k + 1) * rpc]
            length = len(chunk)
            assert length > 0
            entries = [[] for _ in range(groups)]
            for rr in range(rows):
                mine = chunk[rr::rows]
                count = length // rows + (rr < length % rows)
                assert count == len(mine)
                for ch in range(c):
                    col = mine[:, ch]
                    mean = col.mean() if count else 0.0
                    entries[ch // gs].append((count, mean, ((col - mean) ** 2).sum()))
            parts.append([_combine(e) for e in entries])
        for g in range(groups):
            rows_k = [min(m, (k + 1) * rpc) - k * rpc for k in range(chunks)]
            tot = _combine([(rows_k[k] * gs,) + tuple(parts[k][g][1:]) for k in range(chunks)])
            want = x[i, :, g * gs:(g + 1) * gs]
            assert tot[0] == want.size
            np.testing.assert_allclose(tot[1], want.mean(), rtol=1e-12)
            np.testing.assert_allclose(tot[2] / tot[0], want.var(), rtol=1e-10)


@pytest.mark.parametrize("c,itemsize,want", [
    (320, 2, 2), (640, 2, 3), (1280, 2, 5), (1024, 2, 4), (512, 2, 2), (2048, 2, 8),
    (1280, 4, 10), (1024, 4, 8), (2048, 4, 16), (4096, 2, 0), (100, 2, 0), (36, 4, 1)])
def test_layer_norm_vectors(c, itemsize, want):
    """16-byte vectors a lane holds for the LayerNorm kernel: the row in
    registers up to 2048 values, the any-row kernel (0) past it or where the
    row is not whole vectors."""
    assert tnorms.layer_norm_vectors(c, cuda_libs.vector(itemsize, c, 0)) == want
