"""The port's U-Net options and LatentDiffusion.apply_model against the JAX package's.

Each option of the reference U-Net beside the shipped configuration
(relative-position and causal temporal attention, `tempspatial_aware`,
temporal cross-attention to the first frame's context, a context-free U-Net)
and `no_temporal_attn` in the forward; the relative-position tables carried
by `unet_from_jax`; and the DiffusionWrapper's 12 conditioning keys with the
fps quirk. Weights come from a seed in the port and reach the JAX package
through its own checkpoint converter; fp32 on the CPU, tolerances stated.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_davis import seed_weights
from test_torch_sampling import _rand, one_torch_thread  # noqa: F401  (fixture)

from moca_tpu.models import unet3d as junet
from moca_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from moca_tpu.models.convert import convert_unet
from moca_tpu.models.latent_diffusion import LatentDiffusion as JLatentDiffusion
from moca_tpu.models.vae import VAEConfig as JVAEConfig
from moca_tpu_torch.models import unet3d as tunet
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.convert import unet_from_jax
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.vae import VAEConfig

F = 4
BASE = dict(model_channels=32, num_head_channels=8, context_dim=16, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_res_blocks=1, temporal_length=F)
VAE = dict(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=32)
CLIP = dict(width=16, heads=2, layers=2)
# fp32 on both sides, differing in summation order only; relative to the
# output's magnitude (observed at most 2.2e-6 over the options; bound ~10x)
REL_TOL = 2e-5

# option -> (UNetConfig overrides, forward keyword arguments)
OPTIONS = {
    "no_temporal_attn": ({}, dict(no_temporal_attn=True)),
    "relative_position": (dict(use_relative_position=True), {}),
    "causal": (dict(use_causal_attention=True), {}),
    "relative_position_causal": (dict(use_relative_position=True,
                                      use_causal_attention=True), {}),
    "tempspatial_aware": (dict(tempspatial_aware=True), {}),
    "temporal_cross_attention": (dict(temporal_selfatt_only=False), {}),
    "context_free": (dict(context_dim=None), dict(context=None)),
}


def _close(port, ref, rel=REL_TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def _unet_pair(seed, **overrides):
    """(JAX UNet3D, its params, port UNet3D, config): port weights from a
    seed, carried to JAX by moca_tpu's convert_unet."""
    tcfg = tunet.UNetConfig(**{**BASE, **overrides})
    model = seed_weights(tunet.UNet3D(tcfg), seed)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    params = jax.tree.map(np.asarray, convert_unet(sd, tcfg, prefix=""))
    return junet.UNet3D(junet.UNetConfig(**dataclasses.asdict(tcfg))), params, model, tcfg


def _inputs(context_dim):
    x = _rand((2, F, 8, 8, 4), 1)
    ts = np.random.default_rng(2).integers(0, 1000, (2, F)).astype(np.int32)
    ctx = None if context_dim is None else _rand((2, 7, context_dim), 3)
    return x, ts, ctx


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option):
    """Per-frame timesteps, fps 10, B=2. The state dict makes the round trip
    through moca_tpu's convert_unet and back through unet_from_jax (the
    relative-position tables included), exactly."""
    overrides, call = OPTIONS[option]
    junet3d, params, model, tcfg = _unet_pair(sorted(OPTIONS).index(option), **overrides)
    x, ts, ctx = _inputs(tcfg.context_dim)
    ctx = call.get("context", ctx)
    nta = call.get("no_temporal_attn", False)
    apply = jax.jit(functools.partial(junet3d.apply, fps=10, no_temporal_attn=nta))
    ref = apply(params, jnp.asarray(x), jnp.asarray(ts),
                None if ctx is None else jnp.asarray(ctx))
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        out = model(t(x), t(ts).long(), t(ctx), fps=10, no_temporal_attn=nta)
        full = model(t(x), t(ts).long(), t(ctx), fps=10)
    assert out.shape == (2, F, 8, 8, 4)
    _close(out.numpy(), ref)
    if nta:  # the flag removes work that changes the output
        assert not np.allclose(out.numpy(), full.numpy(), atol=1e-3)
    back = unet_from_jax(params, tcfg)
    own = model.state_dict()
    assert set(back) == set(own)
    for k, v in back.items():
        torch.testing.assert_close(v, own[k], rtol=0, atol=0)
    if tcfg.use_relative_position:
        assert "init_attn.0.transformer_blocks.0.attn2.relative_position_v.embeddings_table" in back


def test_image_attention_is_refused():
    """Image cross-attention is no longer refused: the U-Net builds with
    use_image_attention, with to_k_ip / to_v_ip in the spatial
    transformers' attn2 only (the forward against the JAX package is in
    tests/test_torch_i2v.py)."""
    unet = tunet.UNet3D(tunet.UNetConfig(**BASE, use_image_attention=True))
    keys = [k for k in unet.state_dict() if "_ip." in k]
    assert keys and all(".attn2.to_" in k for k in keys)
    assert all(isinstance(unet.get_submodule(k.rsplit(".transformer_blocks", 1)[0]),
                          tunet.SpatialTransformer) for k in keys)


# ---------------------------------------------------------------------------
# apply_model: the DiffusionWrapper's conditioning keys (ddpm3d.py:696-763)
# ---------------------------------------------------------------------------

# U-Net builds the keys need: (in_channels, context_dim)
BUILDS = {"plain": (4, None), "concat": (8, None), "cross": (4, 16), "hybrid": (8, 16)}
# key -> (build, which of c_concat / c_crossattn / c_adm / s / mask it is given)
KEYS = {
    None: ("plain", ()),
    "concat": ("concat", ("c_concat",)),
    "crossattn": ("cross", ("c_crossattn",)),
    "hybrid": ("hybrid", ("c_concat", "c_crossattn")),
    "resblockcond": ("cross", ("c_crossattn",)),
    "adm": ("plain", ("c_crossattn",)),
    "hybrid-adm": ("hybrid", ("c_concat", "c_crossattn", "c_adm")),
    "hybrid-time": ("hybrid", ("c_concat", "c_crossattn", "s")),
    "concat-time-mask": ("concat", ("c_concat", "s", "mask")),
    "concat-adm-mask": ("concat", ("c_concat", "s", "mask")),
    "hybrid-adm-mask": ("hybrid", ("c_concat", "c_crossattn", "s", "mask")),
    "hybrid-time-adm": ("hybrid", ("c_concat", "c_crossattn", "c_adm", "s")),
}


@pytest.fixture(scope="module")
def wrappers():
    """build -> (JAX LatentDiffusion, port LatentDiffusion) sharing a U-Net."""
    out = {}
    for i, (name, (cin, ctx_dim)) in enumerate(sorted(BUILDS.items())):
        junet3d, params, unet, tcfg = _unet_pair(10 + i, in_channels=cin, context_dim=ctx_dim)
        port = LatentDiffusion(tcfg, VAEConfig(**VAE), CLIPTextConfig(**CLIP)).eval()
        port.unet = unet
        jmodel = JLatentDiffusion(junet3d.cfg, JVAEConfig(**VAE), JCLIPConfig(**CLIP),
                                  params, None, None)
        out[name] = (jmodel, port)
    return out


def _conditioning(given):
    c = {"c_concat": [_rand((1, 2, 8, 8, 4), 4)],
         "c_crossattn": [_rand((1, 7, 16), 5), _rand((1, 5, 16), 6)],
         "c_adm": np.ones((1, 4), np.float32), "s": np.ones((1, 4), np.float32),
         "mask": np.ones((1, 4), np.float32)}
    return {k: c[k] for k in given}


@pytest.mark.parametrize("key", sorted(KEYS, key=str))
def test_apply_model_key_matches_jax(wrappers, key):
    """Each key at fps=99 against the JAX package's apply_model: the concat
    and context wiring, and the kwargs quirk (fps reaches the U-Net only for
    'concat' and 'crossattn'; every other key embeds the default 16)."""
    build, given = KEYS[key]
    jmodel, port = wrappers[build]
    cond = _conditioning(given)
    x = _rand((1, 2, 8, 8, 4), 7)
    ts = np.full((1, 2), 500, np.int32)
    jx = lambda v: [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v)
    tx = lambda v: [torch.from_numpy(a) for a in v] if isinstance(v, list) else torch.from_numpy(v)
    ref = jmodel.apply_model(jmodel.unet_params, jnp.asarray(x), jnp.asarray(ts),
                             conditioning_key=key, fps=99,
                             **{k: jx(v) for k, v in cond.items()})
    run = lambda fps: port.apply_model(torch.from_numpy(x), torch.from_numpy(ts).long(),
                                       conditioning_key=key, fps=fps,
                                       **{k: tx(v) for k, v in cond.items()})
    with torch.no_grad():
        out, out16 = run(99), run(16)
    _close(out.numpy(), ref)
    if key in ("concat", "crossattn"):
        assert not np.allclose(out.numpy(), out16.numpy())
    else:
        torch.testing.assert_close(out, out16, rtol=0, atol=0)


def test_apply_model_refusals(wrappers):
    """The reference's argument checks: 'adm' subscripts c_crossattn, the
    adm/time modes assert their c_adm or s, and an unknown key raises."""
    _, plain = wrappers["plain"]
    _, hybrid = wrappers["hybrid"]
    x, ts = torch.zeros((1, 2, 8, 8, 4)), torch.zeros((1, 2), dtype=torch.long)
    cc, ctx = [torch.zeros((1, 2, 8, 8, 4))], [torch.zeros((1, 7, 16))]
    with pytest.raises(TypeError):
        plain.apply_model(x, ts, conditioning_key="adm")
    for key, kw in (("hybrid-time", {}), ("hybrid-adm", {}),
                    ("hybrid-time-adm", {"s": torch.ones(1)})):
        with pytest.raises(AssertionError):
            hybrid.apply_model(x, ts, c_concat=cc, c_crossattn=ctx, conditioning_key=key, **kw)
    with pytest.raises(NotImplementedError, match="unknown"):
        plain.apply_model(x, ts, conditioning_key="bogus")
