"""The port's i2v model family against the JAX package's.

The CLIP vision tower (the bicubic weights, `preprocess`, `pooled` and
`tokens`), the projectors (ImageProjModel, the Resampler), the U-Net's image
cross-attention at 77 + N context tokens, `LatentVisualDiffusion.
get_image_embeds` in both modes, the T2V pipeline with image tokens (noise
replayed from the JAX keys), the i2v checkpoint loader, `finegrained` from
the YAML, the batch CLI's `--mode i2v` beside the JAX CLI, and the MoCA CLI
on an i2v config beside the JAX CLI. Weights come from a seed on the port's
side and are carried to the JAX package through its own converters. fp32 on
the CPU; tolerances are stated per test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli import TINY_YAML
from test_torch_davis import carry_to_jax, seed_weights
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401
from test_torch_slice import CLIP, FRAME_ATOL, UNET, VAE, F, H, N, NEW, W
from test_torch_t2v import t2v_keys

import moca_tpu.cli.inference as jinf
import moca_tpu.cli.main as jcli
from moca_tpu import config as jconfig
from moca_tpu.models import clip_vision as jvision
from moca_tpu.models import ip_resampler as jresampler
from moca_tpu.models.convert import convert_clip_vision, convert_image_proj, convert_unet
from moca_tpu.models.latent_diffusion import LatentVisualDiffusion as JLatentVisualDiffusion
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.models.unet3d import UNet3D as JUNet3D
from moca_tpu.models.unet3d import UNetConfig as JUNetConfig
from moca_tpu.pipelines.t2v import T2VPipeline as JT2VPipeline
import moca_tpu_torch.cli.inference as inf
import moca_tpu_torch.cli.main as tcli
from moca_tpu_torch import config as tconfig
from moca_tpu_torch.io.checkpoint import load_checkpoint
from moca_tpu_torch.models import clip_vision as tvision
from moca_tpu_torch.models import ip_resampler as tresampler
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.convert import clip_vision_from_jax, image_proj_from_jax
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion, LatentVisualDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import SpatialTransformer, UNet3D, UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.pipelines.t2v import T2VPipeline

VISION = dict(image_size=28, patch_size=14, width=16, heads=2, layers=2, output_dim=16)
UNET_I2V = {**UNET, "use_image_attention": True}
STEPS = 4


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _sd(module):
    return {k: v.detach() for k, v in module.state_dict().items()}


def _assert_trees_equal(a, b):
    flat_a, flat_b = jax.tree_util.tree_flatten_with_path(a)[0], \
        jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def carry_visual_to_jax(tmodel):
    """The JAX LatentVisualDiffusion with the port model's weights, through
    the JAX package's converters."""
    base = carry_to_jax(tmodel)
    vcfg = tmodel.vision_cfg
    return JLatentVisualDiffusion(
        base.unet_cfg, base.vae_cfg, base.clip_cfg, base.unet_params, base.vae_params,
        base.clip_params, scale_factor=base.scale_factor,
        vision_cfg=jvision.CLIPVisionConfig(**dataclasses.asdict(vcfg)),
        vision_params=convert_clip_vision(_sd(tmodel.vision), layers=vcfg.layers, prefix=""),
        proj_params=convert_image_proj(_sd(tmodel.image_proj), prefix=""),
        finegrained=tmodel.finegrained)


def tiny_visual_model(finegrained: bool, seed: int = 3):
    return seed_weights(LatentVisualDiffusion(
        UNetConfig(**UNET_I2V), VAEConfig(**VAE), CLIPTextConfig(**CLIP),
        tvision.CLIPVisionConfig(**VISION), finegrained), seed)


@pytest.fixture(scope="module", params=[False, True], ids=["imageproj", "finegrained"])
def visual_models(request):
    """(JAX model, port model) of the tiny i2v config in one projector mode."""
    tmodel = tiny_visual_model(request.param)
    return carry_visual_to_jax(tmodel), tmodel


# ---------------------------------------------------------------------------
# The vision tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_size,out_size", [(320, 224), (100, 224), (224, 224), (37, 64)])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("antialias", [True, False])
def test_bicubic_weights_equal_jax(in_size, out_size, align_corners, antialias):
    """The port's copy of the numpy resampling matrix, bit for bit."""
    np.testing.assert_array_equal(
        tvision.bicubic_resize_weights(in_size, out_size, align_corners, antialias),
        jvision.bicubic_resize_weights(in_size, out_size, align_corners, antialias))


@pytest.mark.parametrize("size", [28, 224])
def test_preprocess_matches_jax(size):
    """The separable bicubic resize and the CLIP normalization of a
    [2, 40, 52, 3] batch; fp32 sums in another order (observed 9.5e-7 of
    O(1) values; bound 8e-6)."""
    img = _rand((2, 40, 52, 3), 1, -1.0, 1.0)
    port = tvision.preprocess(torch.from_numpy(img), size)
    ref = jvision.preprocess(jnp.asarray(img), size)
    assert port.shape == (2, size, size, 3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=8e-6)


@pytest.mark.parametrize("output", ["pooled", "tokens"])
def test_vision_tower_matches_jax(output):
    """ViT at image 28, patch 14, width 16, 2 layers, from the JAX package's
    init carried across (clip_vision_from_jax, which round-trips through
    convert_clip_vision): pooled [2, 16] and tokens [2, 5, 16] (observed
    3.6e-6 of outputs up to 6.4; bound 1e-5)."""
    jcfg = jvision.CLIPVisionConfig(**VISION)
    img = _rand((2, 40, 40, 3), 2, -1.0, 1.0)
    jmod = jvision.CLIPVisionEncoder(jcfg)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(img))  # every parameter
    params = jax.tree.map(np.asarray, params)
    ref = np.asarray(jmod.apply(params, jnp.asarray(img), output=output))
    tower = tvision.CLIPVisionEncoder(tvision.CLIPVisionConfig(**VISION)).eval()
    tower.load_state_dict(clip_vision_from_jax(params, VISION["layers"]))
    _assert_trees_equal(convert_clip_vision(_sd(tower), layers=VISION["layers"], prefix=""),
                        params)
    with torch.no_grad():
        out = tower(torch.from_numpy(img), output=output).numpy()
    assert out.shape == ((2, 16) if output == "pooled" else (2, 5, 16))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The projectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["imageproj", "resampler"])
def test_projectors_match_jax(kind):
    """ImageProjModel ([3, 24] -> [3, 4, 16]) and the Resampler (depth 2,
    4 heads of 8, 6 queries, [2, 10, 24] -> [2, 6, 16]) from the JAX init
    carried across; LayerNorm outputs O(1) (observed 1.0e-6; bound 1e-5)."""
    if kind == "imageproj":
        jmod = jresampler.ImageProjModel(cross_attention_dim=16, clip_extra_context_tokens=4)
        tmod = tresampler.ImageProjModel(16, 24, 4)
        x = _rand((3, 24), 4)
    else:
        kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=6, embedding_dim=24,
                  output_dim=16)
        jmod, tmod = jresampler.Resampler(**kw), tresampler.Resampler(**kw)
        x = _rand((2, 10, 24), 4)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod.load_state_dict(image_proj_from_jax(params))
    _assert_trees_equal(convert_image_proj(_sd(tmod), prefix=""), params)
    with torch.no_grad():
        out = tmod.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The U-Net's image cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_img", [4, 16])
def test_unet_image_attention_matches_jax(n_img):
    """The tiny U-Net with use_image_attention on a [1, 77 + n_img, 16]
    context against UNet3D.apply on the same weights (carried by the JAX
    converter, to_k_ip / to_v_ip included): observed 2.7e-6 of O(1)
    outputs, bound 2.5e-5. to_k_ip / to_v_ip sit in the spatial transformers'
    attn2 only, and the image tokens move the output."""
    cfg = UNetConfig(**UNET_I2V)
    unet = seed_weights(UNet3D(cfg), 11)
    keys = [k for k in unet.state_dict() if "_ip." in k]
    assert keys and all(".attn2.to_" in k for k in keys)
    spatial = {k.rsplit(".transformer_blocks", 1)[0] for k in keys}
    assert all(isinstance(unet.get_submodule(p), SpatialTransformer) for p in spatial)
    params = convert_unet(_sd(unet), cfg, prefix="")
    x, ctx = _rand((1, F, 4, 4, 4), 12), _rand((1, 77 + n_img, 16), 13)
    ts = np.array([[900, 600, 300, 20]])
    ref = np.asarray(JUNet3D(JUNetConfig(**UNET_I2V)).apply(
        params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), 8))
    t = torch.from_numpy
    with torch.no_grad():
        out = unet(t(x), t(ts), t(ctx), fps=8).numpy()
        zeroed = ctx.copy()
        zeroed[:, 77:] = 0
        out_zero = unet(t(x), t(ts), t(zeroed), fps=8).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.5e-5)
    assert np.abs(out - out_zero).max() > 1e-2


# ---------------------------------------------------------------------------
# LatentVisualDiffusion and the T2V pipeline with image tokens
# ---------------------------------------------------------------------------

def test_get_image_embeds_matches_jax(visual_models):
    """get_image_embeds of a [2, 40, 48, 3] batch: ImageProjModel on the
    pooled embedding ([2, 4, 16]) or the Resampler on the tokens
    ([2, 16, 16]); observed 3.5e-6, bound 3e-5."""
    jmodel, tmodel = visual_models
    img = _rand((2, 40, 48, 3), 20, -1.0, 1.0)
    out = tmodel.get_image_embeds(img)
    ref = np.asarray(jmodel.get_image_embeds(jnp.asarray(img)))
    assert out.shape == ((2, 16, 16) if tmodel.finegrained else (2, 4, 16))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("visual_models,uncond_type", [
    (False, "empty_seq"), (True, "empty_seq"), (True, "zero_embed")],
    indirect=["visual_models"], ids=["imageproj", "finegrained", "finegrained-zero_embed"])
def test_t2v_pipeline_with_image_tokens_matches_jax(visual_models, uncond_type):
    """T2VPipeline with the image tokens of one image: the text context
    gains them and the uncond context zeros of their shape (JAX t2v.py:
    183-190), 4 DDIM steps at guidance 7.5 with the noise replayed from the
    JAX key; frames in [-1, 1] (observed <= 1.2e-5; bound 1e-4). The image
    moves the clip."""
    jmodel, tmodel = visual_models
    build = dict(num_steps=STEPS, guidance_scale=7.5, fps=8, uncond_type=uncond_type)
    jpipe = JT2VPipeline.build(jmodel, JHashTokenizer(), **build)
    tpipe = T2VPipeline.build(tmodel, HashTokenizer(), **build)
    img = _rand((1, 40, 40, 3), 21, -1.0, 1.0)
    tok = tmodel.get_image_embeds(img)
    key = jax.random.PRNGKey(22)
    size = dict(height=H, width=W, frames=F)
    ref = jpipe("a red fox", key, image_tokens=jmodel.get_image_embeds(jnp.asarray(img)), **size)
    normal = lambda: JaxReplayNormal(t2v_keys(key, "base", STEPS).__getitem__)
    port = tpipe("a red fox", normal=normal(), image_tokens=tok, **size)
    assert port.shape == (F, H, W, 3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    other = tpipe("a red fox", normal=normal(), image_tokens=tok * 0 + 1, **size)
    assert np.abs(other.numpy() - port.numpy()).max() > 1e-3


# ---------------------------------------------------------------------------
# Config and loader
# ---------------------------------------------------------------------------

I2V_YAML = TINY_YAML.replace(
    "target: lvdm.models.ddpm3d.LatentDiffusion\n  params:",
    "target: lvdm.models.ddpm3d.LatentVisualDiffusion\n  params:\n    finegrained: true").replace(
    "fps_cond: true", "fps_cond: true\n        use_image_attention: true") + """\
    cond_img_config:
      target: lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2
"""


@pytest.mark.parametrize("finegrained", [True, False])
def test_finegrained_read_from_yaml_matches_jax(tmp_path, finegrained):
    path = tmp_path / "i2v.yaml"
    text = I2V_YAML if finegrained else I2V_YAML.replace("    finegrained: true\n", "")
    path.write_text(text)
    port, ref = tconfig.load_model_config(str(path)), jconfig.load_model_config(str(path))
    assert port.is_i2v and ref.is_i2v and port.unet.use_image_attention
    assert port.finegrained == ref.finegrained == finegrained


def _i2v_state_dict(tmodel):
    """The port model's towers under the upstream i2v prefixes, plus keys
    the loader skips: the schedule buffers and the image embedder's text
    parts."""
    sd = {}
    for tower, prefix in (("unet", "model.diffusion_model."), ("vae", "first_stage_model."),
                          ("clip", "cond_stage_model.model."),
                          ("vision", "embedder.model.visual."),
                          ("image_proj", "image_proj_model.")):
        sd.update({prefix + k: v.clone() for k, v in getattr(tmodel, tower).state_dict().items()})
    sd.update({"betas": torch.linspace(1e-4, 2e-2, 1000),
               "embedder.model.logit_scale": torch.tensor(4.6),
               "embedder.model.token_embedding.weight": torch.ones(8, 16)})
    return sd


@pytest.mark.parametrize("finegrained", [False, True])
def test_i2v_loader_matches_jax_converters(tmp_path, finegrained):
    """load_checkpoint on an i2v file gives the towers that the JAX
    package's convert_clip_vision / convert_image_proj / convert_unet read
    from the same file (to_k_ip / to_v_ip loaded strictly); a stray key and
    a missing to_k_ip fail; a text-to-video model with the i2v U-Net (the
    MoCA CLI on an i2v config) takes the U-Net and skips the image towers."""
    tmodel = tiny_visual_model(finegrained, seed=30)
    sd = _i2v_state_dict(tmodel)
    torch.save({"state_dict": sd}, tmp_path / "i2v.ckpt")
    fresh = LatentVisualDiffusion(tmodel.unet_cfg, tmodel.vae_cfg, tmodel.clip_cfg,
                                  tmodel.vision_cfg, finegrained).eval()
    skipped = load_checkpoint(str(tmp_path / "i2v.ckpt"), fresh)
    assert skipped == ["betas", "embedder.model.logit_scale",
                       "embedder.model.token_embedding.weight"]
    file_sd = {k: v.numpy() for k, v in sd.items()}
    with_prefix = lambda m, p: {p + k: v for k, v in _sd(m).items()}
    _assert_trees_equal(
        convert_clip_vision(with_prefix(fresh.vision, "embedder.model.visual."), VISION["layers"]),
        convert_clip_vision(file_sd, VISION["layers"]))
    _assert_trees_equal(convert_image_proj(with_prefix(fresh.image_proj, "image_proj_model.")),
                        convert_image_proj(file_sd))
    _assert_trees_equal(convert_unet(with_prefix(fresh.unet, "model.diffusion_model."),
                                     tmodel.unet_cfg), convert_unet(file_sd, tmodel.unet_cfg))
    ip_key = next(k for k in sd if k.endswith("attn2.to_k_ip.weight"))
    for name, bad, exc in (("stray", {**sd, "mystery.weight": torch.ones(1)}, ValueError),
                           ("missing", {k: v for k, v in sd.items() if k != ip_key},
                            RuntimeError)):
        torch.save({"state_dict": bad}, tmp_path / f"{name}.ckpt")
        with pytest.raises(exc, match="mystery|to_k_ip"):
            load_checkpoint(str(tmp_path / f"{name}.ckpt"), fresh)
    plain = LatentDiffusion(tmodel.unet_cfg, tmodel.vae_cfg, tmodel.clip_cfg).eval()
    skipped = load_checkpoint(str(tmp_path / "i2v.ckpt"), plain)
    assert sum(k.startswith(("embedder.", "image_proj_model.")) for k in skipped) == \
        sum(k.startswith(("embedder.", "image_proj_model.")) for k in sd)
    for k, v in _sd(plain.unet).items():
        torch.testing.assert_close(v, sd["model.diffusion_model." + k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The batch CLI's --mode i2v beside the JAX CLI
# ---------------------------------------------------------------------------

PROMPTS = "a red fox\na blue bird\n"


def _write_images(d, n=2):
    """n conditioning PNGs and two files the extension filter must skip."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(40)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8), "RGB").save(
            os.path.join(d, f"cond_{i}.png"))
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not an image")
    with open(os.path.join(d, ".DS_Store"), "wb") as f:
        f.write(b"\x00")


def _patch_jax_cli(monkeypatch, jmodel, finegrained):
    """The JAX batch CLI with `jmodel` in place of its loader, as
    tests/test_cli_inference_i2v.py injects it."""
    jcfg = jconfig.ModelConfig(diffusion=jconfig.DiffusionParams(),
                               unet=jmodel.unet_cfg, vae=jmodel.vae_cfg, clip=jmodel.clip_cfg,
                               is_i2v=True, finegrained=finegrained)
    monkeypatch.setattr(jinf, "load_model_config", lambda *a, **k: jcfg)
    monkeypatch.setattr(jinf, "_load_i2v_model", lambda *a, **k: jmodel)
    monkeypatch.setattr(jinf, "load_tokenizer", lambda *a: JHashTokenizer())


def _run_i2v_clis(visual_models, tmp_path, monkeypatch, extra=(), prompts=PROMPTS, n_images=2):
    """Each package's batch CLI in i2v mode on the same prompt file and
    images, the model injected (JAX: its loader patched, as
    tests/test_cli_inference_i2v.py does; port: `pipe=`), the port's noise
    replayed from the JAX CLI's keys. Returns ({name: JAX videos},
    {name: port videos}, the port's savedir)."""
    jmodel, tmodel = visual_models
    (tmp_path / "prompts.txt").write_text(prompts)
    _write_images(str(tmp_path / "cond"), n_images)
    argv = ["--ckpt_path", "/nonexistent.ckpt", "--prompt_file", str(tmp_path / "prompts.txt"),
            "--mode", "i2v", "--cond_input", str(tmp_path / "cond"), "--height", str(H),
            "--width", str(W), "--frames", str(F), "--ddim_steps", str(STEPS), "--seed", "9"]
    argv += list(extra)
    written = {"jax": {}, "port": {}}

    def capture(which, real):
        def save(samples, path, fps=10):
            written[which][os.path.basename(path)] = [np.stack(s) for s in samples]
            real(samples, path, fps=fps)
        return save

    _patch_jax_cli(monkeypatch, jmodel, tmodel.finegrained)
    monkeypatch.setattr(jinf, "save_video_grid", capture("jax", jinf.save_video_grid))
    monkeypatch.setattr(inf, "save_video_grid", capture("port", inf.save_video_grid))
    kind = "freeinit" if "--freeinit_iters" in argv else "base"

    def replay(seed, prompt_index, sample_index, n_samples, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                 prompt_index * max(n_samples, 1) + sample_index)
        return JaxReplayNormal(t2v_keys(key, kind, STEPS).__getitem__)

    monkeypatch.setattr(inf, "sample_normal", replay)
    results = []
    for which, cli in (("jax", jinf), ("port", inf)):
        args = cli.build_parser().parse_args(argv + ["--savedir", str(tmp_path / which)])
        if which == "jax":
            cli.main(args)
        else:
            cli.main(args, pipe=T2VPipeline.build(tmodel, HashTokenizer(), num_steps=STEPS,
                                                  guidance_scale=12.0, fps=28))
        results.append(written[which])
    return results[0], results[1], tmp_path / "port"


@pytest.mark.parametrize("visual_models,shard,files", [
    (False, [], ["cond_0.mp4", "cond_1.mp4"]), (True, [], ["cond_0.mp4", "cond_1.mp4"]),
    (True, ["--num_processes", "2", "--rank", "1"], ["cond_1.mp4"])],
    indirect=["visual_models"], ids=["imageproj", "finegrained", "finegrained-rank1of2"])
def test_i2v_cli_matches_jax_cli(visual_models, tmp_path, monkeypatch, shard, files):
    """Two prompts, two images and two stray files: both CLIs write one mp4
    a prompt named after its image's stem, the count checked over the whole
    prompt file (rank 1 of 2 has one prompt and takes image 1), and each
    clip equals the JAX CLI's (observed <= 1.7e-5; bound 1.5e-4); the
    images differ, so do the clips."""
    ref, port, savedir = _run_i2v_clis(visual_models, tmp_path, monkeypatch, shard)
    assert sorted(port) == sorted(ref) == sorted(os.listdir(savedir)) == files
    for name in port:
        np.testing.assert_allclose(port[name][0], ref[name][0], rtol=0, atol=1.5e-4)
    if len(files) == 2:
        assert np.abs(port["cond_0.mp4"][0] - port["cond_1.mp4"][0]).max() > 1e-3


@pytest.mark.parametrize("visual_models", [True], indirect=True, ids=["finegrained"])
def test_i2v_cli_freeinit_samples_without_image_tokens(visual_models, tmp_path, monkeypatch):
    """--freeinit_iters 2 in i2v mode: FreeInit gets no image tokens in the
    JAX CLI (moca_tpu/cli/inference.py:201-204), so the clip equals the JAX
    CLI's (observed 2.7e-5; bound FRAME_ATOL, 2e-4) and the port pipeline's
    FreeInit call without tokens (the same computation; bound 1e-6)."""
    ref, port, _ = _run_i2v_clis(visual_models, tmp_path, monkeypatch,
                                 ["--freeinit_iters", "2"], prompts="a red fox\n", n_images=1)
    np.testing.assert_allclose(port["cond_0.mp4"][0], ref["cond_0.mp4"][0], rtol=0,
                               atol=FRAME_ATOL)
    tmodel = visual_models[1]
    pipe = T2VPipeline.build(tmodel, HashTokenizer(), num_steps=STEPS, guidance_scale=12.0,
                             fps=28)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    own = pipe.sample_with_freeinit("a red fox", iterations=2, height=H, width=W, frames=F,
                                    normal=JaxReplayNormal(t2v_keys(key, "freeinit",
                                                                    STEPS).__getitem__))
    np.testing.assert_allclose(port["cond_0.mp4"][0], own.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("visual_models", [False], indirect=True, ids=["imageproj"])
def test_i2v_cli_refusals(visual_models, tmp_path, monkeypatch):
    """One image a prompt over the whole prompt file (a shard of one prompt
    does not pass), a directory of images, and --bs 1: the JAX CLI asserts
    (AssertionError), the port raises ValueError with the same message,
    before it samples or writes anything."""
    jmodel, tmodel = visual_models
    _patch_jax_cli(monkeypatch, jmodel, tmodel.finegrained)
    _write_images(str(tmp_path / "cond"), 2)
    (tmp_path / "three.txt").write_text("a\nb\nc\n")
    (tmp_path / "two.txt").write_text("a\nb\n")
    pipe = T2VPipeline.build(tmodel, HashTokenizer(), num_steps=STEPS)
    base = ["--ckpt_path", "/nonexistent.ckpt", "--mode", "i2v", "--savedir",
            str(tmp_path / "out"), "--height", str(H), "--width", str(W), "--frames", str(F)]
    cases = [(["--prompt_file", str(tmp_path / "three.txt"), "--cond_input",
               str(tmp_path / "cond")], r"conditional input \(2\) NOT match prompt \(3\)"),
             (["--prompt_file", str(tmp_path / "three.txt"), "--cond_input",
               str(tmp_path / "cond"), "--num_processes", "3", "--rank", "1"],
              r"NOT match prompt \(3\)"),
             (["--prompt_file", str(tmp_path / "two.txt")], "cond_image_dir"),
             (["--prompt_file", str(tmp_path / "two.txt"), "--cond_input",
               str(tmp_path / "cond"), "--bs", "2"], "plain base sampling")]
    for extra, match in cases:
        with pytest.raises(ValueError, match=match):
            inf.main(inf.build_parser().parse_args(base + extra), pipe=pipe)
        with pytest.raises(AssertionError, match=match):
            jinf.main(jinf.build_parser().parse_args(
                base + extra + ["--savedir", str(tmp_path / "jax")]))
    assert not os.path.exists(tmp_path / "out")


def test_i2v_load_pipeline_from_yaml(tmp_path, monkeypatch):
    """inf.load_pipeline on an i2v YAML and checkpoint (the vision config
    shrunk in place of ViT-H/14): the i2v model with the Resampler, its
    towers as in the file, the vision tower and projector in fp32 under
    --precision bf16."""
    (tmp_path / "i2v.yaml").write_text(I2V_YAML)
    tmodel = tiny_visual_model(True, seed=31)
    torch.save(_i2v_state_dict(tmodel), tmp_path / "model.ckpt")
    monkeypatch.setattr(tcli, "CLIPVisionConfig", lambda: tvision.CLIPVisionConfig(**VISION))
    monkeypatch.setattr(inf, "load_tokenizer", lambda *a: HashTokenizer())
    args = inf.build_parser().parse_args([
        "--ckpt_path", str(tmp_path / "model.ckpt"), "--config", str(tmp_path / "i2v.yaml"),
        "--prompt_file", "unused.txt", "--precision", "bf16"])
    pipe = inf.load_pipeline(args, device="cpu")
    model = pipe.model
    assert isinstance(model, LatentVisualDiffusion) and model.finegrained
    assert model.vision.proj.dtype == model.image_proj.proj_in.weight.dtype == torch.float32
    assert model.unet.dtype == torch.bfloat16
    for tower in ("vision", "image_proj"):
        for k, v in _sd(getattr(model, tower)).items():
            torch.testing.assert_close(v, _sd(getattr(tmodel, tower))[k], rtol=0, atol=0)
    assert model.get_image_embeds(_rand((1, 32, 32, 3), 32, -1, 1)).shape == (1, 16, 16)


def test_moca_cli_on_i2v_config_matches_jax(tmp_path, monkeypatch):
    """The MoCA CLI on an i2v YAML and checkpoint: the JAX CLI builds the
    text-to-video bundle with the i2v U-Net, whose image branch attends to
    the concept prompt's 77 tokens (the context's tokens after the first
    77), and skips the image towers; the port does the same. Both load
    their pipelines from the files; the port's frames equal the JAX
    pipeline's with the noise replayed (observed 9.5e-6; bound 9e-5)."""
    (tmp_path / "i2v.yaml").write_text(I2V_YAML)
    torch.save(_i2v_state_dict(tiny_visual_model(True, seed=33)), tmp_path / "model.ckpt")
    argv = ["--ckpt_path", str(tmp_path / "model.ckpt"), "--config", str(tmp_path / "i2v.yaml"),
            "--precision", "fp32", "--video_length", str(F), "-n", str(N),
            "-l", str(NEW), "--height", str(H), "--width", str(W),
            "--unconditional_guidance_scale", "7.5"]
    monkeypatch.setattr(jcli, "load_tokenizer", lambda *a: JHashTokenizer())
    monkeypatch.setattr(tcli, "load_tokenizer", lambda *a: HashTokenizer())
    jpipe = jcli.load_pipeline(jcli.build_parser().parse_args(argv))
    tpipe = tcli.load_pipeline(tcli.build_parser().parse_args(argv), device="cpu")
    assert type(tpipe.model) is LatentDiffusion and tpipe.model.unet.cfg.use_image_attention
    cond = _rand((H // 8, W // 8, 4), 34)
    call = dict(cond_image=cond, conditioned_prompt="a dog", gamma=0.7, height=H, width=W)
    key = jax.random.PRNGKey(35)
    ref = jpipe("a cat surfing", key, **call)
    total = NEW + F * N - F
    port = tpipe("a cat surfing", normal=JaxReplayNormal(
        pipeline_keys(key, F * N, total, jpipe.plan.num_windows, F)), **call)
    assert len(port) == len(ref) == total
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(r), rtol=0, atol=9e-5)
