"""DynamiCrafter's image animation on the port against the plain reference.

The port's hybrid i2v path (the image latent on every frame's input, per-frame
image tokens, v-prediction on a zero-terminal-SNR schedule with trailing
timesteps, guidance rescale and the dynamic rescale of x0) against
`benchmark/reference/hybrid_i2v.py`, a float32 implementation written apart
from the port, at a tiny size on the CPU in float32, on seeded random weights
that both load: the schedule, the Resampler with per-frame queries, the U-Net
with `in_channels` 8 and a per-frame context, one guided v-step at t = 999
(alpha_bar = 0) and at a late t, a whole clip through `T2VPipeline`, the
YAML, the batch CLI, four planted faults, and the `unet.xattn` and
`vae.encode` trace ranges.

Tolerances: both sides compute the same float32 arithmetic in another order
(the port's fused guidance rows, its norms' and attention's plain paths, the
reference's einsum attention), so they agree to float32 rounding amplified
by the network's depth: 1e-5 relative for one network call or one step, 1e-4
for a whole clip, whose steps and decode compound it. A planted fault must
move the clip by 1e-3 or more, ten times that.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from benchmark import common
from benchmark.drivers import i2v_hybrid
from benchmark.faults_hybrid import FAULTS
from benchmark.reference import diffusion as rd
from benchmark.reference import hybrid_i2v, nets
from benchmark.tests.tiny import tiny_cell
from moca_tpu_torch.cli import inference as inf
from moca_tpu_torch.cli import main as tcli
from moca_tpu_torch.config import load_model_config
from moca_tpu_torch.models.clip_vision import CLIPVisionConfig
from moca_tpu_torch.models.ip_resampler import Resampler
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import (FRAME_IMAGE_TOKENS, TEXT_CONTEXT_LEN, SpatialTransformer,
                                          UNet3D, UNetConfig, frame_context)
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling.ddim import ddim_step_math, make_cfg_eps_fn
from moca_tpu_torch.schedule import make_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "dynamicrafter_inference_1024_v1.0.yaml")
F, H, W, STEPS = 4, 32, 64, 3
PROMPT = "A majestic eagle soaring through the sky"
HYBRID = dict(ddim_discretize="uniform_trailing", rescale_betas_zero_snr=True,
              parameterization="v", dynamic_rescale=True, scale_b=0.3)
SCALE, RESCALE, FS = 7.5, 0.7, 10


def rel(a, b):
    return common.rel_l2(a, b)


def tiny_config() -> common.Cell:
    """The benchmark's DynamiCrafter cell at the harness's tiny widths, in
    float32, the Resampler's queries for F frames."""
    cell = tiny_cell("dc1024-i2v-clip", precision="float32")
    c = cell.config
    c["resampler"].update(video_length=F, embedding_dim=c["vision"]["width"],
                          output_dim=c["unet"]["context_dim"])
    return cell


@pytest.fixture(scope="module")
def models():
    """(cell, the port's model, the reference) on the same seeded weights."""
    cell = tiny_config()
    weights = i2v_hybrid.seed_weights(cell)
    port = i2v_hybrid.build_model(cell.config)
    port.load_state_dict(weights, strict=True, assign=True)
    return cell, port, hybrid_i2v.build(cell.config, weights)


def hybrid_schedule(steps):
    return make_schedule(steps, ddim_eta=1.0, use_scale=False, device="cpu", **HYBRID)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def test_zero_snr_schedule_and_trailing_timesteps(models):
    cell = models[0]
    sch = hybrid_schedule(50)
    assert float(sch.alphas_cumprod[-1]) == 0.0 and float(sch.ddim_alphas[-1]) == 0.0
    np.testing.assert_array_equal(sch.ddim_timesteps_np, np.arange(19, 1000, 20))
    plain = make_schedule(50, device="cpu")
    assert float(sch.alphas_cumprod[0]) == pytest.approx(float(plain.alphas_cumprod[0]), rel=1e-6)
    ref = hybrid_i2v.Schedule(50, 1.0, cell.config["diffusion"], "cpu")
    np.testing.assert_array_equal(ref.timesteps, sch.ddim_timesteps_np)
    for ours, theirs in ((sch.ddim_sqrt_alphas, ref.sqrt_a),
                         (sch.ddim_sqrt_one_minus_alphas, ref.sqrt_1ma),
                         (sch.ddim_alphas_prev, ref.a_prev), (sch.ddim_sigmas, ref.sigma),
                         (sch.ddim_scale_arr, ref.r), (sch.ddim_scale_arr_prev, ref.r_prev)):
        torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-7)
    # the dynamic rescale: 1 -> 0.3 over 400 timesteps, the first step's previous its own
    assert float(sch.ddim_scale_arr[-1]) == pytest.approx(0.3)
    assert float(sch.ddim_scale_arr_prev[0]) == float(sch.ddim_scale_arr[0]) < 1.0
    assert float(plain.ddim_scale_arr_prev[0]) == 1.0  # VideoCrafter's rule stays


# ---------------------------------------------------------------------------
# The networks
# ---------------------------------------------------------------------------

@torch.inference_mode()
def test_resampler_with_per_frame_queries():
    g = torch.Generator().manual_seed(3)
    port = Resampler(dim=16, depth=2, dim_head=8, heads=2, num_queries=16, embedding_dim=32,
                     output_dim=24, video_length=F)
    ref = nets.Resampler(dim=16, depth=2, dim_head=8, heads=2, num_queries=16 * F,
                         embedding_dim=32, output_dim=24)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    ref.load_state_dict(port.state_dict(), strict=True)
    feats = torch.randn(2, 5, 32, generator=g)
    out = port(feats)
    assert out.shape == (2, 16 * F, 24)
    assert rel(out, ref(feats)) < 1e-5


def test_frame_context_gives_each_frame_its_own_tokens():
    ctx = torch.randn(2, TEXT_CONTEXT_LEN + F * FRAME_IMAGE_TOKENS, 8)
    rows = frame_context(ctx, F)
    assert rows.shape == (2 * F, TEXT_CONTEXT_LEN + FRAME_IMAGE_TOKENS, 8)
    for b in range(2):
        for f in range(F):
            row = rows[b * F + f]
            assert torch.equal(row[:TEXT_CONTEXT_LEN], ctx[b, :TEXT_CONTEXT_LEN])
            first = TEXT_CONTEXT_LEN + f * FRAME_IMAGE_TOKENS
            assert torch.equal(row[TEXT_CONTEXT_LEN:], ctx[b, first:first + FRAME_IMAGE_TOKENS])
    other = torch.randn(2, TEXT_CONTEXT_LEN + FRAME_IMAGE_TOKENS, 8)  # one set for every frame
    assert torch.equal(frame_context(other, F), other.repeat_interleave(F, dim=0))


@torch.inference_mode()
def test_unet_with_concat_input_and_per_frame_context(models):
    cell, port, ref = models
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, F, 4, 8, 8, generator=g)
    t = torch.randint(0, 1000, (2, F), generator=g)
    ctx = torch.randn(2, TEXT_CONTEXT_LEN + F * FRAME_IMAGE_TOKENS,
                      cell.config["unet"]["context_dim"], generator=g)
    out = port.apply_unet(x[..., :4], t, ctx, FS, c_concat=x[..., 4:])
    assert rel(out, ref.unet(x, t, ctx, FS)) < 1e-5


@torch.inference_mode()
def test_each_frame_reads_its_own_image_tokens():
    """A U-Net whose frames do not mix (no temporal layers): new image tokens
    for frame 2 move frame 2's output and no other frame's."""
    cfg = UNetConfig(in_channels=8, model_channels=32, num_head_channels=8, context_dim=16,
                     channel_mult=(1, 2), attention_resolutions=(1, 2), num_res_blocks=1,
                     temporal_length=F, temporal_conv=False, temporal_attention=False,
                     addition_attention=False, use_image_attention=True)
    torch.manual_seed(4)
    unet = UNet3D(cfg).eval()
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.2)
    x = torch.randn(1, F, 4, 8, 8)
    t = torch.full((1, F), 500)
    ctx = torch.randn(1, TEXT_CONTEXT_LEN + F * FRAME_IMAGE_TOKENS, 16)
    moved = ctx.clone()
    first = TEXT_CONTEXT_LEN + 2 * FRAME_IMAGE_TOKENS
    moved[:, first:first + FRAME_IMAGE_TOKENS] = torch.randn(FRAME_IMAGE_TOKENS, 16)
    a, b = unet(x, t, ctx, fps=FS), unet(x, t, moved, fps=FS)
    for f in range(F):
        if f == 2:
            assert rel(b[:, f], a[:, f]) > 1e-2
        else:
            assert torch.equal(a[:, f], b[:, f]), f


@torch.inference_mode()
def test_image_towers_and_latent(models):
    _, port, ref = models
    g = torch.Generator().manual_seed(2)
    image = torch.rand(1, H, W, 3, generator=g) * 2 - 1
    normal = common.SeededNormal(7, "cpu")
    pipe = T2VPipeline.build(port, HashTokenizer(), num_steps=STEPS, hybrid=True)
    cond = pipe.image_condition(image, normal)
    assert cond["image_tokens"].shape[1] == FRAME_IMAGE_TOKENS * F
    assert rel(cond["image_tokens"], ref.image_embeds(image)) < 1e-5
    assert rel(cond["uncond_image_tokens"], ref.image_embeds(torch.zeros_like(image))) < 1e-5
    z = ref.image_latent(image, normal(("image_latent",), (1, H // 8, W // 8, 4)))
    assert cond["image_latent"].shape == (1, 1, H // 8, W // 8, 4)
    assert rel(cond["image_latent"][:, 0], z) < 1e-5


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [STEPS - 1, 0], ids=["t999", "late"])
def test_one_guided_v_step(index):
    """The fused guidance call (the concat input on both rows), guidance
    rescale and the v-step against the reference's, at the first DDIM step
    (t = 999, alpha_bar = 0: eps = x, x0 = -v) and at the last."""
    sch = hybrid_schedule(STEPS)
    ref_sch = hybrid_i2v.Schedule(STEPS, 1.0, dict(
        timesteps=1000, linear_start=0.00085, linear_end=0.012, rescale_betas_zero_snr=True,
        use_dynamic_rescale=True, base_scale=0.3), "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, F, 4, 8, 4, generator=g)
    v_c, v_u = torch.randn(2, 1, F, 4, 8, 4, generator=g)
    v_u = 0.5 * v_c + v_u  # correlated, as a U-Net's two rows are
    z = torch.randn(1, F, 4, 8, 4, generator=g)
    noise = torch.randn(1, F, 4, 8, 4, generator=g)
    seen = {}

    def unet_apply(x2, t2, ctx2, fps, c_concat=None):
        seen.update(x=x2, c=c_concat, fps=fps)
        return torch.stack([v_c[0], v_u[0]])[None].reshape(2, F, 4, 8, 4)

    eps_fn = make_cfg_eps_fn(unet_apply, torch.zeros(1, 93, 16), torch.ones(1, 93, 16), SCALE,
                             fps=FS, guidance_rescale=RESCALE, c_concat=z)
    t_frames = torch.full((1, F), int(sch.ddim_timesteps_np[index]))
    x_prev, _ = ddim_step_math(sch, x, eps_fn(x, t_frames), index, noise)
    assert seen["fps"] == FS and torch.equal(seen["c"], torch.cat([z, z]))
    v, _ = hybrid_i2v.guided(v_c, v_u, SCALE, RESCALE)
    want = hybrid_i2v.v_step(ref_sch, x, v, index, noise)
    assert rel(x_prev, want) < 1e-5
    if index == STEPS - 1:
        assert int(sch.ddim_timesteps_np[index]) == 999 and torch.isfinite(x_prev).all()


# ---------------------------------------------------------------------------
# A whole clip
# ---------------------------------------------------------------------------

def image_and_normal():
    image = torch.rand(1, H, W, 3, generator=torch.Generator().manual_seed(8)) * 2 - 1
    return image, common.SeededNormal(11, "cpu")


@torch.inference_mode()
def port_clip(port):
    image, normal = image_and_normal()
    pipe = T2VPipeline.build(port, HashTokenizer(), num_steps=STEPS, eta=1.0, use_scale=False,
                             guidance_scale=SCALE, fps=FS, guidance_rescale=RESCALE, hybrid=True,
                             **HYBRID)
    return pipe(PROMPT, normal=normal, height=H, width=W, frames=F,
                **pipe.image_condition(image, normal))


@pytest.fixture(scope="module")
def reference_clip(models):
    """The reference's own sampling loop: tokens of the image and of the
    zero image, the latent, STEPS guided v-steps from the same draws, the
    decode."""
    cell, _, m = models
    image, normal = image_and_normal()
    h, w = H // 8, W // 8
    with torch.inference_mode():
        sch = hybrid_i2v.Schedule(STEPS, 1.0, cell.config["diffusion"], "cpu")
        z = m.image_latent(image, normal(("image_latent",), (1, h, w, 4)))[:, None]
        z = z.expand(1, F, h, w, 4)
        text = lambda p: m.clip(torch.as_tensor(rd.hash_tokens([p])))
        ctx = torch.cat([text(PROMPT), m.image_embeds(image)], dim=1)
        uc = torch.cat([text(""), m.image_embeds(torch.zeros_like(image))], dim=1)
        net = lambda xx, tt, cc: m.unet(torch.cat([xx, z.expand(xx.shape[0], -1, -1, -1, -1)],
                                                  dim=-1), tt, cc, FS)
        x = normal(("base", "init"), (1, F, h, w, 4))
        for i in range(STEPS):
            index = STEPS - 1 - i
            tt = torch.full((1, F), int(sch.timesteps[index]))
            v, _ = hybrid_i2v.guided(*rd.cfg_parts(net, x, tt, ctx, uc), SCALE, RESCALE)
            x = hybrid_i2v.v_step(sch, x, v, index, normal(("base", "step", i), x.shape))
        return m.decode(x[0])


def test_whole_clip_through_t2v_pipeline(models, reference_clip):
    video = port_clip(models[1])
    assert video.shape == (F, H, W, 3)
    assert rel(video, reference_clip) < 1e-4


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_moves_the_clip(models, reference_clip, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    err = rel(port_clip(models[1]), reference_clip)
    assert not np.isfinite(err) or err > 1e-3, err


# ---------------------------------------------------------------------------
# The YAML and the CLI
# ---------------------------------------------------------------------------

def test_yaml_reads_into_the_port_configs():
    cfg = load_model_config(YAML)
    d, u, s = cfg.diffusion, cfg.unet, cfg.sampling
    assert d.conditioning_key == "hybrid" and d.image_size == (72, 128)
    assert cfg.is_i2v and cfg.finegrained and cfg.image_video_length == 16
    assert (u.in_channels, u.out_channels, u.model_channels, u.context_dim) == (8, 4, 320, 1024)
    assert u.use_image_attention and u.fps_cond and u.addition_attention
    assert u.temporal_length == 16 and u.channel_mult == (1, 2, 4, 4)
    assert (s.rescale_betas_zero_snr, s.parameterization, s.use_dynamic_rescale,
            s.base_scale) == (True, "v", True, 0.3)
    assert s.schedule_kwargs() == dict(rescale_betas_zero_snr=True, parameterization="v",
                                       dynamic_rescale=True, scale_b=0.3)
    shipped = load_model_config(os.path.join(ROOT, "configs", "inference_t2v_512_v2.0.yaml"))
    assert shipped.sampling.schedule_kwargs() == {} and shipped.image_video_length is None


def tiny_yaml(path, cell):
    """The DynamiCrafter YAML at the tiny widths (the text tower's size keys
    are the port's extension for shrunk configs)."""
    with open(YAML) as f:
        raw = yaml.safe_load(f)
    mp, c = raw["model"]["params"], cell.config
    u = mp["unet_config"]["params"]
    u.update({k: c["unet"][k] for k in ("model_channels", "num_head_channels", "context_dim",
                                        "attention_resolutions", "channel_mult",
                                        "num_res_blocks", "temporal_length")})
    mp["first_stage_config"]["params"]["ddconfig"].update(
        {k: c["vae"][k] for k in ("resolution", "ch", "ch_mult", "num_res_blocks")})
    mp["cond_stage_config"]["params"].update(c["clip"])
    mp["image_proj_stage_config"]["params"]["video_length"] = F
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)


def test_cli_runs_a_hybrid_config(models, tmp_path, monkeypatch):
    """`cli/inference.py --mode i2v` on a tiny DynamiCrafter YAML and an
    upstream-layout checkpoint of the tiny model, with DynamiCrafter's flags:
    one mp4 named after the image, whose frames equal the pipeline's own
    call on the same model and draws (observed equal; bound 1e-6)."""
    from PIL import Image

    cell, port, _ = models
    tiny_yaml(tmp_path / "dc.yaml", cell)
    sd = {}
    for tower, prefix in (("unet", "model.diffusion_model."), ("vae", "first_stage_model."),
                          ("clip", "cond_stage_model.model."),
                          ("vision", "embedder.model.visual."),
                          ("image_proj", "image_proj_model.")):
        sd.update({prefix + k: v.clone() for k, v in getattr(port, tower).state_dict().items()})
    torch.save({"state_dict": sd}, tmp_path / "model.ckpt")
    os.makedirs(tmp_path / "cond")
    pixels = np.random.default_rng(3).integers(0, 255, (H, W, 3), dtype=np.uint8)
    Image.fromarray(pixels, "RGB").save(tmp_path / "cond" / "eagle.png")
    (tmp_path / "prompts.txt").write_text(PROMPT + "\n")
    monkeypatch.setattr(tcli, "CLIPVisionConfig",
                        lambda: CLIPVisionConfig(**cell.config["vision"]))
    monkeypatch.setattr(inf, "load_tokenizer", lambda *a: HashTokenizer())
    written = {}
    monkeypatch.setattr(inf, "save_video_grid",
                        lambda samples, path, fps=10: written.update({os.path.basename(path):
                                                                      np.stack(samples[0])}))
    args = inf.build_parser().parse_args([
        "--ckpt_path", str(tmp_path / "model.ckpt"), "--config", str(tmp_path / "dc.yaml"),
        "--prompt_file", str(tmp_path / "prompts.txt"), "--mode", "i2v", "--cond_input",
        str(tmp_path / "cond"), "--savedir", str(tmp_path / "out"), "--height", str(H),
        "--width", str(W), "--frames", str(F), "--ddim_steps", str(STEPS), "--frame_stride",
        str(FS), "--unconditional_guidance_scale", str(SCALE), "--guidance_rescale",
        str(RESCALE), "--timestep_spacing", "uniform_trailing", "--precision", "fp32"])
    pipe = inf.load_pipeline(args, device="cpu")
    assert pipe.hybrid and pipe.fps == FS and pipe.guidance_rescale == RESCALE
    assert pipe.sch.parameterization == "v" and int(pipe.sch.ddim_timesteps_np[-1]) == 999
    inf.main(args, pipe=pipe)
    assert list(written) == ["eagle.mp4"]
    image = torch.as_tensor(inf.load_cond_images(args, 1)[0][:1])
    normal = inf.sample_normal(args.seed, 0, 0, 1, "cpu")
    with torch.inference_mode():
        own = pipe(PROMPT, normal=normal, height=H, width=W, frames=F,
                   **pipe.image_condition(image, normal))
    np.testing.assert_allclose(written["eagle.mp4"], own.numpy(), rtol=0, atol=1e-6)


def test_hybrid_conditioning_is_refused_on_a_mesh(models):
    """The concat input is not split over a mesh's ranks: refused before sampling."""
    pipe = T2VPipeline.build(models[1], HashTokenizer(), num_steps=STEPS, hybrid=True,
                             **HYBRID)
    pipe.mesh = object()
    image, normal = image_and_normal()
    with pytest.raises(NotImplementedError, match="one card"):
        pipe(PROMPT, normal=normal, height=H, width=W, frames=F,
             **pipe.image_condition(image, normal))


def test_cli_flags_default_to_the_videocrafter_path():
    args = inf.build_parser().parse_args(["--ckpt_path", "m.ckpt", "--prompt_file", "p.txt"])
    assert (args.frame_stride, args.guidance_rescale, args.timestep_spacing) == (
        None, 0.0, "uniform")


# ---------------------------------------------------------------------------
# Trace ranges
# ---------------------------------------------------------------------------

def test_xattn_and_vae_encode_spans(models):
    """`unet.xattn` once a spatial transformer a U-Net call, inside
    `unet.spatial` and around the cross-attention alone (no norm in it);
    `vae.encode` once an encoded image, outside the U-Net; neither anywhere
    else."""
    port = models[1]

    def unet(*args, **kwargs):
        with torch.profiler.record_function("unet"):
            return type(port).apply_unet(port, *args, **kwargs)
    port.apply_unet = unet
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            port_clip(port)
    finally:
        del port.apply_unet
    names = ("unet", "unet.xattn", "vae.encode", "unet.norm", "unet.spatial", "unet.temporal")
    spans = []
    for e in prof.events():
        if e.name in names:
            up, parent = [], e.cpu_parent
            while parent is not None:
                up.append(parent.name)
                parent = parent.cpu_parent
            spans.append((e.name, up))
    count = Counter(name for name, _ in spans)
    spatial = sum(isinstance(m, SpatialTransformer) for m in port.unet.modules())
    assert count["unet"] == STEPS and count["unet.xattn"] == STEPS * spatial
    assert count["vae.encode"] == 1
    for name, up in spans:
        if name == "unet.xattn":
            assert up[0] == "unet.spatial" and "unet" in up
        if name == "unet.norm":
            assert "unet.xattn" not in up
        if name == "vae.encode":
            assert not any(a.startswith("unet") for a in up)
