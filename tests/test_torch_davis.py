"""The port's real-video (DAVIS) path against the JAX package's.

The VAE encoder's moments, `encode_frames` (posterior draw replayed from the
JAX key) and `encode_frame_moments`; the DAVIS anchor of `shift_queue` and
the pipeline in DAVIS mode (encoded frames, masks, the re-drawn last-frame
anchor) at T0=6 source frames for f=4; and the host IO it reads its inputs
with (`load_davis_data`, `load_conditioning_image`, prompts, video files),
on the same files. fp32 on the CPU; tolerances are stated per test.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_io_loaders import davis_root  # noqa: F401  (fixture)
from test_models import randomize_zero_params
from test_torch_sampling import (  # noqa: F401  (one_torch_thread: fixture)
    JaxReplayNormal, _rand, _t, one_torch_thread, pipeline_keys)
from test_torch_slice import CLIP, UNET, VAE, F, H, N, NEW, W

from moca_tpu.io import davis as jdavis
from moca_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from moca_tpu.models.convert import convert_clip, convert_unet, convert_vae
from moca_tpu.models.latent_diffusion import LatentDiffusion as JLatentDiffusion
from moca_tpu.models.unet3d import UNetConfig as JUNetConfig
from moca_tpu.io import prompts as jprompts
from moca_tpu.io import video as jvideo
from moca_tpu.models import vae as jvae
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu.sampling import fifo as jfifo
from moca_tpu.utils import distributions as jdist
from moca_tpu_torch.io import davis as tdavis
from moca_tpu_torch.io import prompts as tprompts
from moca_tpu_torch.io import video as tvideo
from moca_tpu_torch.models import vae as tvae
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.convert import vae_from_jax
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.ops.norms import GroupNorm32
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.sampling import fifo as tfifo
from moca_tpu_torch.utils import distributions as tdist

T0 = 6  # DAVIS source frames: more than f, as a real clip
# uint8 -> [-1, 1]: the port's numpy formula and the JAX package's native
# conversion differ by one fp32 ulp at 1.0 (observed 1.19e-7); bound 10x.
U8_ULP = 1.2e-6


def carry_to_jax(tmodel):
    """The JAX package's LatentDiffusion with the port model's weights, through
    its own checkpoint converter (the port carries the upstream key names)."""
    sd = lambda m: {k: v.detach() for k, v in m.state_dict().items()}
    ucfg, vcfg, ccfg = tmodel.unet_cfg, tmodel.vae_cfg, tmodel.clip_cfg
    return JLatentDiffusion(
        JUNetConfig(**dataclasses.asdict(ucfg)), jvae.VAEConfig(**dataclasses.asdict(vcfg)),
        JCLIPConfig(**dataclasses.asdict(ccfg)),
        convert_unet(sd(tmodel.unet), ucfg, prefix=""),
        convert_vae(sd(tmodel.vae), vcfg, prefix=""),
        convert_clip(sd(tmodel.clip), ccfg, prefix=""), scale_factor=tmodel.scale_factor)


def seed_weights(model, seed: int):
    """Weights from a seed: matrices N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), biases and other vectors N(0, 0.1^2). No layer is zero,
    so the U-Net is no identity."""
    model.eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        noise = torch.randn(p.shape, generator=gen)
        p.copy_(noise / math.sqrt(p[0].numel()) if p.ndim >= 2 else 0.1 * noise)
    for m in model.modules():
        if isinstance(m, (GroupNorm32, torch.nn.LayerNorm)):
            m.weight.add_(1.0)
    return model


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model): the tiny config of test_torch_slice, weights
    from a seed, carried to the JAX package."""
    tmodel = seed_weights(LatentDiffusion(UNetConfig(**UNET), tvae.VAEConfig(**VAE),
                                          CLIPTextConfig(**CLIP)), 0)
    return carry_to_jax(tmodel), tmodel


def _frames(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, H, W, 3)).astype(np.float32)


def test_distributions_match_jax():
    """The posterior's sample (the noise replayed from the key), mode, KL to
    the standard normal and to another Gaussian, and NLL, with logvar
    clamped to [-30, 20] (the inputs reach past both ends). Observed 2.1e-7
    relative to each result's max; bound 2e-6 of it."""
    mean, other = _rand((2, 3, 4, 4), 10), _rand((2, 3, 4, 4), 11)
    logvar, o_logvar = 12.0 * _rand((2, 3, 4, 4), 12), _rand((2, 3, 4, 4), 13)
    x = _rand((2, 3, 4, 4), 14)
    key = jax.random.PRNGKey(15)
    j = lambda a: jnp.asarray(a)
    pairs = [
        (tdist.sample(_t(mean), _t(logvar), JaxReplayNormal(lambda tag: key), ("s",)),
         jdist.sample(j(mean), j(logvar), key)),
        (tdist.mode(_t(mean), _t(logvar)), jdist.mode(j(mean), j(logvar))),
        (tdist.kl(_t(mean), _t(logvar)), jdist.kl(j(mean), j(logvar))),
        (tdist.kl(_t(mean), _t(logvar), (_t(other), _t(o_logvar))),
         jdist.kl(j(mean), j(logvar), (j(other), j(o_logvar)))),
        (tdist.nll(_t(mean), _t(logvar), _t(x)), jdist.nll(j(mean), j(logvar), j(x))),
    ]
    for p, r in pairs:
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=2e-6 * np.abs(r).max())


@pytest.mark.parametrize("attn_resolutions", [(), (16,)])
def test_vae_encode_moments_matches_jax(attn_resolutions):
    """Encoder + quant_conv with the asymmetric-pad downsample (and level
    attention); logvar clamped. Observed 3.2e-6 of O(1) moments; bound 2e-5."""
    kw = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=32,
              attn_resolutions=attn_resolutions)
    jcfg, tcfg = jvae.VAEConfig(**kw), tvae.VAEConfig(**kw)
    jmodel = jvae.AutoencoderKL(jcfg)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, randomize_zero_params(params))
    x = _rand((3, 32, 32, 3), 5)
    ref = jax.jit(functools.partial(jmodel.apply, method=jmodel.encode_moments))(
        params, jnp.asarray(x))
    model = tvae.AutoencoderKL(tcfg).eval()
    model.load_state_dict(vae_from_jax(params, tcfg), strict=True)
    with torch.no_grad():
        out = model.encode_moments(torch.from_numpy(x))
    for o, r in zip(out, ref):
        assert o.shape == (3, 4, 4, 4)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)
    # the mean without a noise source; the sample with one
    with torch.no_grad():
        np.testing.assert_array_equal(model.encode(torch.from_numpy(x)).numpy(),
                                      out[0].numpy())


def test_encode_frames_matches_jax(models):
    """encode_frames over more frames than one encoder chunk (the posterior
    drawn once, as ("encode",)), and encode_frame_moments. Observed 5.7e-7 on
    latents of magnitude ~1; bound 5e-6."""
    jmodel, tmodel = models
    frames = np.stack([_frames(5, 20), _frames(5, 21)])  # B=2, T=5: 10 frames, two chunks
    key = jax.random.PRNGKey(22)
    ref = jmodel.encode_frames(jnp.asarray(frames), rng=key)
    normal = JaxReplayNormal(lambda tag: key)
    port = tmodel.encode_frames(frames, normal)
    assert normal.tags == [("encode",)] and port.shape == (2, 5, H // 8, W // 8, 4)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=5e-6)
    mean = tmodel.encode_frames(frames)  # no noise source: the posterior mean
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmodel.encode_frames(
        jnp.asarray(frames), sample=False)), atol=5e-6)
    ref_m = jmodel.encode_frame_moments(jnp.asarray(frames[0, -2:]))
    port_m = tmodel.encode_frame_moments(frames[0, -2:])
    for p, r in zip(port_m, ref_m):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=5e-6)


@pytest.mark.parametrize("filter_type", ["gaussian", "butterworth", "ideal", "box"])
def test_shift_queue_anchor_matches(filter_type):
    """The DAVIS tail: low frequencies of a given anchor, not of slot 0.
    Observed 6e-7 on values up to ~3; bound 5e-6."""
    latents, anchor = _rand((1, 6, 4, 6, 4), 23), _rand((1, 4, 6, 4), 24)
    key = jax.random.PRNGKey(25)
    ref = jfifo.shift_queue(jnp.asarray(latents), key, anchor=jnp.asarray(anchor),
                            filter_type=filter_type)
    port = tfifo.shift_queue(_t(latents), JaxReplayNormal(lambda tag: key), ("s",),
                             anchor=_t(anchor), filter_type=filter_type)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=5e-6)


def _davis_inputs():
    h, w = H // 8, W // 8
    frames = _frames(T0, 30)
    masks = np.zeros((T0, h, w), np.float32)
    for t in range(T0):  # a moving rectangle, empty on frame 2
        if t != 2:
            masks[t, 1:3, t % 2: t % 2 + 2] = 1.0
    cond = np.random.default_rng(31).standard_normal((h, w, 4)).astype(np.float32)
    return frames, masks, cond


def test_davis_pipeline_matches_jax(models):
    """DAVIS mode frame by frame, as the JAX CLI drives it: encode the clip
    with the CLI's key_enc, run the pipeline on the encoded latents, the
    masks and the frames (the last one anchors every tail shift). Observed
    1.8e-5 on frames in [-1, 1]; bound 1.5e-4 (the encoded latents: as
    test_encode_frames_matches_jax)."""
    jmodel, tmodel = models
    kw = dict(video_length=F, num_partitions=N, new_video_length=NEW, guidance_scale=7.5)
    jpipe = JPipeline(jmodel, JHashTokenizer(), **kw)
    tpipe = MoCAVideoPipeline(tmodel, HashTokenizer(), **kw)
    frames, masks, cond = _davis_inputs()
    key_enc, key_run = jax.random.split(jax.random.PRNGKey(32))
    jclean = jmodel.encode_frames(jnp.asarray(frames)[None], rng=key_enc)
    ref = jpipe("object bear cat.", key_run, cond_image=cond, gamma=0.7, height=H, width=W,
                clean_latents=jclean, masks=masks, davis_frames=jnp.asarray(frames))

    steps = F * N
    total = NEW + steps - F
    normal = JaxReplayNormal(pipeline_keys(key_run, steps, total, jpipe.plan.num_windows, F,
                                           encode_key=key_enc))
    tclean = tmodel.encode_frames(frames[None], normal)
    np.testing.assert_allclose(tclean.numpy(), np.asarray(jclean), atol=5e-6)
    port = tpipe("object bear cat.", normal=normal, cond_image=cond, gamma=0.7, height=H,
                 width=W, clean_latents=tclean, masks=masks, davis_frames=frames)
    assert not any(t[0] == "base" for t in normal.tags)  # the base sample is skipped
    assert sum(t[-1:] == ("anchor",) for t in normal.tags) == total
    assert len(port) == len(ref) == total
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == (H, W, 3) and np.isfinite(p).all()
        np.testing.assert_allclose(p, np.asarray(r), atol=1.5e-4, err_msg=f"frame {i}")
    assert np.abs(np.asarray(ref[0]) - np.asarray(ref[-1])).max() > 1e-2


@pytest.mark.parametrize("strategy", ["first", "uniform", "random"])
def test_load_davis_data_matches_jax(davis_root, strategy):  # noqa: F811
    """The same frames (cv2 Lanczos4) and masks (PIL nearest) from the same
    files. The masks bit for bit; the frames to U8_ULP (the JAX package
    converts with its native extension when built)."""
    kw = dict(video_size=(4, 8), video_frames=4, sampling_strategy=strategy, seed=3)
    ref = jdavis.load_davis_data("bear", davis_root, **kw)
    port = tdavis.load_davis_data("bear", davis_root, **kw)
    assert port[0].dtype == port[1].dtype == np.float32
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=U8_ULP)
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[0].shape == (4, 32, 64, 3) and port[1].sum() > 0


def test_davis_prompt_and_prompt_csv_match_jax(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text('bear 1 "a bear walking"\ncat 2 "a cat"\n')
    for name in ("bear", "dog"):
        for path in (str(ann), str(tmp_path / "none.txt")):
            assert tdavis.get_davis_prompt(name, path) == jdavis.get_davis_prompt(name, path)
    assert tprompts.load_prompts("prompts/prompts.csv") == jprompts.load_prompts(
        "prompts/prompts.csv")
    assert tprompts.load_prompts("prompts/prompts.csv", 1) == jprompts.load_prompts(
        "prompts/prompts.csv", 1)
    with pytest.raises(ValueError):
        tprompts.load_prompts("prompts/prompts.csv", 10_000)


def test_video_io_matches_jax(tmp_path):
    """The uint8 conversions, the concept image at latent size, and an mp4
    written by the port and read back by both packages."""
    rng = np.random.default_rng(40)
    x = rng.uniform(-1.2, 1.2, (16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvideo.tensor_to_uint8(x), jvideo.tensor_to_uint8(x))
    u8 = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    np.testing.assert_allclose(tvideo.uint8_to_tensor(u8), jvideo.uint8_to_tensor(u8),
                               rtol=0, atol=U8_ULP)
    img = tmp_path / "concept.png"
    Image.fromarray(rng.integers(0, 255, (100, 80, 3), np.uint8)).save(img)
    np.testing.assert_array_equal(tvideo.load_conditioning_image(str(img), (40, 64)),
                                  jvideo.load_conditioning_image(str(img), (40, 64)))
    clip = [rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32) for _ in range(3)]
    tvideo.save_video(clip, str(tmp_path / "clip.mp4"), fps=5)
    tvideo.save_video(clip, str(tmp_path / "clip.gif"), fps=5)
    assert (tmp_path / "clip.gif").stat().st_size > 0
    kw = dict(size=(16, 24), num_frames=5)
    port = tvideo.load_video_frames(str(tmp_path / "clip.mp4"), **kw)
    np.testing.assert_allclose(port, jvideo.load_video_frames(str(tmp_path / "clip.mp4"), **kw),
                               rtol=0, atol=U8_ULP)
    assert port.shape == (5, 16, 24, 3)  # 3 frames, padded with the last
