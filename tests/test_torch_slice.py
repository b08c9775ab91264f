"""The port's MoCA main path end to end against the JAX package's.

One tiny random-weight model (the JAX package's own init, zero-initialised
last layers randomised) runs through moca_tpu's MoCAVideoPipeline and,
weights carried across with `*_from_jax`, through moca_tpu_torch's, with the
port's noise replayed from the JAX key layout: prompt encoding with a
conditioned prompt, base DDIM, the FIFO queue with lookahead, momentum,
mask injection with a concept image, the gamma blend, the FreeInit tail
shift and the batched head decode with its padded final flush. Every
decoded frame is compared in fp32.
"""

import jax
import numpy as np
import pytest
from test_models import randomize_zero_params
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401

from moca_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from moca_tpu.models.latent_diffusion import init_random_model as jinit
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.models.unet3d import UNetConfig as JUNetConfig
from moca_tpu.models.vae import VAEConfig as JVAEConfig
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.convert import clip_from_jax, unet_from_jax, vae_from_jax
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

H = W = 32  # latent 4x4
F, N, NEW = 4, 2, 2
# the tiny config of .claude/skills/verify/SKILL.md
UNET = dict(model_channels=32, num_head_channels=8, context_dim=16, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_res_blocks=1, temporal_length=F)
VAE = dict(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=H)
CLIP = dict(width=16, heads=2, layers=2)
# Frames lie in [-1, 1]; the two packages differ only in fp32 summation
# order, carried through 8 base steps, 6 FIFO iterations at guidance 7.5
# and the decoder (observed ~1.6e-5; the bound keeps a 10x margin).
FRAME_ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jinit(JUNetConfig(**UNET), JVAEConfig(**VAE), JCLIPConfig(**CLIP),
                   jax.random.PRNGKey(0), latent_hw=(H // 8, W // 8), frames=F)
    jmodel.unet_params = randomize_zero_params(jmodel.unet_params)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    ucfg, vcfg, ccfg = UNetConfig(**UNET), VAEConfig(**VAE), CLIPTextConfig(**CLIP)
    tmodel = LatentDiffusion(ucfg, vcfg, ccfg).eval()
    tmodel.unet.load_state_dict(unet_from_jax(np_tree(jmodel.unet_params), ucfg))
    tmodel.vae.load_state_dict(vae_from_jax(np_tree(jmodel.vae_params), vcfg))
    tmodel.clip.load_state_dict(clip_from_jax(np_tree(jmodel.clip_params), ccfg))
    return jmodel, tmodel


@pytest.mark.parametrize("with_masks", [True, False])
def test_moca_pipeline_matches_jax(models, with_masks):
    jmodel, tmodel = models
    kw = dict(video_length=F, num_partitions=N, new_video_length=NEW, guidance_scale=7.5)
    jpipe, tpipe = JPipeline(jmodel, JHashTokenizer(), **kw), \
        MoCAVideoPipeline(tmodel, HashTokenizer(), **kw)
    cond = np.random.default_rng(1).standard_normal((H // 8, W // 8, 4)).astype(np.float32)
    masks = None
    if with_masks:
        masks = np.zeros((F, H // 8, W // 8), np.float32)
        masks[:, 1:3, 1:4] = 1.0
    call = dict(cond_image=cond, conditioned_prompt="a dog", gamma=0.7, height=H, width=W,
                masks=masks)
    key = jax.random.PRNGKey(5)
    ref = jpipe("a cat surfing", key, **call)

    steps = F * N
    total = NEW + steps - F
    normal = JaxReplayNormal(pipeline_keys(key, steps, total, jpipe.plan.num_windows, F))
    port = tpipe("a cat surfing", normal=normal, **call)

    assert len(port) == len(ref) == total
    assert set(tpipe.timings) == {"encode", "base_sample", "queue", "fifo_iteration",
                                  "decode"}
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == (H, W, 3) and np.isfinite(p).all()
        np.testing.assert_allclose(p, np.asarray(r), atol=FRAME_ATOL, err_msg=f"frame {i}")
    # the comparison is not vacuous: frames differ from one another
    assert np.abs(np.asarray(ref[0]) - np.asarray(ref[-1])).max() > 1e-2
