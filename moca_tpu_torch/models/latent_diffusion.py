"""LatentDiffusion bundle: U-Net + VAE + CLIP text encoder.

Port of moca_tpu/models/latent_diffusion.py: the three towers as
`nn.Module`s on one device, with `apply_unet`, `apply_model` (the
DiffusionWrapper's 12 conditioning keys), `count_params`, `encode_tokens`,
`encode_frames`, `encode_frame_moments`, `decode_latents` and
`decode_single`; and the i2v model, `LatentVisualDiffusion`, which adds the
CLIP vision tower and the image projector (`get_image_embeds`). Video
tensors are channels-last [B, T, H, W, C].
"""

from __future__ import annotations

import torch
from torch import nn

from moca_tpu_torch import resolve_device
from moca_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from moca_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from moca_tpu_torch.models.ip_resampler import ImageProjModel, Resampler
from moca_tpu_torch.models.unet3d import FRAME_IMAGE_TOKENS, UNet3D, UNetConfig
from moca_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from moca_tpu_torch.utils import distributions

VAE_CHUNK = 8  # frames per VAE call in encode_frames and decode_latents


class LatentDiffusion(nn.Module):
    def __init__(self, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                 clip_cfg: CLIPTextConfig, scale_factor: float = 0.18215):
        super().__init__()
        self.unet_cfg, self.vae_cfg, self.clip_cfg = unet_cfg, vae_cfg, clip_cfg
        self.scale_factor = scale_factor  # ddpm3d.py scale_factor (yaml:17)
        self.unet = UNet3D(unet_cfg)
        self.vae = AutoencoderKL(vae_cfg)
        self.clip = CLIPTextEncoder(clip_cfg)

    @property
    def device(self) -> torch.device:
        return self.unet.time_embed[0].weight.device

    def apply_unet(self, x, t_frames, context, fps=16, c_concat=None,
                   no_temporal_attn: bool = False):
        """eps prediction; x [B,T,h,w,C], t_frames [B,T], context [B,L,D].
        c_concat [B,T,h,w,Cc] is concatenated on the channel axis (the
        concat/hybrid modes; the U-Net is built with matching in_channels);
        no_temporal_attn skips the temporal transformers."""
        if c_concat is not None:
            x = torch.cat([x, c_concat], dim=-1)
        return self.unet(x, t_frames, context, fps=fps, no_temporal_attn=no_temporal_attn)

    def apply_model(self, x, t_frames, c_concat=None, c_crossattn=None,
                    conditioning_key="crossattn", fps=16, c_adm=None, s=None, mask=None,
                    **kwargs):
        """DiffusionWrapper.forward's dispatch over all 12 conditioning keys
        (ddpm3d.py:696-763; moca_tpu/models/latent_diffusion.py:83-182).

        `c_concat` and `c_crossattn` are lists: the first is concatenated on
        the channel axis (last here), the second on the token axis. None is
        the unconditional U-Net; 'concat' channel-concat with no context
        (the spatial cross-attention self-attends; such a U-Net is built with
        context_dim=None); 'crossattn' the shipped mode; 'hybrid' both;
        'resblockcond' the first context only. The seven y/s/mask modes wire
        their concat and context the same way and drop y, s and mask, as the
        reference U-Net's **kwargs does; their argument checks are the
        reference's asserts, raised explicitly. As in the reference, `fps`
        and the other kwargs reach the U-Net only for 'concat' and
        'crossattn': every other mode embeds the default fps=16."""
        key = conditioning_key

        def cat_x():
            return torch.cat([x] + list(c_concat), dim=-1)

        def cat_x_opt():  # concat-adm-mask and hybrid-adm-mask take c_concat=None
            return x if c_concat is None else cat_x()

        def cat_c():
            return torch.cat(list(c_crossattn), dim=1)

        def unet(xin, ctx, fwd_kwargs=False):
            if fwd_kwargs:
                return self.unet(xin, t_frames, ctx, fps=fps, **kwargs)
            return self.unet(xin, t_frames, ctx)

        if key is None:
            return unet(x, None)
        if key == "concat":
            return unet(cat_x(), None, fwd_kwargs=True)
        if key == "crossattn":
            return unet(x, cat_c(), fwd_kwargs=True)
        if key == "hybrid":
            return unet(cat_x(), cat_c())
        if key == "resblockcond":
            return unet(x, c_crossattn[0])
        if key == "adm":  # y = c_crossattn[0], dropped
            if c_crossattn is None:
                raise TypeError("conditioning_key 'adm' takes y from c_crossattn[0]")
            return unet(x, None)
        if key in ("hybrid-adm", "hybrid-time-adm", "hybrid-time"):
            needed = "s" if key == "hybrid-time" else "c_adm"
            if (s if key == "hybrid-time" else c_adm) is None:
                raise AssertionError(f"conditioning_key '{key}' needs {needed}")
            return unet(cat_x(), cat_c())
        if key == "concat-time-mask":
            return unet(cat_x(), None)
        if key == "concat-adm-mask":
            return unet(cat_x_opt(), None)
        if key == "hybrid-adm-mask":
            return unet(cat_x_opt(), cat_c())
        raise NotImplementedError(f"unknown conditioning_key '{key}'")

    def count_params(self) -> dict:
        """Parameter counts per tower (utils/utils.py:8 count_params)."""
        count = lambda m: sum(p.numel() for p in m.parameters())
        return {"unet": count(self.unet), "vae": count(self.vae), "clip": count(self.clip)}

    def encode_tokens(self, tokens) -> torch.Tensor:
        """[B, 77] int -> [B, 77, width] float32."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.clip(tokens).float()

    @torch.inference_mode()
    def encode_frame_moments(self, frames):
        """[N, H, W, 3] in [-1, 1] -> (mean, std) float32 of the scaled-latent
        posterior [N, h, w, 4]. The DAVIS anchor is re-encoded with a fresh
        posterior sample on every FIFO shift (funcs.py:101-114); the encoder
        is deterministic, so `mean + std * eps` per shift from these moments
        is the same draw at one encoder pass."""
        frames = torch.as_tensor(frames, device=self.device)
        mean, logvar = self._moments(frames)
        return self.scale_factor * mean, self.scale_factor * torch.exp(0.5 * logvar)

    @torch.inference_mode()
    def encode_frames(self, frames, normal=None, tag: tuple = ("encode",)) -> torch.Tensor:
        """[B, T, H, W, 3] in [-1, 1] -> latents [B, T, h, w, 4] float32 times
        scale_factor (encode_first_stage_2DAE, ddpm3d.py:485-490, batched).
        The posterior sample is one draw `tag` over all B*T frames, made after
        every moment is computed, so the chunking leaves it unchanged; with
        no `normal` the posterior mean."""
        frames = torch.as_tensor(frames, device=self.device)
        b, t = frames.shape[:2]
        mean, logvar = self._moments(frames.reshape((b * t,) + tuple(frames.shape[2:])))
        z = mean if normal is None else distributions.sample(mean, logvar, normal, tag)
        return self.scale_factor * z.reshape((b, t) + tuple(z.shape[1:]))

    def _moments(self, frames, chunk: int = VAE_CHUNK):
        """Encoder moments in float32, over chunks of `chunk` frames: the
        encoder's fp32 norm activations grow with the frames of one call."""
        parts = [self.vae.encode_moments(frames[i:i + chunk])
                 for i in range(0, frames.shape[0], chunk)]
        return (torch.cat([m for m, _ in parts]).float(),
                torch.cat([lv for _, lv in parts]).float())

    def decode_latents(self, z, chunk: int = VAE_CHUNK) -> torch.Tensor:
        """[B, T, h, w, 4] scaled latents -> frames [B, T, H, W, 3] float32
        (decode_first_stage_2DAE, ddpm3d.py:556-562), `chunk` frames a
        decoder call: the decoder works frame by frame, and its fp32 norm
        activations grow with the frames of one call."""
        b, t = z.shape[:2]
        flat = z.reshape((b * t,) + tuple(z.shape[2:]))
        x = torch.cat([self.decode_single(flat[i:i + chunk])
                       for i in range(0, flat.shape[0], chunk)])
        return x.reshape((b, t) + tuple(x.shape[1:]))

    def decode_single(self, z_frame) -> torch.Tensor:
        """[B, h, w, 4] scaled latents -> [B, H, W, 3] float32 (the per-output-
        frame head decode of the FIFO loop, funcs.py:358-360)."""
        return self.vae.decode(z_frame / self.scale_factor).float()


class LatentVisualDiffusion(LatentDiffusion):
    """The i2v model (ddpm3d.py:660-694): LatentDiffusion plus a frozen CLIP
    vision tower (`vision`, checkpoint `embedder.model.visual.*`) and an
    IP-Adapter projector (`image_proj`, checkpoint `image_proj_model.*`).
    Image tokens are appended to the text context on the token axis; the
    U-Net's image cross-attention (use_image_attention) splits them back out.

    `finegrained`: the Resampler on the tower's tokens, else ImageProjModel
    on its pooled embedding. The projector's sizes follow the configs, as in
    the JAX package (the reference hardcodes the shipped towers' 1024/1280).
    The tower and the projector compute in fp32 whatever the other towers'
    type (`keep_image_towers_fp32`), as the reference builds them.

    `image_video_length` (DynamiCrafter): the Resampler's 16 queries for each
    of that many frames, so that each frame's image cross-attention reads
    its own 16 tokens (`UNet3D`'s per-frame context)."""

    def __init__(self, unet_cfg: UNetConfig, vae_cfg: VAEConfig, clip_cfg: CLIPTextConfig,
                 vision_cfg: CLIPVisionConfig, finegrained: bool = False,
                 scale_factor: float = 0.18215, image_video_length: int | None = None):
        super().__init__(unet_cfg, vae_cfg, clip_cfg, scale_factor)
        self.vision_cfg, self.finegrained = vision_cfg, finegrained
        self.vision = CLIPVisionEncoder(vision_cfg)
        if image_video_length and not finegrained:
            raise ValueError("per-frame image tokens come from the finegrained Resampler")
        if finegrained:
            self.image_proj = Resampler(dim=vision_cfg.output_dim, depth=4, dim_head=64, heads=12,
                                        num_queries=FRAME_IMAGE_TOKENS,
                                        embedding_dim=vision_cfg.width,
                                        output_dim=unet_cfg.context_dim,
                                        video_length=image_video_length)
        else:
            self.image_proj = ImageProjModel(cross_attention_dim=unet_cfg.context_dim,
                                             clip_embeddings_dim=vision_cfg.output_dim,
                                             clip_extra_context_tokens=4)

    def keep_image_towers_fp32(self) -> "LatentVisualDiffusion":
        """Back to fp32 for the vision tower and the projector after a
        model-wide cast (the reference's fp32 embedder and projector)."""
        self.vision.float()
        self.image_proj.float()
        return self

    @torch.inference_mode()
    def get_image_embeds(self, images) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> [B, N, context_dim] float32
        cross-attention tokens (ddpm3d.py:689-694)."""
        feats = self.vision(images, output="tokens" if self.finegrained else "pooled")
        return self.image_proj(feats).float()


def _fill_random(model: nn.Module, generator, device) -> None:
    with torch.no_grad():
        for p in model.parameters():
            noise = torch.randn(p.shape, generator=generator, device=device,
                                dtype=torch.float32)
            p.copy_(noise * 0.02)


def init_random_model(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                      clip_cfg: CLIPTextConfig, generator: torch.Generator | None = None,
                      device=None, dtype: torch.dtype = torch.float32) -> LatentDiffusion:
    """Random-weight model: every floating parameter ~ N(0, 0.02^2), as the
    reference benchmark fills its weights (bench.py:60-69). A fresh model with
    the reference's zero-initialised last layers would be the identity.

    Runs on `cuda` unless `device` says otherwise; the generator, if given,
    must live on that device (default: torch's default generator there)."""
    device = resolve_device(device)
    with torch.device(device):
        model = LatentDiffusion(unet_cfg, vae_cfg, clip_cfg)
    model.to(dtype).eval().requires_grad_(False)
    _fill_random(model, generator, device)
    return model


def init_random_visual_model(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                             clip_cfg: CLIPTextConfig, vision_cfg: CLIPVisionConfig,
                             generator: torch.Generator | None = None, device=None,
                             dtype: torch.dtype = torch.float32,
                             finegrained: bool = False) -> LatentVisualDiffusion:
    """Random-weight i2v model, filled as `init_random_model`: the U-Net, VAE
    and text tower in `dtype`, the vision tower and projector in fp32. Build
    the U-Net with use_image_attention=True so that the image tokens reach
    to_k_ip / to_v_ip."""
    device = resolve_device(device)
    with torch.device(device):
        model = LatentVisualDiffusion(unet_cfg, vae_cfg, clip_cfg, vision_cfg, finegrained)
    model.to(dtype).keep_image_towers_fp32().eval().requires_grad_(False)
    _fill_random(model, generator, device)
    return model
