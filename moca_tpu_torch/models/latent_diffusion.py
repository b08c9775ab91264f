"""LatentDiffusion bundle: U-Net + VAE decoder + CLIP text encoder.

Port of the crossattn path of moca_tpu/models/latent_diffusion.py: the
three towers as `nn.Module`s on one device, with `apply_unet`,
`encode_tokens` and `decode_single`. Video tensors are channels-last
[B, T, H, W, C].
"""

from __future__ import annotations

import torch
from torch import nn

from moca_tpu_torch import resolve_device
from moca_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig
from moca_tpu_torch.models.vae import AutoencoderKL, VAEConfig


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

    def apply_unet(self, x, t_frames, context, fps=16):
        """eps prediction; x [B,T,h,w,C], t_frames [B,T], context [B,L,D]."""
        return self.unet(x, t_frames, context, fps=fps)

    def encode_tokens(self, tokens) -> torch.Tensor:
        """[B, 77] int -> [B, 77, width] float32."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.clip(tokens).float()

    def decode_single(self, z_frame) -> torch.Tensor:
        """[B, h, w, 4] scaled latents -> [B, H, W, 3] float32 (the per-output-
        frame head decode of the FIFO loop, funcs.py:358-360)."""
        return self.vae.decode(z_frame / self.scale_factor).float()


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
    with torch.no_grad():
        for p in model.parameters():
            noise = torch.randn(p.shape, generator=generator, device=device,
                                dtype=torch.float32)
            p.copy_(noise * 0.02)
    return model
