"""OpenCLIP ViT-H/14 vision tower (the i2v model family and the CASS metric).

Port of moca_tpu/models/clip_vision.py, itself `FrozenOpenCLIPImageEmbedder`
/ `...V2` (lvdm/modules/encoders/condition.py:238-375): a bicubic 224 x 224
resize and the CLIP normalization, a patch-14 ViT of width 1280 and 32
layers; `pooled` is the projected class token (1024) for ImageProjModel and
the CASS frame embedding, `tokens` the whole token sequence (257 x 1280)
before `ln_post`, for the fine-grained Resampler (V2 drops the projection).

Module names are OpenCLIP's (`conv1`, `class_embedding`,
`positional_embedding`, `ln_pre`, `transformer.resblocks.{i}.{ln_1,
attn.in_proj_weight, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_post`,
`proj`), so `embedder.model.visual.*` of an i2v checkpoint and a bare
OpenCLIP visual state dict load straight in. The compute type is the
parameters' type; the i2v model keeps this tower in fp32. The attention
(S=257, d=80) is the plain fp32-softmax path, an inline einsum in the
reference as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.models.clip_text import Transformer
from moca_tpu_torch.ops.norms import LayerNorm32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    heads: int = 16
    layers: int = 32
    output_dim: int = 1024


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * (ax**3 - 5 * ax**2 + 8 * ax - 4), 0.0))


def bicubic_resize_weights(in_size: int, out_size: int, align_corners: bool = True,
                           antialias: bool = True) -> np.ndarray:
    """[out, in] 1-D resampling matrix with torch `F.interpolate`'s bicubic
    semantics; the reference's kornia resize (condition.py:266-269) calls the
    same kernel. A copy of the JAX package's numpy function.

    antialias=True: a=-0.5 kernel, width scaled by max(scale, 1), taps
    renormalized; centers at scale*(d+0.5)-0.5 with the align_corners scale.
    antialias=False: the classic 4-tap a=-0.75 with border-clamped taps."""
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    else:
        scale = in_size / out_size
    d = np.arange(out_size)
    if antialias:
        centers = scale * (d + 0.5) - 0.5
        inv = 1.0 / max(scale, 1.0)
        j = np.arange(in_size)
        w = _cubic((j[None] - centers[:, None]) * inv, -0.5)
        return (w / w.sum(-1, keepdims=True)).astype(np.float32)
    centers = scale * d if align_corners else scale * (d + 0.5) - 0.5
    W = np.zeros((out_size, in_size), np.float32)
    base = np.floor(centers).astype(int)
    for o in range(out_size):
        for k in range(-1, 3):
            idx = base[o] + k
            W[o, np.clip(idx, 0, in_size - 1)] += _cubic(np.float64(idx - centers[o]), -0.75)
    return W


def resize_bicubic(images: torch.Tensor, out_hw, align_corners: bool = True,
                   antialias: bool = True) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] float32: the separable bicubic
    resize as two products with the numpy weight matrices."""
    h, w = images.shape[1], images.shape[2]
    as_t = lambda a: torch.from_numpy(a).to(images.device)
    wh = as_t(bicubic_resize_weights(h, out_hw[0], align_corners, antialias))
    ww = as_t(bicubic_resize_weights(w, out_hw[1], align_corners, antialias))
    x = torch.einsum("oh,bhwc->bowc", wh, images.float())
    return torch.einsum("pw,bowc->bopc", ww, x)


def preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> CLIP-normalized [B, S, S, 3] float32
    (condition.py:264-272: kornia's bicubic resize with align_corners=True and
    antialias=True, then (x+1)/2 and the CLIP mean and std)."""
    x = resize_bicubic(images, (image_size, image_size), align_corners=True, antialias=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPVisionEncoder(nn.Module):
    """images [B, H, W, 3] in [-1, 1] -> pooled [B, output_dim] or tokens
    [B, 1 + (S/patch)^2, width]."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, cfg.width))
        self.ln_pre = LayerNorm32(cfg.width)
        self.transformer = Transformer(cfg, cfg.layers)
        self.ln_post = LayerNorm32(cfg.width)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.output_dim))

    def forward(self, images, output: str = "pooled"):
        dtype, device = self.proj.dtype, self.proj.device
        images = torch.as_tensor(images, device=device)
        x = preprocess(images, self.cfg.image_size).to(dtype)
        x = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [B, grid^2, width]
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        if output == "tokens":
            # V2: every token, no ln_post and no projection
            # (condition.py:330-375 encode_with_vision_transformer)
            return x
        return self.ln_post(x[:, 0]) @ self.proj.to(dtype)
