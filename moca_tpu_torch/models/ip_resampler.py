"""Image-prompt projectors of the i2v model family (LatentVisualDiffusion).

Port of moca_tpu/models/ip_resampler.py, the IP-Adapter projectors
(lvdm/modules/encoders/ip_resampler.py): `ImageProjModel` maps a pooled CLIP
image embedding to N cross-attention tokens; `Resampler` is the fine-grained
Perceiver over the vision tower's token sequence. Module names are the
upstream ones (`proj`, `norm`; `latents`, `proj_in`,
`layers.{i}.0.{norm1,norm2,to_q,to_kv,to_out}`, `layers.{i}.1.{0,1,3}`,
`proj_out`, `norm_out`), so `image_proj_model.*` of an i2v checkpoint loads
straight in. The compute type is the parameters' type (fp32 in the i2v
model). The Perceiver attention (Sq = 16 latents) is the plain fp32-softmax
path, XLA in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from moca_tpu_torch.ops.norms import LayerNorm32


class ImageProjModel(nn.Module):
    """pooled CLIP embed [B, D_clip] -> [B, N, D_cross] (ip_resampler.py:7-21)."""

    def __init__(self, cross_attention_dim: int = 1024, clip_embeddings_dim: int = 1024,
                 clip_extra_context_tokens: int = 4):
        super().__init__()
        self.tokens, self.dim = clip_extra_context_tokens, cross_attention_dim
        self.proj = nn.Linear(clip_embeddings_dim, clip_extra_context_tokens * cross_attention_dim)
        self.norm = LayerNorm32(cross_attention_dim)

    def forward(self, image_embeds):
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.tokens, self.dim))


class PerceiverAttention(nn.Module):
    """Latents attend to [image tokens ; latents] (ip_resampler.py:45-90), with
    the double square root scaling: logits = (q s)(k s)^T, s = d^-1/4."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        h, d = self.heads, self.dim_head
        x, latents = self.norm1(x), self.norm2(latents)
        b, n = latents.shape[:2]
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        heads_first = lambda t: t.reshape(b, t.shape[1], h, d).transpose(1, 2)
        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        scale = d ** -0.25
        logits = (q * scale).float() @ (k * scale).float().transpose(-2, -1)
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class Resampler(nn.Module):
    """Perceiver resampler (ip_resampler.py:93-135): tokens [B, L, E] ->
    [B, num_queries, output_dim]. With `video_length` (DynamiCrafter's
    resampler.py), num_queries queries for each of video_length frames,
    frame-major: [B, video_length * num_queries, output_dim], all of them
    attending together."""

    def __init__(self, dim: int = 1024, depth: int = 4, dim_head: int = 64, heads: int = 12,
                 num_queries: int = 16, embedding_dim: int = 1280, output_dim: int = 1024,
                 ff_mult: int = 4, video_length: int | None = None):
        super().__init__()
        queries = num_queries * (video_length or 1)
        self.latents = nn.Parameter(torch.randn(1, queries, dim) / dim**0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm32(output_dim)
        inner = dim * ff_mult
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads),
                           nn.Sequential(LayerNorm32(dim), nn.Linear(dim, inner, bias=False),
                                         nn.GELU(), nn.Linear(inner, dim, bias=False))])
            for _ in range(depth))

    def forward(self, x):
        dtype = self.proj_in.weight.dtype
        latents = self.latents.to(dtype).expand(x.shape[0], -1, -1)
        x = self.proj_in(x.to(dtype))
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))
