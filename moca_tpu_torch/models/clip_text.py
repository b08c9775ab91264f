"""OpenCLIP ViT-H/14 text tower: penultimate-layer conditioning features
and the pooled text embedding.

Port of moca_tpu/models/clip_text.py. The conditioning path: tokens
[B, 77] -> [B, 77, width], stopping one resblock early and applying ln_final
(condition.py:213-231). With `full=True` the tower also holds its last block
and `text_projection`, and `output="embed"` gives the pooled, projected
embedding [B, width] of the similarity metrics (eval/metrics.py CASS): the
whole tower, ln_final, the EOT token (the largest id) and the projection.
Module names follow the upstream checkpoint
(`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`, ...). The
self-attention is plain torch with an fp32 softmax; it is XLA in the
reference too. `ResidualAttentionBlock` without a mask is also the block of
the vision tower (models/clip_vision.py).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.ops.norms import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    penultimate: bool = True  # condition.py:199-203 (layer_idx=1)


class _MultiheadAttention(nn.Module):
    """MHA with torch.nn.MultiheadAttention's parameter names; `mask` is an
    additive logits bias (the text tower's causal mask) or None."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask):
        b, s, w = x.shape
        d = w // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, self.heads, d) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
        probs = torch.softmax(logits if mask is None else logits + mask, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return self.out_proj(out.reshape(b, s, w))


class ResidualAttentionBlock(nn.Module):
    """ln_1 -> causal MHA -> ln_2 -> MLP (x4, exact GELU)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = _MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm32(width)
        self.mlp = nn.Sequential(collections.OrderedDict(
            c_fc=nn.Linear(width, 4 * width), gelu=nn.GELU(),
            c_proj=nn.Linear(4 * width, width)))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """`layers` blocks under the upstream name `resblocks` (OpenCLIP's
    `transformer`); `cfg` has `width` and `heads`."""

    def __init__(self, cfg, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """tokens [B, 77] int -> [B, 77, width] penultimate-layer features, or
    with `output="embed"` (a `full` tower) the pooled embedding [B, width]."""

    def __init__(self, cfg: CLIPTextConfig, full: bool = False):
        super().__init__()
        self.cfg, self.full = cfg, full
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = Transformer(
            cfg, cfg.layers - (1 if cfg.penultimate and not full else 0))
        self.ln_final = LayerNorm32(cfg.width)
        if full:
            self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.width))

    def forward(self, tokens, output: str = "penultimate"):
        embed = output == "embed"
        if embed and not self.full:
            raise ValueError("output='embed' needs the full tower: CLIPTextEncoder(cfg, full=True)")
        x = self.token_embedding(tokens) + self.positional_embedding
        s = tokens.shape[1]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        blocks = self.transformer.resblocks
        if self.cfg.penultimate and not embed and self.full:
            blocks = blocks[:-1]
        for block in blocks:
            x = block(x, mask)
        x = self.ln_final(x)  # applied in penultimate mode too (condition.py:211-218)
        if not embed:
            return x
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection.to(pooled.dtype)
