"""OpenCLIP ViT-H/14 text tower, penultimate-layer conditioning features.

Port of moca_tpu/models/clip_text.py (conditioning path): tokens [B, 77] ->
[B, 77, width], stopping one resblock early and applying ln_final
(condition.py:213-231). Module names follow the upstream checkpoint
(`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`, ...). The
causal self-attention is plain torch with an fp32 softmax; it is XLA in the
reference too.
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
    """Causal MHA with torch.nn.MultiheadAttention's parameter names."""

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
        probs = torch.softmax(logits + mask, dim=-1)
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

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """tokens [B, 77] int -> [B, 77, width] penultimate-layer features."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg, cfg.layers - (1 if cfg.penultimate else 0))
        self.ln_final = LayerNorm32(cfg.width)

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding
        s = tokens.shape[1]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        return self.ln_final(x)
