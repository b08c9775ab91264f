"""Plain PyTorch reference of the VideoCrafter networks, in float32.

A frozen copy of the arithmetic of the published modules (VideoCrafter's
`openaimodel3d.py`, `attention.py`, `ae_modules.py`, OpenCLIP's text and
vision towers, IP-Adapter's Resampler), written for the benchmark alone:
no hand-written kernel, no routing, every attention the textbook
softmax(q k^T / sqrt(d)) v, computed in blocks of rows so that the logits
fit. Parameter names are the upstream checkpoint's, so one state dict made
from the seed loads into these modules and into the measured program alike.

Precision. Every matrix product (linear, convolution, attention) reads its
operands through `Rounding`: the identity for the reference, or a rounding to
a lower type for the control (float8 e4m3 with a per-tensor scale, or
bfloat16). `set_rounding(module, rounding)` sets it on every layer.
Statistics, softmax and accumulation stay float32 in both.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
LOGITS_BUDGET = 1 << 28  # fp32 logits elements computed at once (1 GiB)


class Rounding:
    """How a product's operands are rounded: None (exact float32),
    "bfloat16", or "float8" (e4m3, scaled per tensor to its largest value)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "bfloat16", "float8"):
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return x
        if self.kind == "bfloat16":
            return x.to(torch.bfloat16).float()
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


EXACT = Rounding()


class Rounded:
    """Mixin: the layer's `rnd`, exact until `set_rounding` says otherwise."""

    rnd: Rounding = EXACT


def set_rounding(module: nn.Module, rounding: Rounding) -> None:
    for m in module.modules():
        if isinstance(m, Rounded):
            m.rnd = rounding


class Linear(nn.Linear, Rounded):
    def forward(self, x):
        return F.linear(self.rnd(x), self.rnd(self.weight), self.bias)


class Conv2d(nn.Conv2d, Rounded):
    """Conv2d on channels-last [N, H, W, C]."""

    def forward(self, x):
        y = F.conv2d(self.rnd(x.permute(0, 3, 1, 2)), self.rnd(self.weight), self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d, Rounded):
    """Conv3d on channels-last [N, T, H, W, C]."""

    def forward(self, x):
        y = F.conv3d(self.rnd(x.permute(0, 4, 1, 2, 3)), self.rnd(self.weight), self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 4, 1)


class Conv1x1(nn.Conv1d, Rounded):
    """A kernel-1 Conv1d applied to channels-last tokens (a linear map)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(self.rnd(x), self.rnd(self.weight[..., 0]), self.bias)


def attention(q, k, v, rnd: Rounding = EXACT, mask=None):
    """softmax(q k^T / sqrt(d) + mask) v on [B, S, H, D], float32, in blocks
    of the batch axis."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    step = max(1, LOGITS_BUDGET // max(1, sq * sk * h))
    out = []
    for i in range(0, b, step):
        qi, ki, vi = (rnd(t[i:i + step].float()) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, ki) / math.sqrt(d)
        if mask is not None:
            logits = logits + mask
        p = torch.softmax(logits, dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", rnd(p), vi))
    return torch.cat(out)


class Attending(nn.Module, Rounded):
    """A module whose attention products read their operands through `rnd`."""


class GroupNorm(nn.Module):
    """GroupNorm over channels-last input, statistics over every axis between
    N and C; gcd(C, 32) groups where 32 does not divide C."""

    def __init__(self, groups: int, ch: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.groups = groups if ch % groups == 0 else math.gcd(ch, groups)
        self.eps, self.silu = eps, silu
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        n, c = x.shape[0], x.shape[-1]
        g = x.float().reshape(n, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(g, dim=(1, 3), correction=0, keepdim=True)
        y = ((g - mean) / torch.sqrt(var + self.eps)).reshape(x.shape) * self.weight + self.bias
        return F.silu(y) if self.silu else y


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# U-Net (openaimodel3d.py, attention.py)
# ---------------------------------------------------------------------------

def norm_act_conv(ch, conv, dropout_slot):
    """(GroupNorm+SiLU, [Dropout,] conv) at the upstream Sequential indices."""
    mods = [GroupNorm(32, ch, silu=True), nn.Identity()]
    if dropout_slot:
        mods.append(nn.Identity())
    return nn.Sequential(*mods, conv)


class TemporalConvBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        conv = lambda: Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))
        self.conv1 = norm_act_conv(ch, conv(), False)
        self.conv2 = norm_act_conv(ch, conv(), True)
        self.conv3 = norm_act_conv(ch, conv(), True)
        self.conv4 = norm_act_conv(ch, conv(), True)

    def forward(self, x):
        return self.conv4(self.conv3(self.conv2(self.conv1(x)))) + x


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_dim):
        super().__init__()
        self.in_layers = norm_act_conv(cin, Conv2d(cin, cout, 3, padding=1), False)
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, cout))
        self.out_layers = norm_act_conv(cout, Conv2d(cout, cout, 3, padding=1), True)
        self.skip_connection = Conv2d(cin, cout, 1) if cin != cout else nn.Identity()
        self.temopral_conv = TemporalConvBlock(cout)

    def forward(self, x, emb, b):
        h = self.in_layers(x) + self.emb_layers(emb)[:, None, None, :]
        h = self.skip_connection(x) + self.out_layers(h)
        bt, hh, ww, c = h.shape
        return self.temopral_conv(h.reshape(b, bt // b, hh, ww, c)).reshape(bt, hh, ww, c)


TEXT_TOKENS = 77


class CrossAttention(Attending):
    def __init__(self, dim, heads, dim_head, ctx_dim=None, image=False):
        super().__init__()
        inner, ctx_dim = heads * dim_head, ctx_dim or dim
        self.heads, self.dim_head, self.image = heads, dim_head, image
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim))
        if image:
            self.to_k_ip = Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = Linear(ctx_dim, inner, bias=False)

    def forward(self, x, context=None):
        h, d = self.heads, self.dim_head
        ctx = x if context is None else context
        img = None
        if context is not None and self.image:
            ctx, img = ctx[:, :TEXT_TOKENS], ctx[:, TEXT_TOKENS:]
        split = lambda t: t.reshape(t.shape[0], t.shape[1], h, d)
        q = split(self.to_q(x))
        out = attention(q, split(self.to_k(ctx)), split(self.to_v(ctx)), self.rnd)
        if img is not None:
            out = out + attention(q, split(self.to_k_ip(img)), split(self.to_v_ip(img)),
                                  self.rnd)
        return self.to_out(out.reshape(x.shape[0], x.shape[1], h * d))


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = Linear(dim, dim * 8)
        self.net = nn.Sequential(geglu, nn.Identity(), Linear(dim * 4, dim))

    def forward(self, x):
        a, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](a * F.gelu(gate, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim, image=False):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, ctx_dim, image)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch, heads, dim_head, ctx_dim, image):
        super().__init__()
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = Linear(ch, heads * dim_head)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(heads * dim_head, heads, dim_head, ctx_dim, image)])
        self.proj_out = Linear(heads * dim_head, ch)

    def forward(self, x, context):
        bt, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(bt, hh * ww, c))
        h = self.transformer_blocks[0](h, context)
        return self.proj_out(h).reshape(bt, hh, ww, c) + x


class TemporalTransformer(nn.Module):
    """Self-attention over the T frames of each pixel (temporal_selfatt_only)."""

    def __init__(self, ch, heads, dim_head, linear=True):
        super().__init__()
        inner = heads * dim_head
        proj = Linear if linear else Conv1x1
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = proj(ch, inner)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(inner, heads, dim_head, None)])
        self.proj_out = proj(inner, ch)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, c))
        h = self.transformer_blocks[0](h)
        return self.proj_out(h).reshape(b, hh, ww, t, c).permute(0, 3, 1, 2, 4) + x


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


UNET_OPTIONS = {  # what this reference computes; a config asking otherwise is refused
    "use_linear": True, "temporal_conv": True, "tempspatial_aware": False,
    "temporal_attention": True, "temporal_selfatt_only": True,
    "use_relative_position": False, "use_causal_attention": False,
    "addition_attention": True, "fps_cond": True, "transformer_depth": 1,
    "temporal_transformer_depth": 1,
}


class UNet(nn.Module):
    """eps(x [B, T, h, w, Cin], t [B, T], context [B, L, D], fps)."""

    def __init__(self, c: dict):
        super().__init__()
        for key, want in UNET_OPTIONS.items():
            if c.get(key, want) != want:
                raise ValueError(f"the reference U-Net computes {key}={want}, not {c[key]}")
        mc, hc = c["model_channels"], c["num_head_channels"]
        ted, ctx, image = 4 * mc, c["context_dim"], c.get("use_image_attention", False)
        self.mc, self.out_ch = mc, c["out_channels"]
        self.time_embed = nn.Sequential(Linear(mc, ted), nn.SiLU(), Linear(ted, ted))
        self.fps_embedding = nn.Sequential(Linear(mc, ted), nn.SiLU(), Linear(ted, ted))

        def level_layers(cin, cout, ds):
            layers = [ResBlock(cin, cout, ted)]
            if ds in c["attention_resolutions"]:
                layers += [SpatialTransformer(cout, cout // hc, hc, ctx, image),
                           TemporalTransformer(cout, cout // hc, hc)]
            return layers

        blocks = [[Conv2d(c["in_channels"], mc, 3, padding=1)]]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(c["channel_mult"]):
            for _ in range(c["num_res_blocks"]):
                blocks.append(level_layers(ch, mult * mc, ds))
                ch = mult * mc
                chans.append(ch)
            if level != len(c["channel_mult"]) - 1:
                blocks.append([Downsample(ch)])
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(nn.ModuleList(b) for b in blocks)
        self.init_attn = nn.ModuleList([TemporalTransformer(mc, 8, hc, linear=False)])
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted), SpatialTransformer(ch, ch // hc, hc, ctx, image),
            TemporalTransformer(ch, ch // hc, hc), ResBlock(ch, ch, ted)])
        blocks = []
        for level, mult in list(enumerate(c["channel_mult"]))[::-1]:
            for i in range(c["num_res_blocks"] + 1):
                layers = level_layers(ch + chans.pop(), mult * mc, ds)
                ch = mult * mc
                if level and i == c["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                blocks.append(layers)
        self.output_blocks = nn.ModuleList(nn.ModuleList(b) for b in blocks)
        self.out = norm_act_conv(mc, Conv2d(mc, self.out_ch, 3, padding=1), False)

    @staticmethod
    def _run(layers, h, emb, ctx, b):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, b)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, ctx)
            elif isinstance(layer, TemporalTransformer):
                bt, hh, ww, c = h.shape
                h = layer(h.reshape(b, bt // b, hh, ww, c)).reshape(bt, hh, ww, c)
            else:
                h = layer(h)
        return h

    def forward(self, x, t, context, fps):
        b, f, hh, ww, _ = x.shape
        emb = self.time_embed(timestep_embedding(t, self.mc))
        fps_bt = torch.full((b, f), float(fps), device=x.device)
        emb = (emb + self.fps_embedding(timestep_embedding(fps_bt, self.mc))).reshape(b * f, -1)
        ctx = context.float().repeat_interleave(f, dim=0)
        h = x.float().reshape(b * f, hh, ww, x.shape[-1])
        hs = []
        for i, block in enumerate(self.input_blocks):
            h = self._run(block, h, emb, ctx, b)
            if i == 0:
                h = self._run(self.init_attn, h, emb, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, b)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx, b)
        return self.out(h).reshape(b, f, hh, ww, self.out_ch)


# ---------------------------------------------------------------------------
# AE-KL (ae_modules.py, autoencoder.py)
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps=1e-6, silu=True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(32, cout, eps=1e-6, silu=True)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(Attending):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        n, h, w, c = x.shape
        hid = self.norm(x)
        q, k, v = (m(hid).reshape(n, h * w, 1, c) for m in (self.q, self.k, self.v))
        return x + self.proj_out(attention(q, k, v, self.rnd).reshape(n, h, w, c))


class Mid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = ResnetBlock(ch, ch), AttnBlock(ch), ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VAEDownsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


def _levels(c):
    if c.get("attn_resolutions"):
        raise ValueError("the reference VAE has attention only in its mid block")
    return c["ch"], c["ch_mult"], c["num_res_blocks"]


class Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        ch, mult, nres = _levels(c)
        self.conv_in = Conv2d(c["in_channels"], ch, 3, padding=1)
        down, cin = [], ch
        for i, m in enumerate(mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nres):
                level.block.append(ResnetBlock(cin, ch * m))
                cin = ch * m
            level.attn = nn.ModuleList()
            if i != len(mult) - 1:
                level.downsample = VAEDownsample(cin)
            down.append(level)
        self.down = nn.ModuleList(down)
        self.mid = Mid(cin)
        self.norm_out = GroupNorm(32, cin, eps=1e-6, silu=True)
        self.conv_out = Conv2d(cin, 2 * c["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        ch, mult, nres = _levels(c)
        cin = ch * mult[-1]
        self.conv_in = Conv2d(c["z_channels"], cin, 3, padding=1)
        self.mid = Mid(cin)
        up = [None] * len(mult)
        for i in reversed(range(len(mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nres + 1):
                level.block.append(ResnetBlock(cin, ch * mult[i]))
                cin = ch * mult[i]
            level.attn = nn.ModuleList()
            if i != 0:
                level.upsample = Upsample(cin)
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(32, cin, eps=1e-6, silu=True)
        self.conv_out = Conv2d(cin, c["out_ch"], 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            for block in self.up[i].block:
                h = block(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, c):
        super().__init__()
        if not c.get("double_z", True) or c["embed_dim"] != c["z_channels"]:
            raise ValueError("the reference VAE takes double_z and embed_dim == z_channels")
        self.encoder, self.decoder = Encoder(c), Decoder(c)
        self.quant_conv = Conv2d(2 * c["z_channels"], 2 * c["embed_dim"], 1)
        self.post_quant_conv = Conv2d(c["embed_dim"], c["z_channels"], 1)

    def moments(self, x):
        """[N, H, W, 3] -> (mean, logvar clamped to [-30, 20])."""
        mean, logvar = self.quant_conv(self.encoder(x.float())).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.float()))


# ---------------------------------------------------------------------------
# OpenCLIP towers and the Resampler
# ---------------------------------------------------------------------------

class MultiheadAttention(Attending):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, s, w = x.shape
        qkv = F.linear(self.rnd(x), self.rnd(self.in_proj_weight), self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.heads, w // self.heads) for t in qkv.chunk(3, dim=-1))
        return self.out_proj(attention(q, k, v, self.rnd, mask).reshape(b, s, w))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_1, self.ln_2 = LayerNorm(width), LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        self.mlp = nn.Sequential(collections.OrderedDict(
            c_fc=Linear(width, 4 * width), gelu=nn.GELU(), c_proj=Linear(4 * width, width)))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Tower(nn.Module):
    def __init__(self, width, heads, layers):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))


class TextEncoder(nn.Module):
    """tokens [B, 77] -> the penultimate block's features after ln_final."""

    def __init__(self, c):
        super().__init__()
        if not c.get("penultimate", True):
            raise ValueError("the reference text tower is the penultimate-layer conditioning")
        self.token_embedding = nn.Embedding(c["vocab_size"], c["width"])
        self.positional_embedding = nn.Parameter(torch.empty(c["context_length"], c["width"]))
        self.transformer = Tower(c["width"], c["heads"], c["layers"] - 1)
        self.ln_final = LayerNorm(c["width"])

    def forward(self, tokens):
        x = self.token_embedding(tokens).float() + self.positional_embedding
        s = tokens.shape[1]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        return self.ln_final(x)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[out, in] antialiased bicubic (a = -0.5) with align_corners=True, the
    resize that kornia (and torch's antialiased bicubic) applies."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    centers = scale * (np.arange(n_out) + 0.5) - 0.5
    x = np.abs((np.arange(n_in)[None] - centers[:, None]) / max(scale, 1.0))
    a = -0.5
    w = np.where(x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
                 np.where(x < 2, a * (x**3 - 5 * x**2 + 8 * x - 4), 0.0))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


class VisionEncoder(nn.Module):
    """images [B, H, W, 3] in [-1, 1] -> every token [B, 1 + grid^2, width]
    before ln_post (the finegrained Resampler's input)."""

    def __init__(self, c):
        super().__init__()
        self.size, grid = c["image_size"], c["image_size"] // c["patch_size"]
        self.conv1 = Conv2d(3, c["width"], c["patch_size"], stride=c["patch_size"], bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c["width"]))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, c["width"]))
        self.ln_pre = LayerNorm(c["width"])
        self.transformer = Tower(c["width"], c["heads"], c["layers"])
        self.ln_post = LayerNorm(c["width"])
        self.proj = nn.Parameter(torch.empty(c["width"], c["output_dim"]))

    def forward(self, images):
        images = images.float()
        as_t = lambda a: torch.from_numpy(a).to(images.device)
        wh = as_t(bicubic_weights(images.shape[1], self.size))
        ww = as_t(bicubic_weights(images.shape[2], self.size))
        x = torch.einsum("pw,bowc->bopc", ww, torch.einsum("oh,bhwc->bowc", wh, images))
        x = ((x + 1.0) / 2.0 - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(
            CLIP_STD, device=x.device)
        x = self.conv1(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        for block in self.transformer.resblocks:
            x = block(x)
        return x


class PerceiverAttention(Attending):
    def __init__(self, dim, dim_head, heads):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        b, n = latents.shape[:2]
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head)
        k, v = self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1)
        out = attention(split(self.to_q(latents)), split(k), split(v), self.rnd)
        return self.to_out(out.reshape(b, n, -1))


class Resampler(nn.Module):
    def __init__(self, dim, depth, dim_head, heads, num_queries, embedding_dim, output_dim,
                 ff_mult=4):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(1, num_queries, dim))
        self.proj_in = Linear(embedding_dim, dim)
        self.proj_out = Linear(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)
        self.layers = nn.ModuleList(nn.ModuleList([
            PerceiverAttention(dim, dim_head, heads),
            nn.Sequential(LayerNorm(dim), Linear(dim, dim * ff_mult, bias=False), nn.GELU(),
                          Linear(dim * ff_mult, dim, bias=False))]) for _ in range(depth))

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x.float())
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))


# ---------------------------------------------------------------------------
# The bundles
# ---------------------------------------------------------------------------

class LatentDiffusion(nn.Module):
    """unet, vae and clip (text) under the names the program's bundle uses;
    with `vision`, also the vision tower and the finegrained Resampler."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.scale_factor = cfg["diffusion"]["scale_factor"]
        self.unet = UNet(cfg["unet"])
        self.vae = AutoencoderKL(cfg["vae"])
        self.clip = TextEncoder(cfg["clip"])
        if "vision" in cfg:
            v, r = cfg["vision"], cfg["resampler"]
            self.vision = VisionEncoder(v)
            self.image_proj = Resampler(dim=r["dim"], depth=r["depth"], dim_head=r["dim_head"],
                                        heads=r["heads"], num_queries=r["num_queries"],
                                        embedding_dim=v["width"],
                                        output_dim=cfg["unet"]["context_dim"])

    def image_embeds(self, images):
        return self.image_proj(self.vision(images))

    def decode(self, z):
        """Scaled latents [N, h, w, 4] -> frames [N, H, W, 3] in [-1, 1]."""
        return self.vae.decode(z / self.scale_factor).clamp(-1.0, 1.0)
