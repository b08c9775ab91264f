"""VideoCrafter2-class 3D U-Net denoiser.

Port of moca_tpu/models/unet3d.py: spatial and temporal transformers,
temporal convolutions, the `addition_attention` init transformer and
`fps_cond` of the shipped configuration (configs/inference_t2v_512_v2.0.yaml:
22-50), and the options beside it: relative-position and causal temporal
attention, `tempspatial_aware` temporal convolutions, temporal
cross-attention to the first frame's context (`temporal_selfatt_only=False`),
a context-free U-Net (`context_dim=None`: the spatial cross-attention
self-attends), `no_temporal_attn` in the forward, and the i2v model's image
cross-attention (`use_image_attention`): the spatial transformers'
cross-attention splits its context after the 77 text tokens and adds the
attention to the image tokens, through `to_k_ip` / `to_v_ip`, to the text
attention before `to_out` (attention.py:82-124).

Layout: channels-last [B, T, H, W, C] at the public call, spatial layers on
the flattened (B*T) frame axis, temporal layers on the flattened (B*H*W)
pixel axis; per-frame timesteps [B, T] are first class. Convolutions take
channels-last input and permute to torch's layout inside the module (with a
channels-last memory format, so cuDNN sees NHWC and no copy is made).

Module names follow the upstream checkpoint keys that
moca_tpu/models/convert.py `convert_unet` reads (e.g.
`input_blocks.1.1.transformer_blocks.0.attn1.to_q`, including the
`temopral_conv` spelling), so `convert_unet(model.state_dict(), cfg,
prefix="")` gives the JAX tree and an upstream state dict loads directly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.ops.attention import (
    dot_product_attention, fused_qkv_attention, packed_attention, use_fused_qkv,
    use_packed_tiny,
)
from moca_tpu_torch.ops.geglu import geglu
from moca_tpu_torch.ops.norms import GroupNorm32, LayerNorm32
from moca_tpu_torch.schedule import timestep_embedding
from moca_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Mirrors configs/inference_t2v_512_v2.0.yaml:22-50 (defaults = shipped).
    The compute type is the parameters' type."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    temporal_transformer_depth: int = 1
    context_dim: int = 1024
    use_linear: bool = True
    temporal_conv: bool = True
    tempspatial_aware: bool = False
    temporal_attention: bool = True
    temporal_selfatt_only: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    temporal_length: int = 16
    addition_attention: bool = True
    use_image_attention: bool = False
    fps_cond: bool = True
    dropout: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


def unet_plan(cfg: UNetConfig):
    """(input_blocks, middle_block, output_blocks) as lists of layer dicts
    {kind, in_ch, out_ch, heads, dim_head} — a copy of the reference's walk
    of openaimodel3d.py:374-532."""
    mc = cfg.model_channels

    def attn(kind, ch):
        return dict(kind=kind, in_ch=ch, out_ch=ch, heads=ch // cfg.num_head_channels,
                    dim_head=cfg.num_head_channels)

    input_blocks = [[dict(kind="conv_in", in_ch=cfg.in_channels, out_ch=mc)]]
    input_chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [dict(kind="res", in_ch=ch, out_ch=mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                layers.append(attn("spatial", ch))
                if cfg.temporal_attention:
                    layers.append(attn("temporal", ch))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([dict(kind="down", in_ch=ch, out_ch=ch)])
            input_chans.append(ch)
            ds *= 2

    middle_block = [dict(kind="res", in_ch=ch, out_ch=ch), attn("spatial", ch)]
    if cfg.temporal_attention:
        middle_block.append(attn("temporal", ch))
    middle_block.append(dict(kind="res", in_ch=ch, out_ch=ch))

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [dict(kind="res", in_ch=ch + ich, out_ch=mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                layers.append(attn("spatial", ch))
                if cfg.temporal_attention:
                    layers.append(attn("temporal", ch))
            if level and i == cfg.num_res_blocks:
                layers.append(dict(kind="up", in_ch=ch, out_ch=ch))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle_block, output_blocks


# ---------------------------------------------------------------------------
# Channels-last convolutions
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last [N, H, W, C] input and output."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """nn.Conv3d on channels-last [N, T, H, W, C] input and output."""

    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class Conv1x1AsLinear(nn.Conv1d):
    """A kernel-1 Conv1d (the checkpoint's [out, in, 1] weight) applied to
    channels-last tokens: exactly a Linear (the init transformer is built
    without use_linear, openaimodel3d.py:379-389 -> attention.py:297-300)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features, 1)

    def forward(self, x):
        return F.linear(x, self.weight[..., 0], self.bias)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _norm_act_conv(ch: int, conv: nn.Module, dropout_slot: bool) -> nn.Sequential:
    """(GroupNorm+SiLU, [Dropout,] Conv) with the upstream Sequential indices:
    SiLU is fused into the fp32 norm and its slot (and dropout's) is empty."""
    mods = [GroupNorm32(32, ch, act="silu"), nn.Identity()]
    if dropout_slot:
        mods.append(nn.Identity())
    return nn.Sequential(*mods, conv)


class TemporalConvBlock(nn.Module):
    """4x (GN -> SiLU -> Conv3d(3,1,1)) plus identity; input [B, T, H, W, C].
    `spatial_aware` widens conv1 and conv2 to 3x3x3 (openaimodel3d.py:249-264)."""

    def __init__(self, channels: int, spatial_aware: bool = False):
        super().__init__()
        temporal = lambda: Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        wide = ((lambda: Conv3d(channels, channels, (3, 3, 3), padding=(1, 1, 1)))
                if spatial_aware else temporal)
        self.conv1 = _norm_act_conv(channels, wide(), dropout_slot=False)
        self.conv2 = _norm_act_conv(channels, wide(), dropout_slot=True)
        self.conv3 = _norm_act_conv(channels, temporal(), dropout_slot=True)
        self.conv4 = _norm_act_conv(channels, temporal(), dropout_slot=True)

    def forward(self, x):
        return self.conv4(self.conv3(self.conv2(self.conv1(x)))) + x


class ResBlock(nn.Module):
    """Residual block with timestep embedding and temporal conv.
    Input [BT, H, W, C], emb [BT, E]."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, temporal_conv: bool,
                 tempspatial_aware: bool = False):
        super().__init__()
        self.in_layers = _norm_act_conv(in_ch, Conv2d(in_ch, out_ch, 3, padding=1),
                                        dropout_slot=False)
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, out_ch))
        self.out_layers = _norm_act_conv(out_ch, Conv2d(out_ch, out_ch, 3, padding=1),
                                         dropout_slot=True)
        self.skip_connection = (Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                                else nn.Identity())
        if temporal_conv:
            self.temopral_conv = TemporalConvBlock(out_ch, tempspatial_aware)
        self.temporal_conv = temporal_conv

    def forward(self, x, emb, batch_size: int):
        with annotate("unet.res"):
            h = self.in_layers(x)
            h = h + self.emb_layers(emb)[:, None, None, :].to(h.dtype)
            h = self.skip_connection(x) + self.out_layers(h)
            if self.temporal_conv:
                bt, hh, ww, c = h.shape
                v = self.temopral_conv(h.reshape(batch_size, bt // batch_size, hh, ww, c))
                h = v.reshape(bt, hh, ww, c)
            return h


class RelativePosition(nn.Module):
    """Learned relative-position embedding table (attention.py:21-40)."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(torch.empty(2 * max_relative_position + 1,
                                                         num_units))
        nn.init.xavier_uniform_(self.embeddings_table)

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        """[length_q, length_k, num_units]: the row of each clipped k - q."""
        m = self.max_relative_position
        rq = torch.arange(length_q, device=self.embeddings_table.device)[:, None]
        rk = torch.arange(length_k, device=self.embeddings_table.device)[None, :]
        return self.embeddings_table[torch.clamp(rk - rq, -m, m) + m]


TEXT_CONTEXT_LEN = 77  # text tokens ahead of the image tokens (attention.py:82-87)
# image tokens a frame in a per-frame context (DynamiCrafter's UNetModel.forward
# tests the context's length against 77 + 16 T, a constant of its code)
FRAME_IMAGE_TOKENS = 16


def frame_context(context: torch.Tensor, frames: int) -> torch.Tensor:
    """[B, L, D] -> the [B*T, L', D] context of each frame row: the row's
    context repeated, or, where L = 77 + 16 T (a per-frame image context,
    frame-major), the 77 text tokens and that frame's own 16 image tokens."""
    b, length = context.shape[:2]
    if length != TEXT_CONTEXT_LEN + frames * FRAME_IMAGE_TOKENS:
        return context.repeat_interleave(frames, dim=0)
    text = context[:, :TEXT_CONTEXT_LEN].repeat_interleave(frames, dim=0)
    image = context[:, TEXT_CONTEXT_LEN:].reshape(b * frames, FRAME_IMAGE_TOKENS,
                                                   context.shape[-1])
    return torch.cat([text, image], dim=1)


class CrossAttention(nn.Module):
    """Multi-head self / text-cross attention (attention.py:43-127), with the
    relative-position logits and output term (temporal) and, when it
    self-attends, a causal mask. Those two take the plain path, as in the
    reference, where they are XLA. `img_cross_attention`: the context's
    tokens after the first 77 are image tokens, attended through to_k_ip /
    to_v_ip (Sk = 16 or 4: the plain path, XLA in the reference) and added to
    the text attention (image_cross_attention_scale 1.0, the reference's
    default, which no config changes)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, relative_position: bool = False,
                 temporal_length: int | None = None, causal: bool = False,
                 img_cross_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))
        self.relative_position = relative_position
        if relative_position:
            self.relative_position_k = RelativePosition(dim_head, temporal_length)
            self.relative_position_v = RelativePosition(dim_head, temporal_length)
        self.img_cross_attention = img_cross_attention
        if img_cross_attention:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)

    def forward(self, x, context=None):
        h, d = self.heads, self.dim_head
        out_proj = self.to_out[0]
        causal = self.causal and context is None
        plain_self = context is None and not causal and not self.relative_position
        if (plain_self and h * d == x.shape[-1] == out_proj.out_features
                and use_fused_qkv(x, x.shape[1], h * d, h, d)):
            # the reference's opt-in fused branch (unet3d.py:326-340)
            return fused_qkv_attention(x, self.to_q.weight, self.to_k.weight,
                                       self.to_v.weight, out_proj.weight, out_proj.bias, h)
        q = self.to_q(x)
        ctx = x if context is None else context
        ctx_img = None
        if context is not None and self.img_cross_attention:
            ctx, ctx_img = ctx[:, :TEXT_CONTEXT_LEN], ctx[:, TEXT_CONTEXT_LEN:]
        k, v = self.to_k(ctx), self.to_v(ctx)
        b, sq, sk = x.shape[0], x.shape[1], k.shape[1]
        if plain_self and use_packed_tiny(q, sq, sk, None, h * d, h):
            return self.to_out(packed_attention(q, k, v, h))
        qh, kh, vh = q.view(b, sq, h, d), k.view(b, sk, h, d), v.view(b, sk, h, d)
        bias = None
        if causal:
            keep = torch.ones((sq, sk), dtype=torch.bool, device=x.device).tril()
            bias = torch.zeros((sq, sk), device=x.device).masked_fill(~keep, -torch.inf)
        if self.relative_position:
            out = self._relative_attention(qh, kh, vh, bias)
        else:
            out = dot_product_attention(qh, kh, vh, bias=bias)
        out = out.reshape(b, sq, h * d)
        if ctx_img is not None:
            k_ip = self.to_k_ip(ctx_img).reshape(b, -1, h, d)
            v_ip = self.to_v_ip(ctx_img).reshape(b, -1, h, d)
            out = out + dot_product_attention(qh, k_ip, v_ip).reshape(b, sq, h * d)
        return self.to_out(out)

    def _relative_attention(self, q, k, v, bias):
        """softmax(q k^T s + q rel_k^T s + bias) (v + rel_v), fp32 logits
        (unet3d.py:373-393, attention.py:94-113)."""
        sq, sk = q.shape[1], k.shape[1]
        rel_k = self.relative_position_k(sq, sk).float()
        rel_v = self.relative_position_v(sq, sk).float()
        scale = self.dim_head ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = logits + torch.einsum("bqhd,qkd->bhqk", q.float(), rel_k) * scale
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return out + torch.einsum("bhqk,qkd->bqhd", probs, rel_v).to(out.dtype)


class GEGLU(nn.Module):
    """proj, then x * gelu_tanh(gate) on its two halves (ops/geglu.py: the
    kernel on CUDA tensors, the plain chain on CPU tensors)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        return geglu(self.proj(x))


class FeedForward(nn.Module):
    """GEGLU feed-forward (attention.py:386-403); net = (GEGLU, Dropout, Linear)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn (or second self-attn) -> GEGLU FF, pre-norm.
    A causal block masks attn1 and, when it has no context, attn2 too
    (attention.py:206-218 passes the mask to both and then drops the context).
    `xattn_span`: the trace range around the attn2 call, which the spatial
    transformer names (`unet.xattn`); the feed-forward runs inside `unet.ff`,
    its norm outside."""

    xattn_span = None

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None,
                 relative_position: bool = False, temporal_length: int | None = None,
                 causal: bool = False, img_cross_attention: bool = False):
        super().__init__()
        rel = dict(relative_position=relative_position, temporal_length=temporal_length)
        self.attn1 = CrossAttention(dim, heads, dim_head, causal=causal, **rel)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim,
                                    causal=causal, img_cross_attention=img_cross_attention,
                                    **rel)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self._attend_context(self.norm2(x), context) + x
        return self._feed_forward(self.norm3(x)) + x

    def _attend_context(self, x, context):
        # a call of its own, so that no local keeps the normed input or the
        # output alive through the feed-forward
        with annotate(self.xattn_span):
            return self.attn2(x, context=context)

    def _feed_forward(self, x):
        # a call of its own, as `_attend_context`
        with annotate("unet.ff"):
            return self.ff(x)


class SpatialTransformer(nn.Module):
    """Per-frame transformer over the h*w tokens; input [BT, H, W, C]."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int, context_dim: int,
                 img_cross_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(32, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim,
                                  img_cross_attention=img_cross_attention)
            for _ in range(depth))
        for block in self.transformer_blocks:
            block.xattn_span = "unet.xattn"
        self.proj_out = nn.Linear(inner, ch)

    def forward(self, x, context=None):
        with annotate("unet.spatial"):
            bt, hh, ww, c = x.shape
            h = self.proj_in(self.norm(x).reshape(bt, hh * ww, c))
            for block in self.transformer_blocks:
                h = block(h, context=context)
            return self.proj_out(h).reshape(bt, hh, ww, c) + x


class TemporalTransformer(nn.Module):
    """Transformer over the T frames of each pixel; input [B, T, H, W, C].
    only_self_att (the shipped config): attn2 is a second self-attention;
    otherwise it attends to the context of the row's first frame."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 use_linear: bool = True, only_self_att: bool = True,
                 context_dim: int | None = None, relative_position: bool = False,
                 temporal_length: int | None = None, causal: bool = False):
        super().__init__()
        inner = heads * dim_head
        proj = nn.Linear if use_linear else Conv1x1AsLinear
        self.only_self_att = only_self_att
        self.norm = GroupNorm32(32, ch, eps=1e-6)
        self.proj_in = proj(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, None if only_self_att else context_dim,
                                  relative_position, temporal_length, causal)
            for _ in range(depth))
        self.proj_out = proj(inner, ch)

    def forward(self, x, context=None):
        """context: [B*T, L, D] per-frame context (ignored with only_self_att)."""
        with annotate("unet.temporal"):
            b, t, hh, ww, c = x.shape
            h = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, c)
            h = self.proj_in(h)
            ctx = None
            if not self.only_self_att and context is not None:
                # the first frame's context, repeated for each pixel (attention.py:355-363)
                ctx = context.reshape((b, t) + tuple(context.shape[1:]))[:, 0]
                ctx = ctx.repeat_interleave(hh * ww, dim=0)
            for block in self.transformer_blocks:
                h = block(h, context=ctx)
            h = self.proj_out(h).reshape(b, hh, ww, t, c).permute(0, 3, 1, 2, 4)
            return h + x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (openaimodel3d.py:51-77)."""

    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x then 3x3 conv (openaimodel3d.py:80-106)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# The U-Net
# ---------------------------------------------------------------------------

class UNet3D(nn.Module):
    """Epsilon predictor: forward(x [B,T,H,W,Cin], timesteps [B,T],
    context [B,L,D], fps) -> [B,T,H,W,Cout] in x's type.

    Trace ranges (utils/profiling.py `annotate`): `unet.res`, `unet.spatial`
    and `unet.temporal` around each block, `unet.xattn` around each spatial
    transformer's cross-attention (text and image), `unet.ff` around each
    transformer block's feed-forward, and `unet.norm` around each of its own
    norms, which it names here; the other networks' norms open none."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        mc, ted = cfg.model_channels, cfg.time_embed_dim
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.fps_cond:
            self.fps_embedding = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(),
                                               nn.Linear(ted, ted))
        in_plan, mid_plan, out_plan = unet_plan(cfg)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(self._layer(s) for s in block) for block in in_plan)
        if cfg.addition_attention:
            self.init_attn = nn.ModuleList([self._temporal(mc, 8, cfg.num_head_channels,
                                                           use_linear=False)])
        self.middle_block = nn.ModuleList(self._layer(s) for s in mid_plan)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._layer(s) for s in block) for block in out_plan)
        self.out = _norm_act_conv(mc, Conv2d(mc, cfg.out_channels, 3, padding=1),
                                  dropout_slot=False)
        for m in self.modules():
            if isinstance(m, (GroupNorm32, LayerNorm32)):
                m.span = "unet.norm"

    def _layer(self, spec) -> nn.Module:
        cfg, kind = self.cfg, spec["kind"]
        if kind == "conv_in":
            return Conv2d(spec["in_ch"], spec["out_ch"], 3, padding=1)
        if kind == "res":
            return ResBlock(spec["in_ch"], spec["out_ch"], cfg.time_embed_dim,
                            cfg.temporal_conv, cfg.tempspatial_aware)
        if kind == "spatial":
            return SpatialTransformer(spec["out_ch"], spec["heads"], spec["dim_head"],
                                      cfg.transformer_depth, cfg.context_dim,
                                      img_cross_attention=cfg.use_image_attention)
        if kind == "temporal":
            return self._temporal(spec["out_ch"], spec["heads"], spec["dim_head"])
        if kind == "down":
            return Downsample(spec["out_ch"])
        if kind == "up":
            return Upsample(spec["out_ch"])
        raise ValueError(kind)

    def _temporal(self, ch: int, heads: int, dim_head: int,
                  use_linear: bool = True) -> TemporalTransformer:
        cfg = self.cfg
        return TemporalTransformer(
            ch, heads, dim_head, cfg.temporal_transformer_depth, use_linear=use_linear,
            only_self_att=cfg.temporal_selfatt_only, context_dim=cfg.context_dim,
            relative_position=cfg.use_relative_position,
            temporal_length=cfg.temporal_length, causal=cfg.use_causal_attention)

    @staticmethod
    def _run_block(layers, h, emb, context, batch_size: int, no_temporal_attn: bool):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, batch_size)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            elif isinstance(layer, TemporalTransformer):
                if no_temporal_attn:
                    continue
                bt, hh, ww, c = h.shape
                v = layer(h.reshape(batch_size, bt // batch_size, hh, ww, c), context)
                h = v.reshape(bt, hh, ww, c)
            else:
                h = layer(h)
        return h

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def forward(self, x, timesteps, context, fps=16, no_temporal_attn: bool = False):
        """no_temporal_attn skips every temporal transformer, the init one
        included (the image branch of temporal guidance, unet3d.py:660-687).
        context None (the context-free conditioning modes): the spatial
        cross-attention self-attends."""
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        if timesteps.ndim != 2:
            raise ValueError("timesteps must be [B, T] (per-frame, first-class)")
        dtype = self.dtype

        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels).to(dtype))
        if cfg.fps_cond:
            fps_t = torch.as_tensor(fps, dtype=torch.float32, device=x.device)
            fps_bt = fps_t.reshape(-1, 1).expand(b, t)
            emb = emb + self.fps_embedding(
                timestep_embedding(fps_bt, cfg.model_channels).to(dtype))
        emb = emb.reshape(b * t, cfg.time_embed_dim)
        ctx = None
        if context is not None:
            ctx = (frame_context(context, t) if cfg.use_image_attention
                   else context.repeat_interleave(t, dim=0)).to(dtype)

        h = x.reshape(b * t, hh, ww, x.shape[-1]).to(dtype)
        nta = no_temporal_attn
        hs = []
        for i, block in enumerate(self.input_blocks):
            h = self._run_block(block, h, emb, ctx, b, nta)
            if i == 0 and cfg.addition_attention:
                h = self._run_block(self.init_attn, h, emb, ctx, b, nta)
            hs.append(h)
        h = self._run_block(self.middle_block, h, emb, ctx, b, nta)
        for block in self.output_blocks:
            h = self._run_block(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx, b, nta)
        h = self.out(h)
        return h.reshape(b, t, hh, ww, cfg.out_channels).to(x.dtype)
