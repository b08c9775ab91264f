"""AE-KL first-stage VAE.

Port of moca_tpu/models/vae.py: the encoder (`Encoder`, `Downsample`,
`quant_conv`, `encode_moments`, `encode`, :96-152, 185-216) takes
channels-last [N, H, W, 3] frames to the posterior moments [N, h, w, z];
the decoder (`Decoder`, `post_quant_conv`, :154-223) takes [N, h, w, z]
latents back to [N, H, W, 3] frames. Module names follow the upstream
checkpoint (`encoder.down.{i}.block.{j}`, `decoder.up.{i}.block.{j}`,
`decoder.mid.attn_1`, ...). The mid-block attention is single-head with
d = 512 and stays plain torch, as it is XLA in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.models.unet3d import Conv2d
from moca_tpu_torch.ops.norms import GroupNorm32
from moca_tpu_torch.utils import distributions
from moca_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Mirrors configs/inference_t2v_512_v2.0.yaml:51-72 ddconfig."""

    double_z: bool = True
    z_channels: int = 4
    resolution: int = 512
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    embed_dim: int = 4


def _norm(ch: int) -> GroupNorm32:
    return GroupNorm32(32, ch, eps=1e-6)


class ResnetBlock(nn.Module):
    """GN -> swish -> conv, twice, with a 1x1 nin shortcut on width change."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _norm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head bottleneck self-attention, plain torch, fp32 softmax."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _norm(ch)
        self.q = Conv2d(ch, ch, 1)
        self.k = Conv2d(ch, ch, 1)
        self.v = Conv2d(ch, ch, 1)
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x):
        n, h, w, c = x.shape
        hid = self.norm(x)
        q = self.q(hid).reshape(n, h * w, c)
        k = self.k(hid).reshape(n, h * w, c)
        v = self.v(hid).reshape(n, h * w, c)
        logits = torch.einsum("nqc,nkc->nqk", q.float(), k.float()) * c**-0.5
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("nqk,nkc->nqc", attn.to(v.dtype), v)
        return x + self.proj_out(out.reshape(n, h, w, c))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class Downsample(nn.Module):
    """Asymmetric pad (0, 1, 0, 1), then a stride-2 3x3 conv (ae_modules.py:92-110)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    """num_res_blocks blocks per level, a Downsample between levels
    (ae_modules.py:364-465)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        curr_res, block_in = cfg.resolution, cfg.ch
        down = []
        for i, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            block_out = cfg.ch * mult
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level.block = nn.ModuleList(blocks)
            level.attn = nn.ModuleList(attns)
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            down.append(level)
        self.down = nn.ModuleList(down)
        self.mid = _Mid(block_in)
        self.norm_out = _norm(block_in)
        z_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(block_in, z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != len(self.down) - 1:
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """num_res_blocks + 1 blocks per level, levels walked from the deepest."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (levels - 1)
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        up = [None] * levels
        for i in reversed(range(levels)):
            level = nn.Module()
            block_out = cfg.ch * cfg.ch_mult[i]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level.block = nn.ModuleList(blocks)
            level.attn = nn.ModuleList(attns)
            if i != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != 0:
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """The first-stage autoencoder (autoencoder.py:23-113), quant_conv and
    post_quant_conv 1x1 convs included."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
                                 (2 if cfg.double_z else 1) * cfg.embed_dim, 1)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode_moments(self, x):
        """[N, H, W, 3] -> (mean, logvar), each [N, h, w, embed_dim] in the
        parameters' type, logvar clamped to [-30, 20]; inside a `vae.encode`
        trace range (utils/profiling.py `annotate`)."""
        with annotate("vae.encode"):
            x = x.to(self.quant_conv.weight.dtype)
            mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=-1)
            return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, normal=None, tag: tuple = ("encode",)):
        """The posterior sample drawn as `tag` (ddpm3d.py:458-465), or the
        mean when no `normal` is given."""
        mean, logvar = self.encode_moments(x)
        if normal is None:
            return mean
        return distributions.sample(mean, logvar, normal, tag)

    def decode(self, z):
        """[N, h, w, z] latents (unscaled) -> [N, H, W, 3]."""
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
