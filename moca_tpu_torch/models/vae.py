"""AE-KL first-stage VAE, decoder path.

Port of the decode path of moca_tpu/models/vae.py (`Decoder`,
`post_quant_conv`, :154-223): channels-last [N, h, w, z] latents to
[N, H, W, 3] frames. Module names follow the upstream checkpoint
(`decoder.up.{i}.block.{j}`, `decoder.mid.attn_1`, ...). The mid-block
attention is single-head with d = 512 and stays plain torch, as it is XLA in
the reference. The encoder is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.models.unet3d import Conv2d
from moca_tpu_torch.ops.norms import GroupNorm32


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


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


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
    """The decode half of the first-stage autoencoder (autoencoder.py:23-113)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def decode(self, z):
        """[N, h, w, z] latents (unscaled) -> [N, H, W, 3]."""
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
