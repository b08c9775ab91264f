"""Normalization layers with the reference's fp32-statistics semantics.

Port of moca_tpu/ops/norms.py (`GroupNorm32`, :74-135) and of the U-Net's
`_LayerNorm32` (moca_tpu/models/unet3d.py:439-449). Both take channels-last
input [N, ..., C], compute statistics and the affine map in float32 and cast
back to the input's type. Parameter names are torch's (`weight`, `bias`) so
checkpoint keys map one to one. A norm whose `span` its owning network set
(the U-Net's: `unet.norm`) runs inside that trace range; the others open none.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from moca_tpu_torch.utils.profiling import annotate


def _in_span(forward):
    """Run `forward` inside the module's `span` range, where one is set."""
    @functools.wraps(forward)
    def run(self, x):
        if self.span is None:
            return forward(self, x)
        with annotate(self.span):
            return forward(self, x)
    return run


class GroupNorm32(nn.Module):
    """GroupNorm over channels-last [N, ..., C] with fp32 statistics.

    Groups partition the channel axis as in torch.nn.GroupNorm; statistics
    run over every axis between N and C. Widths that 32 does not divide (tiny
    test configs) fall back to gcd(C, 32) groups, as the reference does.
    act="silu" applies SiLU in fp32 before the cast back."""

    span = None

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: str | None = None):
        super().__init__()
        self.groups = (num_groups if num_channels % num_groups == 0
                       else math.gcd(num_channels, num_groups))
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    @_in_span
    def forward(self, x):
        n, c = x.shape[0], x.shape[-1]
        x32 = x.float().reshape(n, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(x32, dim=(1, 3), correction=0, keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight.float() + self.bias.float()
        if self.act == "silu":
            y = F.silu(y)
        return y.to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last axis with fp32 statistics, cast back."""

    span = None

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    @_in_span
    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)
