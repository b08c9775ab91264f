"""Diagonal Gaussian posterior math (ref: lvdm/distributions.py:24-95).

Port of moca_tpu/utils/distributions.py. The VAE encode path returns
(mean, logvar); these functions are the sample/kl/nll/mode operations of the
reference's DiagonalGaussianDistribution, with logvar clamped to [-30, 20].
`sample` draws its noise through the port's `normal(tag, shape)`
(sampling/ddim.py), not through a key.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _clamp(logvar: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logvar, -30.0, 20.0)


def sample(mean: torch.Tensor, logvar: torch.Tensor, normal, tag: tuple) -> torch.Tensor:
    """mean + std * eps, eps the draw `tag` shaped like mean."""
    std = torch.exp(0.5 * _clamp(logvar))
    return mean + std * normal(tag, tuple(mean.shape)).to(mean.dtype)


def mode(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return mean


def kl(mean: torch.Tensor, logvar: torch.Tensor,
       other: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """KL to the standard normal (or to another diagonal Gaussian), summed
    over the non-batch axes (distributions.py:37-52)."""
    logvar = _clamp(logvar)
    var = torch.exp(logvar)
    axes = tuple(range(1, mean.ndim))
    if other is None:
        return 0.5 * torch.sum(mean**2 + var - 1.0 - logvar, dim=axes)
    o_mean, o_logvar = other
    o_logvar = _clamp(o_logvar)
    o_var = torch.exp(o_logvar)
    return 0.5 * torch.sum((mean - o_mean) ** 2 / o_var + var / o_var - 1.0 - logvar + o_logvar,
                           dim=axes)


def nll(mean: torch.Tensor, logvar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative log likelihood of x (distributions.py:54-60)."""
    logvar = _clamp(logvar)
    axes = tuple(range(1, mean.ndim))
    return 0.5 * torch.sum(math.log(2.0 * math.pi) + logvar + (x - mean) ** 2 / torch.exp(logvar),
                           dim=axes)
