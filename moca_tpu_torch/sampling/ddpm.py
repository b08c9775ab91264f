"""DDPM ancestral sampler (the reference's non-DDIM path).

Port of moca_tpu/sampling/ddpm.py: the q/p sampling math of `DDPM`
(lvdm/models/ddpm3d.py:200-274: q_sample, q_posterior,
predict_start_from_noise, p_sample, p_sample_loop) under both
parameterizations ('eps' | 'x0', ddpm3d.py:70). Used when ddim_steps <= 0
(inference.py:28). The reference's `lax.scan` over the T timesteps is a
Python loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from moca_tpu_torch.sampling.ddim import Normal, _gather, shared_normal
from moca_tpu_torch.schedule import DiffusionSchedule


def q_sample(sch: DiffusionSchedule, x0: torch.Tensor, t, noise: torch.Tensor,
             use_scale: Optional[bool] = None) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (ddpm3d.py:412-420), with the
    VideoCrafter2 use_scale ramp on the signal term."""
    sa = _gather(sch.sqrt_alphas_cumprod, t, x0)
    sm = _gather(sch.sqrt_one_minus_alphas_cumprod, t, x0)
    if sch.use_scale if use_scale is None else use_scale:
        sa = sa * _gather(sch.scale_arr, t, x0)
    return sa * x0 + sm * noise


def predict_start_from_noise(sch: DiffusionSchedule, x_t: torch.Tensor, t,
                             noise: torch.Tensor) -> torch.Tensor:
    """x_0 from x_t and the predicted noise (ddpm3d.py:212-216)."""
    ac = _gather(sch.alphas_cumprod, t, x_t)
    return torch.sqrt(1.0 / ac) * x_t - torch.sqrt(1.0 / ac - 1.0) * noise


def q_posterior(sch: DiffusionSchedule, x0: torch.Tensor, x_t: torch.Tensor, t,
                v_posterior: float = 0.0):
    """Mean, variance and log variance of q(x_{t-1} | x_t, x_0)
    (ddpm3d.py:143-153, the posterior buffers computed on the fly)."""
    betas = _gather(sch.betas, t, x_t)
    ac = _gather(sch.alphas_cumprod, t, x_t)
    ac_prev = _gather(sch.alphas_cumprod_prev, t, x_t)
    coef1 = betas * torch.sqrt(ac_prev) / (1.0 - ac)
    coef2 = (1.0 - ac_prev) * torch.sqrt(1.0 - betas) / (1.0 - ac)
    mean = coef1 * x0 + coef2 * x_t
    var = (1.0 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac) + v_posterior * betas
    return mean, var, torch.log(torch.clamp(var, min=1e-20))


def ddpm_sample(eps_fn: Callable, sch: DiffusionSchedule, shape: Tuple[int, ...],
                normal: Normal, tag: tuple = ("ddpm",), parameterization: str = "eps",
                clip_denoised: bool = False,
                x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full ancestral loop over all T timesteps (p_sample_loop).
    eps_fn(x, t_frames) predicts the noise, or x_0 with
    parameterization='x0'. Draws, shared across the batch: tag+("init",)
    for x_T unless it is given, tag+("step", i) at step i (t = T-1-i; the
    last step adds none of it)."""
    if parameterization not in ("eps", "x0"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    x = shared_normal(normal, tag + ("init",), shape) if x_T is None else x_T
    b, frames = shape[0], shape[1]
    steps = sch.num_timesteps
    for i in range(steps):
        t = steps - 1 - i
        t_frames = torch.full((b, frames), t, dtype=torch.long, device=x.device)
        out = eps_fn(x, t_frames)
        x0 = predict_start_from_noise(sch, x, t, out) if parameterization == "eps" else out
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, _, log_var = q_posterior(sch, x0, x, t)
        noise = shared_normal(normal, tag + ("step", i), x.shape)
        x = mean + float(t > 0) * torch.exp(0.5 * log_var) * noise
    return x
