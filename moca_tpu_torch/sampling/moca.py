"""MoCA latent manipulation: per-window diagonal DDIM step with momentum
correction, mask-guided concept injection and noise blending.

Port of moca_tpu/sampling/moca.py (`MoCAConfig`, `moca_window_step`
:63-168). The reference's `lax.scan` over the window's f frames is a Python
loop carrying (previous frame's pred_x0, momentum). As in the reference, this
step applies no `use_scale` correction (unlike `ddim_step_math`), x_prev is
computed before injection and the gamma-blend reuses the sigma-scaled
step noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from moca_tpu_torch.sampling.ddim import Normal, shared_normal
from moca_tpu_torch.schedule import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class MoCAConfig:
    """Knobs of ddim_step (reference defaults)."""

    beta: float = 0.9                  # momentum decay (ddim.py:397)
    dir_weight: float = 1.5            # motion_gradient dir_xt weight (ddim.py:423)
    correction_gain: float = 2.0       # correction_strength = g*(1-t/1000) (ddim.py:428)
    gamma: float = 0.5                 # noise blend (ddim.py:377)
    inject_threshold: int = 300        # t <= 300 gates injection (ddim.py:582,592)
    davis_enhancement: float = 1.5     # ddim.py:582
    seg_enhancement: float = 2.0       # ddim.py:847
    inject_into_queue: bool = False    # False = reference-faithful
    enable_momentum: bool = True
    enable_injection: bool = True


def moca_window_step(sch: DiffusionSchedule, cfg: MoCAConfig, x: torch.Tensor,
                     eps: torch.Tensor, indices, timesteps, normal: Normal, tag: tuple,
                     cond_image: Optional[torch.Tensor] = None,
                     masks: Optional[torch.Tensor] = None, masks_are_davis: bool = True,
                     gamma: Optional[float] = None,
                     with_preinject: bool = False) -> Tuple[torch.Tensor, ...]:
    """One diagonal denoise of a window x, eps [B, f, h, w, C] with per-frame
    DDIM `indices` and DDPM `timesteps` ([f], host integers). Returns
    (x_prev, pred_x0), and with `with_preinject` also the momentum-corrected
    pred_x0 before injection and blend, the tensor the reference segments
    (ddim.py:592-606). Frame j's noise is the draw tag+("frame", j), shaped
    [1, h, w, C] and shared across B."""
    f = x.shape[1]
    g = cfg.gamma if gamma is None else gamma
    indices, timesteps = np.asarray(indices), np.asarray(timesteps)
    have_masks = masks is not None
    enh = cfg.davis_enhancement if masks_are_davis else cfg.seg_enhancement
    cond = cond_image
    if cond is None and have_masks:
        # masks without a concept image inject zeros (ddim.py:572-574, :835-838)
        cond = torch.zeros(tuple(x.shape[2:4]) + (x.shape[-1],), dtype=x.dtype,
                           device=x.device)

    prev_frame = torch.zeros_like(x[:, 0])
    momentum = torch.zeros_like(x[:, 0])
    x_prevs, preds, pre = [], [], []
    for j in range(f):
        x_i, e_i = x[:, j], eps[:, j]
        idx, t_i = int(indices[j]), int(timesteps[j])
        a_t, a_prev = sch.ddim_alphas[idx], sch.ddim_alphas_prev[idx]
        sigma, sqrt_1ma = sch.ddim_sigmas[idx], sch.ddim_sqrt_one_minus_alphas[idx]

        pred_x0 = (x_i - sqrt_1ma * e_i) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_i
        if cfg.enable_momentum and j > 0:
            # EMA of (delta pred_x0 + w * dir_xt); frame 0 passes through
            motion_grad = (pred_x0 - prev_frame) + cfg.dir_weight * dir_xt
            momentum = cfg.beta * momentum + (1.0 - cfg.beta) * motion_grad
            strength = cfg.correction_gain * (1.0 - np.float32(t_i) / np.float32(1000.0))
            pred_x0 = pred_x0 + float(strength) * momentum
        prev_frame = pred_x0
        if with_preinject:
            pre.append(pred_x0)

        noise = sigma * shared_normal(normal, tag + ("frame", j), x_i.shape).to(x_i.dtype)
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + noise

        if cfg.enable_injection and have_masks:
            m_i = masks[:, j]
            below = t_i <= cfg.inject_threshold
            if masks_are_davis:
                factor, gate_t = (enh if below else 1.0), True
            else:
                factor, gate_t = enh, below
            if gate_t:
                gate = torch.sum(m_i) > 0  # "if mask.sum() != 0" (ddim.py:585)
                injected = torch.where(m_i > 0.5, cond.to(pred_x0.dtype) * factor, pred_x0)
                pred_x0 = torch.where(gate, injected, pred_x0)
                if cfg.inject_into_queue:
                    x_prev_inj = torch.sqrt(a_prev) * pred_x0 + dir_xt + noise
                    x_prev = torch.where(gate, x_prev_inj, x_prev)

        preds.append((1.0 - g) * pred_x0 + g * noise)  # gamma noise blend (ddim.py:609)
        x_prevs.append(x_prev)
    out = torch.stack(x_prevs, dim=1), torch.stack(preds, dim=1)
    return out + (torch.stack(pre, dim=1),) if with_preinject else out
