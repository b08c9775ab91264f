"""Diffusion schedule numerics.

Port of moca_tpu/schedule.py. The beta / DDIM / `use_scale` arrays are built
once in float64 NumPy (the same code as the reference) and handed to the
samplers as float32 tensors on the run's device; the sinusoidal timestep
embedding is a torch function.

DynamiCrafter's additions (lvdm/models/utils_diffusion.py, ddpm3d.py,
samplers/ddim.py): the zero-terminal-SNR rescale of the betas, after which
alpha_bar at the last timestep is exactly 0 (`rescale_zero_terminal_snr`);
the `uniform_trailing` DDIM spacing, which ends at the last timestep; its
dynamic rescale, the `use_scale` ramp whose previous-step scale at the first
DDIM step is that step's own (`dynamic_rescale`); and the v-parameterization,
carried by the schedule to the DDIM step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from moca_tpu_torch import resolve_device


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule in float64 (ref utils_diffusion.py:31-53)."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas whose alpha_bar at the last timestep is 0: sqrt(alpha_bar)
    shifted by its last value and scaled back to its first (Lin et al.,
    "Common Diffusion Noise Schedules and Sample Steps are Flawed",
    Algorithm 1; DynamiCrafter's utils_diffusion.py)."""
    s = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    s0, s_last = s[0], s[-1]
    s = (s - s_last) * s0 / (s0 - s_last)
    alphas_bar = s**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subset; 'uniform' is linspace(0, T-1, S).round();
    'uniform_trailing' (DynamiCrafter) counts back from T in steps of T/S,
    so that it ends at T - 1: 19, 39, ..., 999 for 50 of 1000."""
    if ddim_discr_method == "uniform":
        return (np.linspace(0, num_ddpm_timesteps - 1, num_ddim_timesteps)
                .round().astype(np.int64))
    if ddim_discr_method == "uniform_trailing":
        c = num_ddpm_timesteps / num_ddim_timesteps
        return np.flip(np.round(np.arange(num_ddpm_timesteps, 0, -c))).astype(np.int64) - 1
    if ddim_discr_method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int)
        return steps + 1
    raise NotImplementedError(f"unknown ddim discretization '{ddim_discr_method}'")


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float):
    """Per-DDIM-step (sigma, alpha, alpha_prev)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def make_scale_arr(num_timesteps: int, scale_a: float = 1.0, scale_b: float = 0.7,
                   mid_step: int = 400, fix_scale_bug: bool = False) -> np.ndarray:
    """VideoCrafter2 latent rescale ramp scale_a -> scale_b over `mid_step`
    steps, then flat; truncated to num_timesteps (see the reference note)."""
    scale_step = (num_timesteps - mid_step) if fix_scale_bug else num_timesteps
    arr = np.concatenate([np.linspace(scale_a, scale_b, mid_step),
                          np.full(scale_step, scale_b)])
    return arr[:num_timesteps].astype(np.float64)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order; returns shape + (dim,) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM + DDIM schedule buffers as float32 tensors on one device
    (int64 for the DDIM timesteps); `ddim_timesteps_np` keeps a host copy
    for host-side index maths."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    scale_arr: torch.Tensor
    ddim_timesteps: torch.Tensor
    ddim_alphas: torch.Tensor
    ddim_alphas_prev: torch.Tensor
    ddim_sigmas: torch.Tensor
    ddim_sqrt_one_minus_alphas: torch.Tensor
    ddim_scale_arr: torch.Tensor
    ddim_scale_arr_prev: torch.Tensor
    ddim_timesteps_np: np.ndarray
    use_scale: bool = True
    # "eps" (the U-Net predicts the noise) or "v" (it predicts
    # sqrt(a) eps - sqrt(1 - a) x0, DynamiCrafter); for "v" the DDIM step
    # also reads sqrt(alpha_bar) at each DDIM timestep
    parameterization: str = "eps"
    ddim_sqrt_alphas: torch.Tensor | None = None

    @property
    def num_ddim_steps(self) -> int:
        return self.ddim_timesteps.shape[0]

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(ddim_num_steps: int, num_timesteps: int = 1000,
                  beta_schedule: str = "linear", linear_start: float = 0.00085,
                  linear_end: float = 0.012, cosine_s: float = 8e-3,
                  ddim_discretize: str = "uniform", ddim_eta: float = 1.0,
                  use_scale: bool = True, scale_a: float = 1.0, scale_b: float = 0.7,
                  mid_step: int = 400, fix_scale_bug: bool = False,
                  rescale_betas_zero_snr: bool = False, parameterization: str = "eps",
                  dynamic_rescale: bool = False, device=None) -> DiffusionSchedule:
    """The full schedule (defaults = configs/inference_t2v_512_v2.0.yaml).
    DynamiCrafter's: `rescale_betas_zero_snr`, `parameterization="v"`,
    `ddim_discretize="uniform_trailing"`, and `dynamic_rescale` with
    `scale_b` its base_scale (use_scale on: the same ramp, and the first DDIM
    step's previous scale is its own, ddim.py's
    `cat([ddim_scale_arr[0:1], ddim_scale_arr[:-1]])`)."""
    if parameterization not in ("eps", "v"):
        raise ValueError(f"parameterization '{parameterization}' unknown")
    device = resolve_device(device)
    use_scale = use_scale or dynamic_rescale
    betas = make_beta_schedule(beta_schedule, num_timesteps, linear_start,
                               linear_end, cosine_s)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    ddim_ts = make_ddim_timesteps(ddim_discretize, ddim_num_steps, num_timesteps)
    sigmas, ddim_alphas, ddim_alphas_prev = make_ddim_sampling_parameters(
        alphas_cumprod, ddim_ts, ddim_eta)
    scale_arr = (make_scale_arr(num_timesteps, scale_a, scale_b, mid_step, fix_scale_bug)
                 if use_scale else np.ones(num_timesteps, dtype=np.float64))
    ddim_scale_arr = scale_arr[ddim_ts]
    first_prev = ddim_scale_arr[:1] if dynamic_rescale else scale_arr[:1]
    ddim_scale_arr_prev = np.concatenate([first_prev, scale_arr[ddim_ts[:-1]]])

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        scale_arr=f32(scale_arr),
        ddim_timesteps=torch.as_tensor(ddim_ts, dtype=torch.int64, device=device),
        ddim_alphas=f32(ddim_alphas),
        ddim_alphas_prev=f32(ddim_alphas_prev),
        ddim_sigmas=f32(sigmas),
        ddim_sqrt_one_minus_alphas=f32(np.sqrt(1.0 - ddim_alphas)),
        ddim_scale_arr=f32(ddim_scale_arr),
        ddim_scale_arr_prev=f32(ddim_scale_arr_prev),
        ddim_timesteps_np=np.asarray(ddim_ts, np.int64),
        use_scale=use_scale,
        parameterization=parameterization,
        ddim_sqrt_alphas=f32(np.sqrt(ddim_alphas)) if parameterization == "v" else None,
    )
