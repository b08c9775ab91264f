"""Base DDIM sampler, classifier-free guidance and the port's noise source.

Port of moca_tpu/sampling/ddim.py: `shared_normal`, `expand_context`,
`make_cfg_eps_fn` (cond/uncond rows interleaved; the `uc_type` variants and
temporal guidance), `ddim_step_math` with `use_scale`, `ddim_sample`,
`stochastic_encode`, `ddim_decode` and `ddim_invert_frames`. The
reference's `lax.scan` over steps is a Python loop.

Noise. Every draw of the port goes through one callable
`normal(tag, shape) -> float32 tensor`, where `tag` names the draw with its
indices (e.g. ("fifo", i, "win", r, "frame", j)). `GeneratorNormal` backs it
with a seeded torch.Generator; a test can pass a callable that replays the
JAX package's key layout (docs/RNG.md) so that both packages consume the
same numbers.

DynamiCrafter's additions: the v-parameterization in `ddim_step_math`
(the schedule says which), guidance rescale (`rescale_noise_cfg`) and the
image latent concatenated to the input of every guided row (`c_concat`) in
`make_cfg_eps_fn`.

Trace ranges (utils/profiling.py `annotate`): `sampler.ddim` around each
DDIM step, `sampler.cfg` around each guided noise prediction, the U-Net
call inside it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from moca_tpu_torch.schedule import DiffusionSchedule
from moca_tpu_torch.utils.profiling import annotate

Normal = Callable[[tuple, tuple], torch.Tensor]


class GeneratorNormal:
    """`normal(tag, shape)` drawn in call order from one seeded generator."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self, tag: tuple, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def get_state(self) -> torch.Tensor:
        """The generator's position (a CPU uint8 tensor, CUDA generators too):
        a resumed run restores it to draw what the killed run would have."""
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(torch.as_tensor(state, dtype=torch.uint8).cpu())


def shared_normal(normal: Normal, tag: tuple, shape) -> torch.Tensor:
    """Noise shared across the leading batch axis: draw [1, ...] and
    broadcast, so a B-row batch consumes the same numbers as B=1."""
    one = normal(tag, (1,) + tuple(shape[1:]))
    return one.expand(tuple(shape))


def expand_context(context: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-row conditioning for a flat window batch. FIFO flattens windows
    row-major over (window, prompt) (fifo.fifo_step), so a [B, L, D]
    context tiles prompt-minor to cover rows = R*B (`jnp.tile`, i.e.
    `Tensor.repeat`); a [1, L, D] context broadcasts."""
    bc = context.shape[0]
    if bc == rows:
        return context
    if bc == 1:
        return context.expand((rows,) + tuple(context.shape[1:]))
    if rows % bc:
        raise ValueError(f"a {bc}-row context for {rows} rows")
    return context.repeat((rows // bc,) + (1,) * (context.ndim - 1))


def rescale_noise_cfg(guided: torch.Tensor, cond: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """Guidance rescale (Lin et al., section 3.4; DynamiCrafter's
    samplers/ddim.py): the guided output scaled to the conditional output's
    standard deviation over every axis but the batch, blended with the
    unscaled one by `guidance_rescale`."""
    dims = tuple(range(1, guided.ndim))
    ratio = cond.std(dim=dims, keepdim=True) / guided.std(dim=dims, keepdim=True)
    return guidance_rescale * guided * ratio + (1.0 - guidance_rescale) * guided


def make_cfg_eps_fn(unet_apply: Callable, context: torch.Tensor,
                    uncond_context: Optional[torch.Tensor], guidance_scale: float,
                    fps=16, uc_type: Optional[str] = None,
                    temporal_guidance_scale: Optional[float] = None,
                    guidance_rescale: float = 0.0,
                    c_concat: Optional[torch.Tensor] = None) -> Callable:
    """eps_fn(x, t_frames) with classifier-free guidance fused into one
    U-Net call. Rows are INTERLEAVED: row 2i = cond_i, row 2i+1 = uncond_i.

    uc_type: None (standard CFG) | 'cfg_original' | 'cfg_ours'
    (ddim.py:303-311). temporal_guidance_scale adds
    s_t * (e_temporal - e_no_temporal_attn) from two more cond-only U-Net
    calls, the second with the temporal transformers skipped
    (`unet_apply(..., no_temporal_attn=True)`). guidance_rescale > 0
    rescales standard CFG's output (`rescale_noise_cfg`). c_concat
    [B or 1, T, h, w, Cc]: concatenated to the input of every row, the
    unconditional rows too (the hybrid conditioning, passed to
    `unet_apply(..., c_concat=...)`)."""
    if uc_type not in (None, "cfg_original", "cfg_ours"):
        raise NotImplementedError(uc_type)
    if guidance_rescale and (uc_type is not None or temporal_guidance_scale is not None):
        raise NotImplementedError("guidance_rescale rescales standard CFG only")
    if c_concat is not None and temporal_guidance_scale is not None:
        raise NotImplementedError("temporal guidance takes no c_concat")

    def unet(x, t_frames, ctx, rows=1):
        """The U-Net on x, whose rows are `rows` interleaved copies of each
        row of the batch."""
        if c_concat is None:
            return unet_apply(x, t_frames, ctx, fps)
        c = expand_context(c_concat, x.shape[0] // rows)
        c = torch.stack([c] * rows, dim=1).reshape((x.shape[0],) + tuple(c.shape[1:]))
        return unet_apply(x, t_frames, ctx, fps, c_concat=c)

    def combine(e_c, e_u):
        if uc_type is None:
            guided = e_u + guidance_scale * (e_c - e_u)
            return rescale_noise_cfg(guided, e_c, guidance_rescale) if guidance_rescale else guided
        if uc_type == "cfg_original":
            return e_c + guidance_scale * (e_c - e_u)
        return e_c + guidance_scale * (e_u - e_c)

    def with_temporal_term(eps, x, t_frames):
        if temporal_guidance_scale is None:
            return eps
        ctx = expand_context(context, x.shape[0])
        e_t = unet_apply(x, t_frames, ctx, fps)
        e_i = unet_apply(x, t_frames, ctx, fps, no_temporal_attn=True)
        return eps + temporal_guidance_scale * (e_t - e_i)

    def eps_fn(x, t_frames):
        with annotate("sampler.cfg"):
            if uncond_context is None or guidance_scale == 1.0:
                eps = unet(x, t_frames, expand_context(context, x.shape[0]))
                return with_temporal_term(eps, x, t_frames)
            b = x.shape[0]
            x2 = torch.stack([x, x], dim=1).reshape((2 * b,) + tuple(x.shape[1:]))
            t2 = torch.stack([t_frames, t_frames], dim=1).reshape(
                (2 * b,) + tuple(t_frames.shape[1:]))
            ctx2 = torch.stack([expand_context(context, b),
                                expand_context(uncond_context, b)], dim=1)
            ctx2 = ctx2.reshape((2 * b,) + tuple(context.shape[1:]))
            eps = unet(x2, t2, ctx2, rows=2).reshape((b, 2) + tuple(x.shape[1:]))
            return with_temporal_term(combine(eps[:, 0], eps[:, 1]), x, t_frames)

    return eps_fn


def _gather(arr: torch.Tensor, index, like: torch.Tensor) -> torch.Tensor:
    """arr[index] shaped to broadcast over `like` (index scalar or [.., f])."""
    index = torch.as_tensor(index, device=arr.device)
    return arr[index].reshape(tuple(index.shape) + (1,) * (like.ndim - index.ndim - 1))


def ddim_step_math(sch: DiffusionSchedule, x: torch.Tensor, eps: torch.Tensor, index,
                   noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM update (p_sample_ddim, ddim.py:332-357) including use_scale.
    `index` is a scalar or a per-frame index array that broadcasts over x.
    `eps` is the model's output: with a v-parameterized schedule, v, from
    which eps = sqrt(a) v + sqrt(1 - a) x and x0 = sqrt(a) x - sqrt(1 - a) v
    (DynamiCrafter's predict_eps_from_z_and_v, predict_start_from_z_and_v),
    so that the step is defined at a = 0, the zero-SNR schedule's last
    timestep."""
    a_prev = _gather(sch.ddim_alphas_prev, index, x)
    sigma = _gather(sch.ddim_sigmas, index, x)
    sqrt_1ma = _gather(sch.ddim_sqrt_one_minus_alphas, index, x)

    if sch.parameterization == "v":
        sqrt_a = _gather(sch.ddim_sqrt_alphas, index, x)
        eps, pred_x0 = sqrt_a * eps + sqrt_1ma * x, sqrt_a * x - sqrt_1ma * eps
    else:
        pred_x0 = (x - sqrt_1ma * eps) / torch.sqrt(_gather(sch.ddim_alphas, index, x))
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps
    if sch.use_scale:
        pred_x0 = pred_x0 / _gather(sch.ddim_scale_arr, index, x)
        scale_prev = _gather(sch.ddim_scale_arr_prev, index, x)
        x_prev = torch.sqrt(a_prev) * scale_prev * pred_x0 + dir_xt + sigma * noise
    else:
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise
    return x_prev, pred_x0


def _ddim_steps(eps_fn: Callable, sch: DiffusionSchedule, x: torch.Tensor, steps: int,
                normal: Normal, tag: tuple, temperature: float = 1.0) -> torch.Tensor:
    """DDIM from schedule index steps-1 down to 0; step i draws
    tag+("step", i), shared across the batch."""
    b, t = x.shape[0], x.shape[1]
    for i in range(steps):
        with annotate("sampler.ddim"):
            index = steps - 1 - i
            t_frames = torch.full((b, t), int(sch.ddim_timesteps_np[index]),
                                  dtype=torch.long, device=x.device)
            eps = eps_fn(x, t_frames)
            noise = temperature * shared_normal(normal, tag + ("step", i), x.shape)
            x, _ = ddim_step_math(sch, x, eps, index, noise)
    return x


def ddim_sample(eps_fn: Callable, sch: DiffusionSchedule, shape: Tuple[int, ...],
                normal: Normal, tag: tuple = ("base",),
                x_T: Optional[torch.Tensor] = None, temperature: float = 1.0):
    """Full DDIM sampling; shape [B, T, H, W, C]. Returns (x0_latent, x_T).
    Draws: tag+("init",) for x_T unless it is given, tag+("step", i) for
    step i's sigma-noise (scaled by `temperature`)."""
    if x_T is None:
        x_T = shared_normal(normal, tag + ("init",), shape)
    x0 = _ddim_steps(eps_fn, sch, x_T, sch.num_ddim_steps, normal, tag, temperature)
    return x0, x_T


def stochastic_encode(sch: DiffusionSchedule, x0: torch.Tensor, index,
                      noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) at DDIM step `index` (ddim.py:651-671)."""
    a = _gather(sch.ddim_alphas, index, x0)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def ddim_decode(eps_fn: Callable, sch: DiffusionSchedule, x_latent: torch.Tensor,
                t_start: int, normal: Normal, tag: tuple = ("decode",)) -> torch.Tensor:
    """Partial DDIM sampling of a partially noised latent [B, T, h, w, C]
    from schedule index t_start-1 down to 0 (`DDIMSampler.decode`,
    ddim.py:673-692): `ddim_sample`'s steps over the first t_start
    schedule entries. Step i draws tag+("step", i)."""
    return _ddim_steps(eps_fn, sch, x_latent, t_start, normal, tag)


def ddim_invert_frames(sch: DiffusionSchedule, clean_latents: torch.Tensor,
                       normal: Normal, tag: tuple = ("invert",)) -> torch.Tensor:
    """The reference's closed-form 'DDIM inversion' (ddim.py:972-1032):
    schedule step i takes frame max(0, i-(S-T0)) of clean_latents
    [B, T0, h, w, C] and noises it to level alpha_i, giving the
    [B, S, h, w, C] diagonal stack that seeds a FIFO queue. One draw `tag`
    of the whole stack (a fresh randn per step in the reference)."""
    steps, t0 = sch.num_ddim_steps, clean_latents.shape[1]
    frame_idx = torch.as_tensor(np.maximum(0, np.arange(steps) - (steps - t0)),
                                device=clean_latents.device)
    frames = clean_latents[:, frame_idx]
    noise = normal(tag, tuple(frames.shape)).to(frames.dtype)
    return stochastic_encode(sch, frames, np.arange(steps), noise)
