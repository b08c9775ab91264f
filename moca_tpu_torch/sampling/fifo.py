"""FIFO-Diffusion diagonal denoising engine.

Port of moca_tpu/sampling/fifo.py. The queue is a device tensor
[B, Q, h, w, C] (Q = f*n, plus f/2 with lookahead). All 2n lookahead windows
(x cond/uncond for CFG) go through ONE batched U-Net call — equivalent to the
reference's reversed-rank sweep with immediate write-back, since window r
only writes slots above every lower-rank read range (see the reference
module). The per-window MoCA steps and the write-back follow; the FreeInit
tail shift refills the queue. Static index maps live in numpy in `FIFOPlan`.
Trace ranges (utils/profiling.py `annotate`) in `fifo_step`:
`sampler.windows` (the window gather and the timesteps' upload) and
`sampler.moca` (every window's MoCA step and the write-back).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from moca_tpu_torch import freeinit
from moca_tpu_torch.sampling.ddim import Normal, shared_normal, stochastic_encode
from moca_tpu_torch.sampling.moca import MoCAConfig, moca_window_step
from moca_tpu_torch.schedule import DiffusionSchedule
from moca_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class FIFOPlan:
    """Static window/queue geometry for a (f, n, lookahead) configuration."""

    video_length: int          # f
    num_partitions: int        # n
    lookahead: bool
    timesteps: np.ndarray      # [Q] DDPM timestep per queue slot (noisiest last)
    indices: np.ndarray        # [Q] DDIM schedule index per queue slot

    @property
    def f(self) -> int:
        return self.video_length

    @property
    def num_steps(self) -> int:
        return self.video_length * self.num_partitions

    @property
    def queue_length(self) -> int:
        return self.timesteps.shape[0]

    @property
    def num_windows(self) -> int:
        return 2 * self.num_partitions if self.lookahead else self.num_partitions

    @property
    def window_starts(self) -> np.ndarray:
        stride = self.f // 2 if self.lookahead else self.f
        return np.arange(self.num_windows) * stride

    @property
    def head_slot(self) -> int:
        """Queue slot decoded as the output frame (funcs.py:359)."""
        return self.f // 2 if self.lookahead else 0

    def window_timesteps(self) -> np.ndarray:
        """[R, f] per-window DDPM timesteps."""
        return np.stack([self.timesteps[s: s + self.f] for s in self.window_starts])

    def window_indices(self) -> np.ndarray:
        return np.stack([self.indices[s: s + self.f] for s in self.window_starts])


def make_fifo_plan(sch_ddim_timesteps: np.ndarray, video_length: int,
                   num_partitions: int, lookahead: bool = True) -> FIFOPlan:
    """funcs.py:290-294: extend (timesteps, indices) with an f/2 prefix of the
    cleanest level when lookahead denoising is on."""
    f = video_length
    steps = f * num_partitions
    if np.asarray(sch_ddim_timesteps).shape[0] != steps:
        raise ValueError("num_inference_steps must be f*n")
    timesteps = np.asarray(sch_ddim_timesteps)
    indices = np.arange(steps)
    if lookahead:
        timesteps = np.concatenate([np.full(f // 2, timesteps[0]), timesteps])
        indices = np.concatenate([np.full(f // 2, 0), indices])
    return FIFOPlan(f, num_partitions, lookahead, timesteps.astype(np.int64),
                    indices.astype(np.int64))


def advance_prompt_index(i: int, num_steps: int, video_length: int, cum_lengths,
                         j: int) -> int:
    """Multi-prompt scene switching: advance the active prompt when the
    output-frame counter passes the cumulative scene length (funcs.py:425-431;
    clamped at the last prompt)."""
    if i - (num_steps - video_length) >= cum_lengths[j] and j + 1 < len(cum_lengths):
        return j + 1
    return j


def queue_frame_indices(plan: FIFOPlan, num_source_frames: int):
    """(frame_idx[Q], ddim_idx[Q]): slot i holds frame max(0, i-(S-T0)) at
    alpha_i; lookahead prepends f/2 copies of frame 0 at alpha_0."""
    steps, t0 = plan.num_steps, num_source_frames
    frame_idx = np.maximum(0, np.arange(steps) - (steps - t0))
    idx = np.arange(steps)
    if plan.lookahead:
        frame_idx = np.concatenate([np.zeros(plan.f // 2, np.int64), frame_idx])
        idx = np.concatenate([np.zeros(plan.f // 2, np.int64), idx])
    return frame_idx, idx


def prepare_queue(sch: DiffusionSchedule, plan: FIFOPlan, clean_latents: torch.Tensor,
                  normal: Normal, tag: tuple = ("queue",)) -> torch.Tensor:
    """The diagonal queue [B, Q, h, w, C] (funcs.py:21-82), one noise draw."""
    frame_idx, idx = queue_frame_indices(plan, clean_latents.shape[1])
    frames = clean_latents[:, torch.as_tensor(frame_idx, device=clean_latents.device)]
    noise = shared_normal(normal, tag, frames.shape).to(frames.dtype)
    return stochastic_encode(sch, frames, idx, noise)


def shift_queue(latents: torch.Tensor, normal: Normal, tag: tuple,
                anchor: Optional[torch.Tensor] = None, filter_type: str = "gaussian",
                tail_mode: str = "freeinit") -> torch.Tensor:
    """Pop the head, push a new tail (funcs.py:86-99).

    "freeinit": the tail keeps the low frequencies of the anchor [B, h, w, C]
    (queue slot 0 by default; the re-encoded last real frame in DAVIS mode)
    and takes fresh noise's high frequencies through a `filter_type` LPF,
    d_s = d_t = 0.25 (scripts/evaluation/funcs.py:95-97). "plain": the tail
    is pure fresh noise and the anchor is unused (funcs_mp.py:39-46)."""
    if tail_mode == "plain":
        tail = shared_normal(normal, tag, latents[:, :1].shape).to(latents.dtype)
        return torch.cat([latents[:, 1:], tail], dim=1)
    if tail_mode != "freeinit":
        raise ValueError(f"unknown tail_mode {tail_mode!r}")
    if anchor is None:
        anchor = latents[:, 0]
    _, h, w, _ = anchor.shape
    lpf = freeinit.get_freq_filter((1, h, w), filter_type, 1, 0.25, 0.25, device=anchor.device)
    noise = shared_normal(normal, tag, anchor.shape).to(anchor.dtype)
    # [B,h,w,C] -> [B,C,1,h,w] for the (T,H,W) fft axes, then back
    a = anchor.permute(0, 3, 1, 2)[:, :, None]
    n = noise.permute(0, 3, 1, 2)[:, :, None]
    tail = freeinit.freq_mix_3d(a, n, lpf)[:, :, 0].permute(0, 2, 3, 1)
    return torch.cat([latents[:, 1:], tail[:, None]], dim=1)


def shift_masks(masks: torch.Tensor, new_tail: torch.Tensor) -> torch.Tensor:
    """DAVIS mask queue shift (funcs.py:115-116)."""
    return torch.cat([masks[:, 1:], new_tail[:, None]], dim=1)


def _gather_windows(latents: torch.Tensor, plan: FIFOPlan) -> torch.Tensor:
    """[B, Q, ...] -> [R, B, f, ...]."""
    return torch.stack([latents[:, s: s + plan.f] for s in plan.window_starts], dim=0)


def _scatter_windows(latents: torch.Tensor, x_prev: torch.Tensor,
                     plan: FIFOPlan) -> torch.Tensor:
    """Write back denoised windows (funcs.py:351-354). With lookahead, window
    r commits only its second half [f/2, f), tiling the queue above the
    immutable f/2 prefix."""
    if plan.lookahead:
        half = plan.f // 2
        parts = [latents[:, :half]] + [x_prev[r][:, half:] for r in range(plan.num_windows)]
    else:
        parts = [x_prev[r] for r in range(plan.num_windows)]
    return torch.cat(parts, dim=1)


def fifo_step(eps_window_fn: Callable, sch: DiffusionSchedule, plan: FIFOPlan,
              moca_cfg: MoCAConfig, latents: torch.Tensor, normal: Normal, tag: tuple,
              cond_image: Optional[torch.Tensor] = None,
              masks: Optional[torch.Tensor] = None, masks_are_davis: bool = True,
              gamma: Optional[float] = None, with_pred_x0: bool = False):
    """One FIFO iteration: denoise all windows in one U-Net batch, run the
    MoCA step per window (draws tag+("win", r, "frame", j)), write back.
    `masks` are queue-aligned [B, Q, h, w, 1], DAVIS masks or, with
    `masks_are_davis=False`, a mask provider's. Returns (new_queue,
    head_latent), and with `with_pred_x0` also the queue-aligned
    pre-injection pred_x0 (scatter_pred_x0) for a host-side mask provider."""
    R, B, f = plan.num_windows, latents.shape[0], plan.f
    with annotate("sampler.windows"):
        windows = _gather_windows(latents, plan)               # [R, B, f, h, w, C]
        w_ts, w_idx = plan.window_timesteps(), plan.window_indices()
        flat_x = windows.reshape((R * B, f) + tuple(windows.shape[3:]))
        flat_t = torch.as_tensor(np.repeat(w_ts, B, axis=0), device=latents.device)
    eps = eps_window_fn(flat_x, flat_t).reshape(windows.shape)

    with annotate("sampler.moca"):
        w_masks = None if masks is None else _gather_windows(masks, plan)
        x_prev, pred_pre = [], []
        for r in range(R):
            out = moca_window_step(
                sch, moca_cfg, windows[r], eps[r], w_idx[r], w_ts[r], normal, tag + ("win", r),
                cond_image=cond_image, masks=None if w_masks is None else w_masks[r],
                masks_are_davis=masks_are_davis, gamma=gamma, with_preinject=with_pred_x0)
            x_prev.append(out[0])
            if with_pred_x0:
                pred_pre.append(out[2])
        new_latents = _scatter_windows(latents, x_prev, plan)
        head = new_latents[:, plan.head_slot]
        if with_pred_x0:
            return new_latents, head, scatter_pred_x0(pred_pre, plan)
        return new_latents, head


def scatter_pred_x0(pred, plan: FIFOPlan) -> torch.Tensor:
    """Queue-aligned pred_x0 from the windows' [R][B, f, ...]: the tiling of
    `_scatter_windows`, except that the lookahead prefix (slots [0, f/2),
    which no window commits) comes from window 0's first half, as the
    reference's per-frame segmentation sees those frames (funcs.py:306)."""
    if plan.lookahead:
        half = plan.f // 2
        parts = [pred[0][:, :half]] + [pred[r][:, half:] for r in range(plan.num_windows)]
    else:
        parts = [pred[r] for r in range(plan.num_windows)]
    return torch.cat(parts, dim=1)
