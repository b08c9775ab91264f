"""FIFO-Diffusion diagonal denoising engine.

Port of moca_tpu/sampling/fifo.py. The queue is a device tensor
[B, Q, h, w, C] (Q = f*n, plus f/2 with lookahead). All 2n lookahead windows
(x cond/uncond for CFG) go through ONE batched U-Net call — equivalent to the
reference's reversed-rank sweep with immediate write-back, since window r
only writes slots above every lower-rank read range (see the reference
module). The per-window MoCA steps and the write-back follow; the FreeInit
tail shift refills the queue. Static index maps live in numpy in `FIFOPlan`.

The MoCA step takes one of two routes, by the queue's device alone. On a
CUDA device, one kernel launch (ops/moca_scan.py, float32 only; it refuses
any other type) runs every window's step and writes the new queue (and
pred_x0) in the write-back's tiling; its frame and slot tables are built
once for each schedule, setting and device and kept with the plan. On the
CPU, the per-window loop of `moca_window_step` and the write-back's
concatenation. Both draw the same noise, tag+("win", r, "frame", j),
r-major and j-minor.

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
from moca_tpu_torch.ops.moca_scan import moca_scan
from moca_tpu_torch.sampling.moca import MoCAConfig, moca_frame_table, moca_window_step
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
    # the one-launch step's tables on the device (`scan_tables`), by
    # (id of the schedule, settings, device); each holds its schedule, so
    # that id names no other schedule while the plan lives
    tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

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

    def scan_slots(self) -> np.ndarray:
        """[R, f, 3] int32 (ops/moca_scan.py `SLOT_COLUMNS`): for frame j of
        window r, the queue slot it reads (start + j), the slot its output
        lands in and 1 where that output is the old value. Window r commits
        its frames from f/2 (lookahead) or 0 on, the tiling of
        `_scatter_windows`; with lookahead, window 0's frames [0, f/2) land
        in the immutable prefix [0, f/2), the queue keeping its old values
        and pred_x0 taking the window's (`scatter_pred_x0`). Every other
        frame lands nowhere (-1)."""
        j = np.arange(self.f)[None, :]
        committed = j >= (self.f // 2 if self.lookahead else 0)
        lands = committed | (np.arange(self.num_windows) == 0)[:, None]
        src = self.window_starts[:, None] + j
        return np.stack([src, np.where(lands, src, -1), lands & ~committed],
                        axis=-1).astype(np.int32)


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
    pre-injection pred_x0 (scatter_pred_x0) for a host-side mask provider.
    A queue on a CUDA device takes one kernel launch for every window's step
    (`_moca_scan_step`); a CPU queue the loop."""
    R, B, f = plan.num_windows, latents.shape[0], plan.f
    with annotate("sampler.windows"):
        windows = _gather_windows(latents, plan)               # [R, B, f, h, w, C]
        flat_x = windows.reshape((R * B, f) + tuple(windows.shape[3:]))
        flat_t = torch.as_tensor(np.repeat(plan.window_timesteps(), B, axis=0),
                                 device=latents.device)
    eps = eps_window_fn(flat_x, flat_t).reshape(windows.shape)

    with annotate("sampler.moca"):
        if latents.is_cuda:
            new_latents, pred = _moca_scan_step(sch, plan, moca_cfg, latents, eps, normal, tag,
                                                cond_image, masks, masks_are_davis,
                                                with_pred_x0)
        else:
            new_latents, pred = _moca_window_loop(sch, plan, moca_cfg, latents, windows, eps,
                                                  normal, tag, cond_image, masks,
                                                  masks_are_davis, gamma, with_pred_x0)
        head = new_latents[:, plan.head_slot]
        if with_pred_x0:
            return new_latents, head, pred
        return new_latents, head


def _moca_window_loop(sch, plan, moca_cfg, latents, windows, eps, normal, tag, cond_image,
                      masks, masks_are_davis, gamma, with_pred_x0):
    """(new queue, queue-aligned pred_x0 or None): `moca_window_step` for each
    window, then the write-back's concatenation."""
    w_ts, w_idx = plan.window_timesteps(), plan.window_indices()
    w_masks = None if masks is None else _gather_windows(masks, plan)
    x_prev, pred_pre = [], []
    for r in range(plan.num_windows):
        out = moca_window_step(
            sch, moca_cfg, windows[r], eps[r], w_idx[r], w_ts[r], normal, tag + ("win", r),
            cond_image=cond_image, masks=None if w_masks is None else w_masks[r],
            masks_are_davis=masks_are_davis, gamma=gamma, with_preinject=with_pred_x0)
        x_prev.append(out[0])
        if with_pred_x0:
            pred_pre.append(out[2])
    new_latents = _scatter_windows(latents, x_prev, plan)
    return new_latents, scatter_pred_x0(pred_pre, plan) if with_pred_x0 else None


def draw_window_noise(normal: Normal, tag: tuple, plan: FIFOPlan, frame_shape: tuple,
                      device) -> torch.Tensor:
    """[R, f, *frame_shape] float32 on `device`: every window's step noise,
    frame j of window r the draw tag+("win", r, "frame", j) of shape
    [1, *frame_shape], in the loop's order (r-major, j-minor), so that a
    generator gives both routes the same numbers."""
    frame_shape = tuple(frame_shape)
    draws = [shared_normal(normal, tag + ("win", r, "frame", j), (1,) + frame_shape)[0]
             for r in range(plan.num_windows) for j in range(plan.f)]
    noise = torch.stack(draws).to(device=device, dtype=torch.float32)
    return noise.view((plan.num_windows, plan.f) + frame_shape)


def scan_tables(sch: DiffusionSchedule, plan: FIFOPlan, cfg: MoCAConfig, masks_are_davis: bool,
                have_masks: bool, device) -> tuple:
    """(frame table [R, f, 9] float32, slots [R, f, 3] int32) on `device` for
    the one-launch step, built on the host and copied once for each
    schedule, setting and device, and kept in `plan.tables`; later calls
    find them there. The first call reads the schedule's scalars to the
    host (one wait for the device, in the run's first iteration)."""
    key = (id(sch), cfg, masks_are_davis, have_masks, str(device))
    if key not in plan.tables:
        table = moca_frame_table(sch, cfg, plan.window_indices(), plan.window_timesteps(),
                                 masks_are_davis, have_masks)
        plan.tables[key] = (sch, (torch.as_tensor(table, device=device),
                                  torch.as_tensor(plan.scan_slots(), device=device)))
    return plan.tables[key][1]


def _moca_scan_step(sch, plan, moca_cfg, latents, eps, normal, tag, cond_image, masks,
                    masks_are_davis, with_pred_x0):
    """(new queue, queue-aligned pred_x0 or None) from one launch of the
    kernel. Injection reaches the queue only with `inject_into_queue` (else
    it changes only the blended pred_x0, which FIFO discards), so the masks
    and the concept image go to the kernel only then."""
    table, slots = scan_tables(sch, plan, moca_cfg, masks_are_davis, masks is not None,
                               latents.device)
    noise = draw_window_noise(normal, tag, plan, latents.shape[2:], latents.device)
    inject = masks is not None and moca_cfg.enable_injection and moca_cfg.inject_into_queue
    return moca_scan(latents, eps, noise, table, slots, masks=masks if inject else None,
                     cond=cond_image if inject else None, beta=moca_cfg.beta,
                     dir_weight=moca_cfg.dir_weight, with_pred=with_pred_x0)


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
