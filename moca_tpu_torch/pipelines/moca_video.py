"""MoCA-Video pipeline: base sample or real video -> FIFO diagonal queue ->
per-step concept injection -> batched head decode.

Port of moca_tpu/pipelines/moca_video.py:
  * conditioning with the `conditioned_prompt` token concat (:287-300) and,
    with `multiprompts`, one context per scene switched at frame boundaries
    (:303-313, 357-359; funcs.py:375-468);
  * the base DDIM latents with the reference's cache `{steps}.npz` under
    `latents_dir` (:199-222), or the encoded frames of a real video
    (`clean_latents`, DAVIS mode);
  * the FIFO loop (`_fifo_iteration` :98-142): CFG-fused U-Net over all
    windows, per-window MoCA step, write-back, FreeInit tail shift; in DAVIS
    mode the tail keeps the low frequencies of the last real frame, drawn
    afresh from its posterior on every shift (`davis_frames`, :119-138,
    :327-330);
  * masks: queue-aligned DAVIS `masks` shifted every iteration (:334-340),
    or an open-vocab `mask_provider` fed each iteration's low-t pred_x0 on
    the host (`_pull_masks`, :149-178, 333-348, 472-504). Given masks take
    precedence over a provider, as in the reference;
  * mid-run snapshots `fifo_state.npz` every `checkpoint_every` iterations
    (:372-431), and the batched head decode with a padded final flush
    (:419-439), `frame_callback` and `viz`;
  * B > 1 prompts (:227-300): the B streams share one queue [B, Q, h, w, C],
    one U-Net batch of 2*R*B rows an iteration and the noise (a draw is
    [1, ...] broadcast over B), so stream b equals a B=1 run of prompt b with
    the same noise; the base-latent cache holds the B batch. Masks, DAVIS,
    multiprompts, a provider and viz carry per-stream host state and need
    B = 1, as in the reference;
  * a `mesh` (parallel/mesh.py, one process a GPU): every rank runs the
    whole loop with the same noise, and only the U-Net's 2*R*B rows (padded
    to the next multiple of the mesh size, :113-115) and the head decode's
    rows (where they tile the mesh, :191-194) are split over the ranks and
    gathered. Rank 0 alone writes the base-latent cache and the snapshot
    (a barrier follows each write; every rank reads them), runs the
    open-vocab provider and broadcasts its masks, and feeds `viz`;
  * the stages' seconds in a `StepTimer` (utils/profiling.py), read as
    `timings`, with one `{"profile": ...}` line at the end when
    MOCA_TPU_PROFILE=1 (:360-507); the trace range `sampler.shift` around
    each iteration's anchor draw and queue shift.

Noise: every draw goes through `normal(tag, shape)` (sampling/ddim.py):
("base", ...) for the base sample, ("queue",) for the queue and
("fifo", i, ...) for iteration i, ("fifo", i, "anchor") its DAVIS anchor.
A snapshot also holds the position of a `GeneratorNormal`, so a resumed run
draws what the killed run would have.

Open vocab with `seg_async`: each iteration's low-t pred_x0 is copied into
pinned host memory behind it (an event marks the copy's end). Before
iteration i is launched, a worker thread takes iteration i-1's copy and runs
the provider on it while this thread launches iteration i and the card
computes it; the masks feed iteration i+1 (lag 2). The worker is needed:
launching an iteration's kernels blocks on CUDA's full launch queue
until the card is nearly done with it, so the launching thread has no time
to spare (on an H100 80GB at 700 W one iteration's launch returned after
1.113 s of its 1.113 s on the device; chip_smoke.py phase 7 measures this
and the overlap). What hides is the provider's host time: a provider that
launches CUDA work from the worker puts it on the same default stream,
behind the iteration just launched. Without `seg_async`
the host waits for iteration i's copy, runs the provider and then launches
iteration i+1 with its masks (lag 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from moca_tpu_torch.io.segmentation import latent_to_uint8_frame
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.parallel.mesh import (
    barrier, broadcast_from_lead, is_lead, make_sharded_unet_apply, map_tiled_rows,
)
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal, Normal, make_cfg_eps_fn
from moca_tpu_torch.sampling.fifo import (
    FIFOPlan, advance_prompt_index, fifo_step, make_fifo_plan, prepare_queue,
    queue_frame_indices, shift_masks, shift_queue,
)
from moca_tpu_torch.sampling.moca import MoCAConfig
from moca_tpu_torch.schedule import make_schedule
from moca_tpu_torch.utils.profiling import StepTimer, annotate

SNAPSHOT = "fifo_state.npz"


@dataclasses.dataclass(eq=False)
class MoCAVideoPipeline:
    """End-to-end semantic mixing. Defaults follow videocrafter_main.py flags."""

    model: LatentDiffusion
    tokenizer: object
    video_length: int = 16            # f (videocrafter_main.py:240)
    num_partitions: int = 4           # n (:241)
    new_video_length: int = 100       # N (:244)
    guidance_scale: float = 12.0      # (:251)
    eta: float = 1.0                  # (:253)
    fps: int = 10                     # (:250)
    lookahead_denoising: bool = True  # (:252)
    moca: MoCAConfig = dataclasses.field(default_factory=MoCAConfig)
    use_scale: bool = True
    mesh: Optional[object] = None     # parallel.mesh.make_mesh: split the rows over ranks
    decode_batch: int = 8             # head frames per batched VAE call
    checkpoint_every: int = 0         # snapshot every N iterations; 0 = off
    tail_mode: str = "freeinit"       # funcs.py:86-99 | funcs_mp.py:39-46
    uncond_type: str = "empty_seq"    # ddpm3d.py:397 empty_seq | zero_embed
    seg_async: bool = True            # open vocab: provider under the next iteration

    def __post_init__(self):
        self.num_inference_steps = self.video_length * self.num_partitions
        self.sch = make_schedule(ddim_num_steps=self.num_inference_steps, ddim_eta=self.eta,
                                 use_scale=self.use_scale, device=self.model.device)
        self.plan: FIFOPlan = make_fifo_plan(self.sch.ddim_timesteps_np, self.video_length,
                                             self.num_partitions, self.lookahead_denoising)
        self.base = T2VPipeline(self.model, self.sch, self.tokenizer,
                                guidance_scale=self.guidance_scale, fps=self.fps,
                                uncond_type=self.uncond_type, mesh=self.mesh)
        self.timer = StepTimer()

    @property
    def timings(self) -> dict:
        """Seconds of the last call's stages."""
        return self.timer.totals()

    def _stage(self, name: str, t0: float, sync: bool = True) -> float:
        """Add the time since t0 to stage `name` (device work included
        unless `sync` is off)."""
        return self.timer.record(name, t0, self.model.device, sync)

    def _num_low_t_slots(self) -> int:
        """Queue slots with t <= inject_threshold (a prefix: the queue's
        noise levels ascend)."""
        return int(np.sum(self.plan.timesteps <= self.moca.inject_threshold))

    def _fifo_iteration(self, latents, ctx, uc, cond, mask_queue, masks_are_davis, gamma,
                        normal, i, want_pred=False, anchor=None):
        """(queue, ...) -> (shifted queue, head latent, low-t pred_x0 or None)."""
        unet_apply = self.model.apply_unet
        if self.mesh is not None:
            unet_apply = make_sharded_unet_apply(unet_apply, self.mesh)
        eps_fn = make_cfg_eps_fn(unet_apply, ctx, uc, self.guidance_scale, fps=self.fps)
        result = fifo_step(
            eps_fn, self.sch, self.plan, self.moca, latents, normal, ("fifo", i),
            cond_image=cond, masks=mask_queue, masks_are_davis=masks_are_davis, gamma=gamma,
            with_pred_x0=want_pred)
        new_latents, head = result[:2]
        with annotate("sampler.shift"):
            tail_anchor = None
            if anchor is not None:
                mean, std = anchor
                tail_anchor = mean + std * normal(("fifo", i, "anchor"), tuple(mean.shape))
            shifted = shift_queue(new_latents, normal, ("fifo", i, "shift"),
                                  anchor=tail_anchor, tail_mode=self.tail_mode)
        pred_low = result[2][:, : self._num_low_t_slots()] if want_pred else None
        return shifted, head, pred_low

    def _decode_heads(self, heads):
        """[K, h, w, 4] head latents -> [K, H, W, 3] frames in [-1, 1], the K
        rows split over the mesh where they tile it."""
        return torch.clamp(map_tiled_rows(self.model.decode_single, self.mesh, heads), -1.0, 1.0)

    def _base_latents(self, prompts: List[str], normal: Normal, hw: Tuple[int, int],
                      latents_dir: Optional[str]) -> torch.Tensor:
        """The base DDIM sample [B, T, h, w, 4] of the B prompts, skipped when
        `latents_dir` holds a cache of B rows (videocrafter_main.py:201-209)."""
        cache = None
        if latents_dir:
            os.makedirs(latents_dir, exist_ok=True)
            cache = os.path.join(latents_dir, f"{self.num_inference_steps}.npz")
            barrier(self.mesh)  # no rank looks before every rank has
            if os.path.exists(cache):
                cached = np.load(cache)["latents"]
                if cached.shape[0] == len(prompts):
                    return torch.as_tensor(cached, device=self.model.device)
        latents, x_T = self.base.sample_latents(prompts, normal, latent_shape=hw + (4,),
                                                frames=self.video_length)
        if cache:
            if is_lead(self.mesh):
                np.savez(cache, latents=latents.cpu().numpy(), x_T=x_T.cpu().numpy())
            barrier(self.mesh)
        return latents

    @staticmethod
    def _to_host(pred_low: torch.Tensor):
        """Queue the copy of pred_low into pinned host memory behind the work
        in flight; returns (host tensor, event marking the copy's end)."""
        if pred_low.device.type != "cuda":
            return pred_low, None
        host = torch.empty(pred_low.shape, dtype=pred_low.dtype, pin_memory=True)
        host.copy_(pred_low, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _pull_masks(self, pending, mask_provider, target, counter, hw, lag=1):
        """Run the provider on every low-t slot of one iteration's pred_x0
        (ddim.py:592-606 segments every t <= 300 frame). The queue shifts
        `lag` times between that iteration and the one that consumes the
        masks, so the mask of slot j lands at slot j - lag (slots shifted out
        are dropped). Host only, no device call but the event's wait. Under
        a mesh only rank 0 calls the provider; the others return no masks
        and take rank 0's from the broadcast in `pulled`.
        Returns (mask queue [1, Q, h, w, 1] numpy, counter, seconds)."""
        t0 = time.perf_counter()
        host, event = pending
        h, w = hw
        new_masks = np.zeros((1, self.plan.queue_length, h, w, 1), np.float32)
        if not is_lead(self.mesh):
            return new_masks, counter + host.shape[1], 0.0
        if event is not None:
            event.synchronize()
        pred = host.float().numpy()  # [1, k_low, h, w, C]
        for j in range(pred.shape[1]):
            m = mask_provider(counter, latent_to_uint8_frame(pred[0, j]), target)
            counter += 1
            if m is not None and j >= lag:
                new_masks[0, j - lag, :, :, 0] = np.asarray(m, np.float32)
        return new_masks, counter, time.perf_counter() - t0

    def _to_device(self, masks: np.ndarray) -> torch.Tensor:
        """Host masks onto the device without waiting for its queued work."""
        t = torch.from_numpy(masks)
        if self.model.device.type == "cuda":
            t = t.pin_memory().to(self.model.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def __call__(self, prompt, seed: int = 321, normal: Optional[Normal] = None,
                 cond_image: Optional[np.ndarray] = None,
                 conditioned_prompt: Optional[str] = None, gamma: Optional[float] = None,
                 height: int = 320, width: int = 512,
                 clean_latents=None, masks: Optional[np.ndarray] = None, davis_frames=None,
                 latents_dir: Optional[str] = None,
                 multiprompts: Optional[Sequence[Tuple[str, int]]] = None,
                 frame_callback: Optional[Callable[[int, np.ndarray], None]] = None,
                 mask_provider: Optional[Callable] = None, target: Optional[str] = None,
                 viz: Optional[object] = None):
        """Returns the frames as [H, W, 3] float32 arrays in [-1, 1]
        (new_video_length + S - f of them, or the scenes' total + S - f with
        multiprompts, like the reference's loop); for a sequence of B > 1
        prompts, a list of B such frame lists (frame_callback sees the flat
        index, iteration-major and prompt-minor). cond_image and gamma are
        shared by the B streams.

        cond_image: [h, w, C] latent-resolution concept image. DAVIS mode:
        clean_latents [1, T0, h, w, 4] encoded frames (skip the base sample),
        masks [T0, h, w] binary, davis_frames [T0, H, W, 3] whose last frame
        anchors the tail. Open vocab: mask_provider(counter, frame_uint8,
        target) with target defaulting to the prompt; ignored when masks are
        given. latents_dir: the base-latent cache and, with
        checkpoint_every, the snapshot a killed run resumes from. Noise from
        `normal` or, by default, a generator seeded with `seed`."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts)
        if B > 1:
            unsupported = [n for n, v in [
                ("masks", masks), ("davis_frames", davis_frames),
                ("clean_latents", clean_latents), ("multiprompts", multiprompts),
                ("mask_provider", mask_provider), ("viz", viz)] if v is not None]
            if unsupported:
                raise ValueError(f"batched prompts (B={B}) do not support {unsupported}; "
                                 "run those modes per-prompt (B=1)")
        device = self.model.device
        normal = GeneratorNormal(seed, device) if normal is None else normal
        self.timer = StepTimer()
        h, w = height // 8, width // 8
        t0 = time.perf_counter()

        ctx = self.base.encode_prompts(prompts)
        ctx2 = None
        if conditioned_prompt:
            # videocrafter_main.py:210-211 + crossattn token concat (ddpm3d.py:710-712)
            ctx2 = self.base.encode_prompts([conditioned_prompt])
            ctx = torch.cat([ctx, ctx2.expand((B,) + tuple(ctx2.shape[1:]))], dim=1)
        uc = self.base.uncond_context(B, like=ctx) if self.guidance_scale != 1.0 else None
        if uc is not None and ctx.shape[1] != uc.shape[1]:
            uc = torch.cat([uc] * (ctx.shape[1] // uc.shape[1]), dim=1)
        embeds = lengths = None
        if multiprompts:
            # every scene's context carries the same concept concat, so all
            # share one token length
            embeds = [self.base.encode_prompts([p]) for p, _ in multiprompts]
            if ctx2 is not None:
                embeds = [torch.cat([e, ctx2], dim=1) for e in embeds]
            lengths = np.cumsum([n for _, n in multiprompts])
        t0 = self._stage("encode", t0)

        if clean_latents is None:
            clean_latents = self._base_latents(prompts, normal, (h, w), latents_dir)
        else:
            clean_latents = torch.as_tensor(clean_latents, dtype=torch.float32, device=device)
        t0 = self._stage("base_sample", t0)
        latents = prepare_queue(self.sch, self.plan, clean_latents, normal)
        anchor = None
        if davis_frames is not None:
            anchor = self.model.encode_frame_moments(davis_frames[-1:])

        mask_queue = mask_tail = None
        seg_mode = mask_provider is not None and masks is None
        seg_target, seg_counter, seg_pending = (target if target is not None else prompts[0]), 0, None
        if masks is not None:
            frame_idx, _ = queue_frame_indices(self.plan, masks.shape[0])
            masks = np.asarray(masks, np.float32)
            mask_queue = torch.as_tensor(masks[frame_idx][None, ..., None], device=device)
            mask_tail = torch.as_tensor(masks[-1][None, ..., None], device=device)
        elif seg_mode:
            mask_queue = torch.zeros((1, self.plan.queue_length, h, w, 1), device=device)
        cond = (None if cond_image is None
                else torch.as_tensor(np.asarray(cond_image, np.float32), device=device))

        total = self.new_video_length + self.num_inference_steps - self.video_length
        if multiprompts:
            total = int(lengths[-1]) + self.num_inference_steps - self.video_length
        frames_out: List[np.ndarray] = []
        pending: List[torch.Tensor] = []  # head latents [B, h, w, 4] awaiting decode
        # a flush decodes the smallest multiple of B rows >= decode_batch, the
        # final one padded to it, so every decode has one shape
        flush_rows = B * -(-self.decode_batch // B)
        j, start = 0, 0
        snapshot = None
        if latents_dir and self.checkpoint_every:
            os.makedirs(latents_dir, exist_ok=True)
            snapshot = os.path.join(latents_dir, SNAPSHOT)
        if snapshot and os.path.exists(snapshot):
            snap = np.load(snapshot)
            start, j = int(snap["i"]), int(snap["j"])
            latents = torch.as_tensor(snap["latents"], device=device)
            if mask_queue is not None and "mask_queue" in snap:
                mask_queue = torch.as_tensor(snap["mask_queue"], device=device)
            frames_out = list(snap["frames"])
            if seg_mode:
                # the provider's chain: its frame counter, its previous mask
                # (the IoU and empty-detection gates, ddim.py:788-807) and,
                # async, the pred_x0 it has not segmented yet
                seg_counter = int(snap["seg_frame_counter"])
                if "seg_prev_mask" in snap and hasattr(mask_provider, "prev_mask"):
                    mask_provider.prev_mask = snap["seg_prev_mask"]
                if "seg_pending_pred" in snap:
                    seg_pending = (torch.from_numpy(snap["seg_pending_pred"]), None)
            if "normal_state" in snap and hasattr(normal, "set_state"):
                normal.set_state(snap["normal_state"])
        t0 = self._stage("queue", t0)

        def flush(t0):
            if not pending:
                return t0
            t0 = self._stage("fifo_iteration", t0)
            batch = torch.cat(pending, dim=0)
            k = batch.shape[0]
            if k < flush_rows:  # pad the final flush to the full batch shape
                batch = torch.cat([batch, batch[-1:].expand(flush_rows - k, *batch.shape[1:])],
                                  dim=0)
            decoded = self._decode_heads(batch)[:k].cpu().numpy()
            pending.clear()
            t0 = self._stage("decode", t0)
            for n, frame in enumerate(decoded):
                frames_out.append(frame)
                if frame_callback is not None:
                    frame_callback(len(frames_out) - 1, frame)
            return t0

        def checkpoint(i, t0):
            t0 = flush(t0)
            payload = dict(i=i + 1, j=j, latents=latents.cpu().numpy(),
                           frames=np.stack(frames_out) if frames_out
                           else np.zeros((0,), np.float32))
            if mask_queue is not None:
                payload["mask_queue"] = mask_queue.cpu().numpy()
            if seg_mode:
                payload["seg_frame_counter"] = seg_counter
                prev = getattr(mask_provider, "prev_mask", None)
                if prev is not None:
                    payload["seg_prev_mask"] = np.asarray(prev)
                if seg_pending is not None:
                    host, event = seg_pending
                    if event is not None:
                        event.synchronize()
                    payload["seg_pending_pred"] = host.cpu().numpy()
            if hasattr(normal, "get_state"):
                payload["normal_state"] = normal.get_state().numpy()
            if is_lead(self.mesh):
                np.savez(snapshot + ".tmp.npz", **payload)
                os.replace(snapshot + ".tmp.npz", snapshot)
            barrier(self.mesh)
            return self._stage("checkpoint", t0, sync=False)

        def pulled(result):
            """(mask queue on the device, rank 0's under a mesh, counter) from
            a provider sweep; its own seconds go to mask_provider, which
            overlaps fifo_iteration."""
            new_masks, counter, seconds = result
            self.timer.add("mask_provider", seconds)
            return broadcast_from_lead(self.mesh, self._to_device(new_masks)), counter

        sweep = functools.partial(self._pull_masks, mask_provider=mask_provider,
                                  target=seg_target, hw=(h, w))
        seg_async = seg_mode and self.seg_async
        with ThreadPoolExecutor(1) if seg_async else contextlib.nullcontext() as worker:
            for i in range(start, total):
                step_ctx = ctx
                if embeds is not None:
                    j = advance_prompt_index(i, self.num_inference_steps, self.video_length,
                                             lengths, j)  # funcs.py:427-431
                    step_ctx = embeds[j]
                job = None
                if seg_async and seg_pending is not None:
                    job = worker.submit(sweep, seg_pending, counter=seg_counter, lag=2)
                latents, head, pred_low = self._fifo_iteration(
                    latents, step_ctx, uc, cond, mask_queue, masks is not None, gamma, normal, i,
                    want_pred=seg_mode or viz is not None, anchor=anchor)
                if viz is not None and is_lead(self.mesh):
                    k = pred_low.shape[1]
                    viz.moca_step(
                        i, pred_low[0].float().cpu().numpy(), self.plan.timesteps[:k],
                        mask=None if mask_queue is None else mask_queue[0, 0].cpu().numpy(),
                        cond=None if cond is None else cond.cpu().numpy())
                if masks is not None:
                    mask_queue = shift_masks(mask_queue, mask_tail)
                elif seg_async:
                    seg_pending = self._to_host(pred_low)
                    if job is not None:
                        mask_queue, seg_counter = pulled(job.result())
                elif seg_mode:
                    mask_queue, seg_counter = pulled(
                        sweep(self._to_host(pred_low), counter=seg_counter, lag=1))
                pending.append(head)
                if len(pending) * B >= self.decode_batch:
                    t0 = flush(t0)
                if snapshot and (i + 1) % self.checkpoint_every == 0:
                    t0 = checkpoint(i, t0)
        if seg_async and seg_pending is not None:
            # drain: the last iteration's low-t frames still go through the
            # provider, so its calls and state do not depend on the mode
            _, seg_counter = pulled(sweep(seg_pending, counter=seg_counter, lag=2))
        flush(t0)
        if snapshot:  # completed: drop the snapshot
            if is_lead(self.mesh) and os.path.exists(snapshot):
                os.remove(snapshot)
            barrier(self.mesh)
        if is_lead(self.mesh):
            self.timer.report()  # one JSON line when MOCA_TPU_PROFILE=1
        if B == 1:
            return frames_out
        return [frames_out[b::B] for b in range(B)]
