"""MoCA-Video pipeline: base sample -> FIFO diagonal queue -> per-step concept
injection -> batched head decode.

Port of moca_tpu/pipelines/moca_video.py for one prompt: conditioning with
the `conditioned_prompt` token concat (:287-300), base DDIM latents, the
queue, the FIFO loop (`_fifo_iteration` :98-142: CFG-fused U-Net over all
windows, per-window MoCA step, write-back, FreeInit tail shift), given
queue-aligned DAVIS-style `masks` shifted every iteration (:334-340,
:469-471) and the batched head decode with a padded final flush (:419-439).
Not yet ported: DAVIS frames and anchors, the open-vocab mask provider,
checkpoint/resume, multiprompts, B > 1 prompts and visualization.

Noise: every draw goes through `normal(tag, shape)` (sampling/ddim.py):
("base", ...) for the base sample, ("queue",) for the queue and
("fifo", i, ...) for iteration i.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal, Normal, make_cfg_eps_fn
from moca_tpu_torch.sampling.fifo import (
    FIFOPlan, fifo_step, make_fifo_plan, prepare_queue, queue_frame_indices,
    shift_masks, shift_queue,
)
from moca_tpu_torch.sampling.moca import MoCAConfig
from moca_tpu_torch.schedule import make_schedule


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
    decode_batch: int = 8             # head frames per batched VAE call
    tail_mode: str = "freeinit"       # funcs.py:86-99 | funcs_mp.py:39-46

    def __post_init__(self):
        self.num_inference_steps = self.video_length * self.num_partitions
        self.sch = make_schedule(ddim_num_steps=self.num_inference_steps, ddim_eta=self.eta,
                                 use_scale=self.use_scale, device=self.model.device)
        self.plan: FIFOPlan = make_fifo_plan(self.sch.ddim_timesteps_np, self.video_length,
                                             self.num_partitions, self.lookahead_denoising)
        self.base = T2VPipeline(self.model, self.sch, self.tokenizer,
                                guidance_scale=self.guidance_scale, fps=self.fps)
        self.timings: dict = {}

    def _stage(self, name: str, t0: float) -> float:
        """Add the time since t0 to stage `name` (device work included)."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - t0
        return now

    def _fifo_iteration(self, latents, ctx, uc, cond, mask_queue, gamma, normal, i):
        """(queue, ...) -> (shifted queue, head latent)."""
        eps_fn = make_cfg_eps_fn(self.model.apply_unet, ctx, uc, self.guidance_scale,
                                 fps=self.fps)
        new_latents, head = fifo_step(
            eps_fn, self.sch, self.plan, self.moca, latents, normal, ("fifo", i),
            cond_image=cond, masks=mask_queue, gamma=gamma)
        shifted = shift_queue(new_latents, normal, ("fifo", i, "shift"),
                              tail_mode=self.tail_mode)
        return shifted, head

    def _decode_heads(self, heads):
        """[K, h, w, 4] head latents -> [K, H, W, 3] frames in [-1, 1]."""
        return torch.clamp(self.model.decode_single(heads), -1.0, 1.0)

    @torch.inference_mode()
    def __call__(self, prompt: str, seed: int = 321, normal: Optional[Normal] = None,
                 cond_image: Optional[np.ndarray] = None,
                 conditioned_prompt: Optional[str] = None, gamma: Optional[float] = None,
                 height: int = 320, width: int = 512,
                 masks: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Returns the frames as [H, W, 3] float32 arrays in [-1, 1]
        (new_video_length + S - f of them, like the reference's loop).

        cond_image: [h, w, C] latent-resolution concept image; masks:
        [T0, h, w] binary, queue-aligned and shifted every iteration; noise
        from `normal` or, by default, a generator seeded with `seed`."""
        device = self.model.device
        normal = GeneratorNormal(seed, device) if normal is None else normal
        self.timings = {}
        h, w = height // 8, width // 8
        t0 = time.perf_counter()

        ctx = self.base.encode_prompts([prompt])
        if conditioned_prompt:
            # videocrafter_main.py:210-211 + crossattn token concat (ddpm3d.py:710-712)
            ctx = torch.cat([ctx, self.base.encode_prompts([conditioned_prompt])], dim=1)
        uc = self.base.uncond_context(1) if self.guidance_scale != 1.0 else None
        if uc is not None and ctx.shape[1] != uc.shape[1]:
            uc = torch.cat([uc] * (ctx.shape[1] // uc.shape[1]), dim=1)
        t0 = self._stage("encode", t0)

        clean_latents, _ = self.base.sample_latents(prompt, normal, latent_shape=(h, w, 4),
                                                    frames=self.video_length)
        t0 = self._stage("base_sample", t0)
        latents = prepare_queue(self.sch, self.plan, clean_latents, normal)

        mask_queue = mask_tail = None
        if masks is not None:
            frame_idx, _ = queue_frame_indices(self.plan, masks.shape[0])
            masks = np.asarray(masks, np.float32)
            mask_queue = torch.as_tensor(masks[frame_idx][None, ..., None], device=device)
            mask_tail = torch.as_tensor(masks[-1][None, ..., None], device=device)
        cond = (None if cond_image is None
                else torch.as_tensor(np.asarray(cond_image, np.float32), device=device))
        t0 = self._stage("queue", t0)

        total = self.new_video_length + self.num_inference_steps - self.video_length
        frames_out: List[np.ndarray] = []
        pending: List[torch.Tensor] = []

        def flush(t0):
            if not pending:
                return t0
            t0 = self._stage("fifo_iteration", t0)
            batch = torch.cat(pending, dim=0)
            k = batch.shape[0]
            if k < self.decode_batch:  # pad the final flush to the full batch shape
                batch = torch.cat([batch, batch[-1:].expand(self.decode_batch - k,
                                                            *batch.shape[1:])], dim=0)
            decoded = self._decode_heads(batch)[:k].cpu().numpy()
            frames_out.extend(decoded)
            pending.clear()
            return self._stage("decode", t0)

        for i in range(total):
            latents, head = self._fifo_iteration(latents, ctx, uc, cond, mask_queue, gamma,
                                                 normal, i)
            if mask_queue is not None:
                mask_queue = shift_masks(mask_queue, mask_tail)
            pending.append(head)
            if len(pending) >= self.decode_batch:
                t0 = flush(t0)
        flush(t0)
        return frames_out
