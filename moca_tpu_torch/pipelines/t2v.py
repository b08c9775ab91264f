"""Base text-to-video sampling: prompt -> CLIP -> DDIM.

Port of the parts of moca_tpu/pipelines/t2v.py that the MoCA pipeline runs
(`encode_prompts`, `uncond_context`, `sample_latents`, :70-119).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.sampling.ddim import Normal, ddim_sample, make_cfg_eps_fn
from moca_tpu_torch.schedule import DiffusionSchedule


@dataclasses.dataclass(eq=False)
class T2VPipeline:
    model: LatentDiffusion
    sch: DiffusionSchedule
    tokenizer: object
    guidance_scale: float = 12.0  # videocrafter_main.py:251
    fps: int = 10

    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.model.encode_tokens(self.tokenizer(list(prompts)))

    def uncond_context(self, batch: int) -> torch.Tensor:
        """Unconditional CFG context: the empty-prompt embedding
        (uncond_type='empty_seq', funcs.py:199-216)."""
        return self.encode_prompts([""] * batch)

    def sample_latents(self, prompt, normal: Normal,
                       latent_shape: Tuple[int, int, int] = (40, 64, 4),
                       frames: int = 16):
        """Returns (clean_latents, initial_noise) [B, T, h, w, C] float32."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ctx = self.encode_prompts(prompts)
        uc = self.uncond_context(len(prompts)) if self.guidance_scale != 1.0 else None
        eps_fn = make_cfg_eps_fn(self.model.apply_unet, ctx, uc, self.guidance_scale,
                                 fps=self.fps)
        h, w, c = latent_shape
        return ddim_sample(eps_fn, self.sch, (len(prompts), frames, h, w, c), normal,
                           tag=("base",))
