"""Base text-to-video pipeline: prompt -> CLIP -> DDIM (or DDPM) -> VAE decode.

Port of moca_tpu/pipelines/t2v.py: the reference's `base_ddim_sampling` /
`batch_ddim_sampling` (scripts/evaluation/funcs.py:120-241) for one prompt
or B prompts in one batch, the CFG variants (`uc_type`, temporal guidance,
`uncond_type`), ancestral DDPM when `num_steps <= 0`, and the FreeInit
re-sampling loop (`sample_with_freeinit`). The i2v model conditions on an
image through `image_condition`: its image tokens, and with the `hybrid`
conditioning (DynamiCrafter) also the image tokens of an all-zero image for
the unconditional rows and the image's VAE latent concatenated to every
frame's input; DynamiCrafter's v-parameterized zero-SNR schedule and
`guidance_rescale` come in through `build`. With a `mesh`
(parallel/mesh.py), the 2·B CFG rows of each U-Net call are split over the
ranks where they tile the mesh (else every rank runs them all), and so are
the B·T frame rows of the decode.

Noise: every draw goes through `normal(tag, shape)` (sampling/ddim.py),
shared across the prompt batch: ("base", ...) for a DDIM sample,
("ddpm", ...) for a DDPM one, and in FreeInit ("freeinit", 0, ...) for the
first sample and ("freeinit", k, "noise" | "mix" | "step", ...) for
iteration k. By default a generator seeded with `seed`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import torch

from moca_tpu_torch import freeinit
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.parallel.mesh import make_sharded_unet_apply, map_tiled_rows
from moca_tpu_torch.sampling.ddim import GeneratorNormal, Normal, ddim_sample, make_cfg_eps_fn
from moca_tpu_torch.sampling.ddpm import ddpm_sample
from moca_tpu_torch.schedule import DiffusionSchedule, make_schedule
from moca_tpu_torch.utils.profiling import StepTimer


@dataclasses.dataclass(eq=False)
class T2VPipeline:
    model: LatentDiffusion
    sch: DiffusionSchedule
    tokenizer: object
    guidance_scale: float = 12.0          # videocrafter_main.py:251
    fps: int = 10
    uc_type: Optional[str] = None          # ddim.py:303-311 CFG variants
    temporal_cfg_scale: Optional[float] = None  # funcs.py:121 temporal guidance
    uncond_type: str = "empty_seq"         # ddpm3d.py:397; funcs.py:128-134
    mesh: Optional[object] = None          # parallel.mesh.make_mesh: split the rows over ranks
    guidance_rescale: float = 0.0          # DynamiCrafter's rescaled CFG (samplers/ddim.py)
    hybrid: bool = False                   # conditioning_key 'hybrid': image latent on the input
    # the last call's stages: encode, sample, decode
    timer: StepTimer = dataclasses.field(default_factory=StepTimer, init=False, repr=False)

    @property
    def timings(self) -> dict:
        """Seconds of the last call's stages."""
        return self.timer.totals()

    @classmethod
    def build(cls, model: LatentDiffusion, tokenizer, num_steps: int = 50, eta: float = 1.0,
              use_scale: bool = True, guidance_scale: float = 12.0, fps: int = 10,
              uc_type: Optional[str] = None, temporal_cfg_scale: Optional[float] = None,
              uncond_type: str = "empty_seq", mesh=None, guidance_rescale: float = 0.0,
              hybrid: bool = False, **sched_kw) -> "T2VPipeline":
        """num_steps <= 0 selects ancestral DDPM (inference.py:28); the DDIM
        arrays still take a valid length. `sched_kw` go to `make_schedule`
        (DynamiCrafter's: ddim_discretize, rescale_betas_zero_snr,
        parameterization, dynamic_rescale, scale_b)."""
        sch = make_schedule(ddim_num_steps=max(num_steps, 1), ddim_eta=eta,
                            use_scale=use_scale, device=model.device, **sched_kw)
        return cls(model, sch, tokenizer, guidance_scale, fps, uc_type=uc_type,
                   temporal_cfg_scale=temporal_cfg_scale, uncond_type=uncond_type, mesh=mesh,
                   guidance_rescale=guidance_rescale, hybrid=hybrid)

    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.model.encode_tokens(self.tokenizer(list(prompts)))

    def uncond_context(self, batch: int, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Unconditional CFG context: the empty-prompt embedding
        (uncond_type='empty_seq', funcs.py:199-216) or zeros shaped like the
        cond context ('zero_embed', funcs.py:128-134), the two values
        ddpm3d.py:397 admits."""
        if self.uncond_type == "zero_embed":
            if like is not None:
                return torch.zeros((batch,) + tuple(like.shape[1:]), dtype=like.dtype,
                                   device=like.device)
            return torch.zeros((batch, 77, self.model.unet_cfg.context_dim),
                               device=self.model.device)
        if self.uncond_type != "empty_seq":
            raise NotImplementedError(self.uncond_type)
        return self.encode_prompts([""] * batch)

    def _contexts(self, prompts: Sequence[str]):
        ctx = self.encode_prompts(prompts)
        uc = self.uncond_context(len(prompts), like=ctx) if self.guidance_scale != 1.0 else None
        return ctx, uc

    def _eps_fn(self, ctx, uc, c_concat=None):
        unet_apply = self.model.apply_unet
        if self.mesh is not None:
            unet_apply = make_sharded_unet_apply(unet_apply, self.mesh, skip_indivisible=True)
        return make_cfg_eps_fn(unet_apply, ctx, uc, self.guidance_scale,
                               fps=self.fps, uc_type=self.uc_type,
                               temporal_guidance_scale=self.temporal_cfg_scale,
                               guidance_rescale=self.guidance_rescale, c_concat=c_concat)

    @torch.inference_mode()
    def image_condition(self, image, normal: Normal) -> dict:
        """The keywords of `__call__` that condition it on one image [1, H, W,
        3] in [-1, 1] (an i2v model): its image tokens, and with the hybrid
        conditioning also `uncond_image_tokens`, those of an all-zero image,
        and `image_latent`, the image's scaled VAE latent [1, 1, h, w, 4], one
        posterior sample (the draw ("image_latent",)), as DynamiCrafter's
        image_guided_synthesis builds its conditioning from frame 0 of the
        image repeated (scripts/evaluation/inference.py)."""
        image = torch.as_tensor(image, device=self.model.device)
        out = {"image_tokens": self.model.get_image_embeds(image)}
        if self.hybrid:
            out["uncond_image_tokens"] = self.model.get_image_embeds(torch.zeros_like(image))
            out["image_latent"] = self.model.encode_frames(image[:, None], normal,
                                                           ("image_latent",))
        return out

    @torch.inference_mode()
    def sample_latents(self, prompt, normal: Normal,
                       latent_shape: Tuple[int, int, int] = (40, 64, 4), frames: int = 16):
        """Returns (clean_latents, initial_noise) [B, T, h, w, C] float32 for
        one prompt or B prompts in one batch (the MoCA pipeline caches both)."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ctx, uc = self._contexts(prompts)
        return self.sample_latents_from_context(ctx, uc, normal, latent_shape, frames)

    @torch.inference_mode()
    def sample_latents_from_context(self, ctx: torch.Tensor, uc: Optional[torch.Tensor],
                                    normal: Normal,
                                    latent_shape: Tuple[int, int, int] = (40, 64, 4),
                                    frames: int = 16, tag: tuple = ("base",),
                                    c_concat: Optional[torch.Tensor] = None):
        """DDIM with a context built by the caller (e.g. text and image
        tokens concatenated, inference.py:110-117); batch = ctx rows;
        c_concat [B or 1, T, h, w, Cc] on every row's input.
        Returns (clean_latents, initial_noise)."""
        return ddim_sample(self._eps_fn(ctx, uc, c_concat), self.sch,
                           (ctx.shape[0], frames) + tuple(latent_shape), normal, tag=tag)

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, T, h, w, 4] -> [B, T, H, W, 3] clipped to [-1, 1]: the B*T
        frame rows through the per-frame decoder (decode_first_stage_2DAE,
        ddpm3d.py:556-562), split over the mesh where they tile it."""
        b, t = latents.shape[:2]
        flat = latents.reshape((b * t, 1) + tuple(latents.shape[2:]))
        x = map_tiled_rows(self.model.decode_latents, self.mesh, flat)
        return torch.clamp(x.reshape((b, t) + tuple(x.shape[2:])), -1.0, 1.0)

    @torch.inference_mode()
    def __call__(self, prompt, seed: int = 123, normal: Optional[Normal] = None,
                 height: int = 320, width: int = 512, frames: int = 16,
                 image_tokens: Optional[torch.Tensor] = None,
                 uncond_image_tokens: Optional[torch.Tensor] = None,
                 image_latent: Optional[torch.Tensor] = None,
                 use_ddpm: bool = False) -> torch.Tensor:
        """prompt -> frames [T, H, W, 3] float32 in [-1, 1] on the model's
        device; a sequence of B prompts -> [B, T, H, W, 3], sampled in one
        batch with the noise shared across it (the reference's --bs batching,
        inference.py:30,92-101). image_tokens [B or 1, N, D]: appended to the
        text context, and `uncond_image_tokens` (by default zeros of their
        shape, funcs.py:136-141) to the uncond context. image_latent [B or 1,
        1, h, w, Cc]: concatenated to every frame's input on the channel axis
        (`image_condition` gives all three). use_ddpm: ancestral DDPM instead
        of DDIM."""
        single = isinstance(prompt, str)
        prompts = [prompt] if single else list(prompt)
        b = len(prompts)
        device = self.model.device
        normal = GeneratorNormal(seed, device) if normal is None else normal
        self.timer = StepTimer()
        t0 = time.perf_counter()
        ctx, uc = self._contexts(prompts)
        if image_tokens is not None:
            image_tokens = torch.as_tensor(image_tokens, dtype=ctx.dtype, device=ctx.device)
            image_tokens = image_tokens.expand((b,) + tuple(image_tokens.shape[1:]))
            ctx = torch.cat([ctx, image_tokens], dim=1)
            if uc is not None:
                uc_tokens = (torch.zeros_like(image_tokens) if uncond_image_tokens is None else
                             torch.as_tensor(uncond_image_tokens, dtype=ctx.dtype,
                                             device=ctx.device).expand_as(image_tokens))
                uc = torch.cat([uc, uc_tokens], dim=1)
        c_concat = None
        if image_latent is not None:
            if self.mesh is not None:
                raise NotImplementedError("the hybrid conditioning runs on one card: its "
                                          "concat input is not split over a mesh")
            c_concat = image_latent.expand((image_latent.shape[0], frames)
                                           + tuple(image_latent.shape[2:]))
        t0 = self.timer.record("encode", t0, device)
        latent_shape = (height // 8, width // 8, 4)
        if use_ddpm:
            if self.sch.parameterization != "eps":
                raise NotImplementedError("ancestral DDPM samples an eps-parameterized model")
            latents = ddpm_sample(self._eps_fn(ctx, uc, c_concat), self.sch,
                                  (b, frames) + latent_shape, normal)
        else:
            latents, _ = self.sample_latents_from_context(ctx, uc, normal, latent_shape, frames,
                                                          c_concat=c_concat)
        t0 = self.timer.record("sample", t0, device)
        decoded = self._decode(latents)
        self.timer.record("decode", t0, device)
        return decoded[0] if single else decoded

    @torch.inference_mode()
    def sample_with_freeinit(self, prompt: str, seed: int = 123,
                             normal: Optional[Normal] = None, iterations: int = 3,
                             height: int = 320, width: int = 512, frames: int = 16,
                             filter_type: str = "gaussian", d_s: float = 0.25,
                             d_t: float = 0.25) -> torch.Tensor:
        """FreeInit: re-noise the sampled latent to the last DDIM level, keep
        its low frequencies and take fresh noise's high ones, and sample again
        from there (the FreeInit paper's loop; the mix is
        utils/freeinit_utils.py:7-47). Returns [T, H, W, 3] in [-1, 1]."""
        device = self.model.device
        normal = GeneratorNormal(seed, device) if normal is None else normal
        self.timer = StepTimer()
        t0 = time.perf_counter()
        h, w = height // 8, width // 8
        ctx, uc = self._contexts([prompt])
        t0 = self.timer.record("encode", t0, device)
        latents, _ = self.sample_latents_from_context(ctx, uc, normal, (h, w, 4), frames,
                                                      tag=("freeinit", 0))
        lpf = freeinit.get_freq_filter((frames, h, w), filter_type, 1, d_s, d_t,
                                       device=latents.device)
        a_T = self.sch.alphas_cumprod[int(self.sch.ddim_timesteps_np[-1])]
        shape = tuple(latents.shape)
        for k in range(1, iterations):
            noise = normal(("freeinit", k, "noise"), shape)
            noised = torch.sqrt(a_T) * latents + torch.sqrt(1 - a_T) * noise
            mix = normal(("freeinit", k, "mix"), shape)
            # [B, T, h, w, C] -> [B, C, T, h, w] for the (T, h, w) fft axes, then back
            mixed = freeinit.freq_mix_3d(noised.movedim(-1, 1), mix.movedim(-1, 1), lpf)
            latents, _ = ddim_from_xt(self, (ctx, uc), mixed.movedim(1, -1), normal,
                                      tag=("freeinit", k))
        t0 = self.timer.record("sample", t0, device)
        decoded = self._decode(latents)[0]
        self.timer.record("decode", t0, device)
        return decoded


def ddim_from_xt(pipe: T2VPipeline, contexts, x_T: torch.Tensor, normal: Normal,
                 tag: tuple = ("base",)):
    """DDIM from a given x_T with the pipeline's full CFG set (a FreeInit
    iteration guides like the first draw). Returns (x0, x_T)."""
    ctx, uc = contexts
    return ddim_sample(pipe._eps_fn(ctx, uc), pipe.sch, tuple(x_T.shape), normal, tag=tag,
                       x_T=x_T)
