"""Faults planted in the program underneath a whole run, each of which the
check must catch (`correct` false): the tests run them at a tiny size, and
`python3 -m benchmark.calibrate --fault <name>` reads them at a cell's own.

Each planter takes `patch(target, name, value)` (pytest's
`monkeypatch.setattr`), which sets an attribute until the patch is undone.
"""

from __future__ import annotations

import torch

WRONG_PROMPT = "a still life of a teapot on a kitchen table"


def state_unchanged(patch):
    """A FIFO iteration, or a DDIM step, that hands its state back as it got it."""
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
    from moca_tpu_torch.sampling import ddim

    iterate = MoCAVideoPipeline._fifo_iteration

    def unchanged(self, latents, *args, **kwargs):
        _, head, pred = iterate(self, latents, *args, **kwargs)
        return latents, head, pred
    patch(MoCAVideoPipeline, "_fifo_iteration", unchanged)
    patch(ddim, "ddim_step_math", lambda sch, x, eps, index, noise: (x, x))


def half_batch(patch):
    """The U-Net on the first half of its rows, the rest given their mean."""
    from moca_tpu_torch.models.latent_diffusion import LatentDiffusion

    apply = LatentDiffusion.apply_unet

    def half(self, x, t, ctx, *args, **kwargs):
        n = x.shape[0] // 2
        out = apply(self, x[:n], t[:n], ctx[:n], *args, **kwargs)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])
    patch(LatentDiffusion, "apply_unet", half)


def uncond_dropped(patch):
    """Classifier-free guidance without its unconditional half: the U-Net
    on the conditional rows alone (the even rows of the program's fused
    call), their output handed to the unconditional rows as well."""
    from moca_tpu_torch.models.latent_diffusion import LatentDiffusion

    apply = LatentDiffusion.apply_unet

    def cond_only(self, x, t, ctx, *args, **kwargs):
        out = apply(self, x[0::2], t[0::2], ctx[0::2], *args, **kwargs)
        return out.repeat_interleave(2, dim=0)
    patch(LatentDiffusion, "apply_unet", cond_only)


def wrong_prompt(patch):
    """Every prompt but the empty one tokenized as another prompt."""
    from moca_tpu_torch.models.tokenizer import HashTokenizer

    tokenize = HashTokenizer.__call__

    def wrong(self, texts, *args, **kwargs):
        return tokenize(self, [WRONG_PROMPT if t else t for t in texts], *args, **kwargs)
    patch(HashTokenizer, "__call__", wrong)


def conditioned_prompt_dropped(patch):
    """MoCA's conditioned prompt (the concept's half of the context) left out."""
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    call = MoCAVideoPipeline.__call__

    def dropped(self, *args, **kwargs):
        return call(self, *args, **dict(kwargs, conditioned_prompt=None))
    patch(MoCAVideoPipeline, "__call__", dropped)


def frame_altered(patch):
    """One frame of every decode call altered where it is produced."""
    from moca_tpu_torch.models.latent_diffusion import LatentDiffusion

    decode = LatentDiffusion.decode_single

    def altered(self, z):
        out = decode(self, z)
        out[0] = -out[0]
        return out
    patch(LatentDiffusion, "decode_single", altered)


def tokens_altered(patch):
    """An image token zeroed where the image towers produce it."""
    from moca_tpu_torch.models.latent_diffusion import LatentVisualDiffusion

    embeds = LatentVisualDiffusion.get_image_embeds

    def altered(self, images):
        out = embeds(self, images).clone()
        out[:, 0] = 0
        return out
    patch(LatentVisualDiffusion, "get_image_embeds", altered)


# fault -> (planter, the entries whose cells can have it)
FAULTS = {
    "state unchanged": (state_unchanged, ("moca_davis", "t2v_clip")),
    "half of the batch": (half_batch, ("moca_davis", "t2v_clip")),
    "unconditional rows dropped": (uncond_dropped, ("moca_davis", "t2v_clip")),
    "wrong prompt": (wrong_prompt, ("moca_davis", "t2v_clip")),
    "conditioned prompt dropped": (conditioned_prompt_dropped, ("moca_davis",)),
    "frame altered": (frame_altered, ("moca_davis", "t2v_clip")),
    "image token altered": (tokens_altered, ("t2v_clip",)),
}
