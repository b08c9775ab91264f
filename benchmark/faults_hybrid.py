"""Faults of the hybrid image-to-video path (DynamiCrafter) planted in the
program underneath a whole run, each of which the check of a cell driven by
`benchmark/drivers/i2v_hybrid.py` must catch (`correct` false): the tests run
them at a tiny size, and

    python3 -m benchmark.faults_hybrid --fault <name> --workload <name> \
        --seeds 1,2,3 --seconds <s>

reads them at a cell's own (the name with `_` for each space; the other
arguments are `benchmark/calibrate.py`'s).

Each planter takes `patch(target, name, value)` (pytest's
`monkeypatch.setattr`), which sets an attribute until the patch is undone.
"""

from __future__ import annotations

import argparse
import sys

import torch


def eps_for_v(patch):
    """The U-Net's v read as eps: the schedule built eps-parameterized."""
    from moca_tpu_torch.pipelines import t2v

    make = t2v.make_schedule
    patch(t2v, "make_schedule", lambda *a, **k: make(*a, **dict(k, parameterization="eps")))


def rescale_dropped(patch):
    """Classifier-free guidance without its rescale."""
    from moca_tpu_torch.sampling import ddim

    patch(ddim, "rescale_noise_cfg", lambda guided, cond, guidance_rescale: guided)


def first_frame_tokens(patch):
    """Every frame's cross-attention given the first frame's 16 image tokens."""
    from moca_tpu_torch.models import unet3d

    split = unet3d.frame_context

    def first(context, frames):
        n, text = unet3d.FRAME_IMAGE_TOKENS, unet3d.TEXT_CONTEXT_LEN
        if context.shape[1] == text + frames * n:
            first_tokens = context[:, text:text + n]
            context = torch.cat([context[:, :text]] + [first_tokens] * frames, dim=1)
        return split(context, frames)
    patch(unet3d, "frame_context", first)


def uncond_latent_dropped(patch):
    """The image latent left out of the unconditional rows' input (zeros in
    its channels; the odd rows of the program's fused guidance call)."""
    from moca_tpu_torch.models.latent_diffusion import LatentDiffusion

    apply = LatentDiffusion.apply_unet

    def dropped(self, x, t, ctx, *args, c_concat=None, **kwargs):
        if c_concat is not None:
            c_concat = c_concat.clone()
            c_concat[1::2] = 0
        return apply(self, x, t, ctx, *args, c_concat=c_concat, **kwargs)
    patch(LatentDiffusion, "apply_unet", dropped)


FAULTS = {
    "eps for v": eps_for_v,
    "guidance rescale dropped": rescale_dropped,
    "first frame tokens": first_frame_tokens,
    "uncond latent dropped": uncond_latent_dropped,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fault", required=True, choices=[f.replace(" ", "_") for f in FAULTS])
    args, rest = p.parse_known_args(argv)
    import pytest

    from benchmark import calibrate

    FAULTS[args.fault.replace("_", " ")](pytest.MonkeyPatch().setattr)
    return calibrate.main(rest)


if __name__ == "__main__":
    sys.exit(main())
