"""Verification drive: the port's library surface, end to end.

Port of scripts/verify_drive.py. Builds a tiny random-weight model through
the package's public exports, runs the full MoCA concept-mixing pipeline
(base DDIM -> FIFO queue -> momentum and injection -> streaming decode) and
writes a real .mp4 and .gif with the io layer: the path the CLI takes after
loading a checkpoint. Then it reruns the call on the cached base latents
(the resume contract: identical frames) and with gamma 0 (the blend touches
only pred_x0, so the frames stay the same in the reference-faithful mode).
The reruns replay the first run's draws by tag: the port's generator draws
in call order, and a cached base sample skips its draws, which would shift
every later one (the JAX package's keys are fixed by tag).
Runs on the GPU unless the caller of `main` names another device; files go
under --out_dir:

    python -m moca_tpu_torch.cli.verify_drive [--out_dir build/verify_drive]

Prints `DRIVE OK` at the end, and raises instead when a frame is not
finite or the cached rerun differs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from moca_tpu_torch import resolve_device
from moca_tpu_torch.io.video import save_video, tensor_to_uint8
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.latent_diffusion import init_random_model
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal

H = W = 32
F, N = 4, 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="build/verify_drive",
                   help="the mp4, the gif and the base-latent cache land here")
    return p


def main(argv=None, device=None) -> dict:
    """The drive on `device`; returns its frames and file paths."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    t0 = time.time()
    unet_cfg = UNetConfig(model_channels=32, num_head_channels=8, context_dim=16,
                          channel_mult=(1, 2), attention_resolutions=(1, 2),
                          num_res_blocks=1, temporal_length=F)
    vae_cfg = VAEConfig(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=H)
    clip_cfg = CLIPTextConfig(width=16, heads=2, layers=2)
    model = init_random_model(unet_cfg, vae_cfg, clip_cfg,
                              torch.Generator(device=device).manual_seed(0), device=device)
    print(f"[{time.time() - t0:6.1f}s] model built on {device}")

    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=F, num_partitions=N,
                             new_video_length=4, guidance_scale=7.5)
    cond = np.full((H // 8, W // 8, 4), 0.3, np.float32)
    latents_dir = os.path.join(args.out_dir, "latents")
    call = dict(cond_image=cond, conditioned_prompt="a cat", height=H, width=W,
                latents_dir=latents_dir)
    generator, draws = GeneratorNormal(1, device), {}

    def first_normal(tag, shape):
        draws[tag] = generator(tag, shape)
        return draws[tag]

    def replay(tag, shape):
        return draws[tag]

    frames = pipe("a mouse running", normal=first_normal, gamma=0.7, **call)
    finite = all(np.isfinite(f).all() for f in frames)
    print(f"[{time.time() - t0:6.1f}s] pipeline produced {len(frames)} frames, "
          f"shape {frames[0].shape}, finite={finite}")

    mp4, gif = (os.path.join(args.out_dir, f"verify_out.{ext}") for ext in ("mp4", "gif"))
    save_video(frames, mp4, fps=8)
    save_video(frames, gif, fps=8)
    print(f"[{time.time() - t0:6.1f}s] wrote {mp4} ({os.path.getsize(mp4)} bytes) and .gif "
          f"({os.path.getsize(gif)} bytes)")

    # resume contract: a second run reuses the cached base latents
    t1 = time.time()
    frames2 = pipe("a mouse running", normal=replay, gamma=0.7, **call)
    identical = np.allclose(np.stack(frames), np.stack(frames2))
    print(f"[{time.time() - t0:6.1f}s] cached rerun took {time.time() - t1:.1f}s; "
          f"identical={identical}")

    # probe: gamma changes the pred_x0 blend but (faithful mode) not the queue
    frames3 = pipe("a mouse running", normal=replay, gamma=0.0, **call)
    gamma_moves = not np.allclose(np.stack(frames), np.stack(frames3))
    print(f"[{time.time() - t0:6.1f}s] gamma=0 vs 0.7 frames differ: {gamma_moves}")

    u8 = tensor_to_uint8(frames[0])
    print(f"frame0 uint8 range: [{u8.min()}, {u8.max()}]")
    if not (finite and identical):
        raise RuntimeError(f"drive failed: finite={finite}, cached rerun identical={identical}")
    print("DRIVE OK")
    return dict(frames=frames, frames_cached=frames2, frames_gamma0=frames3, mp4=mp4, gif=gif,
                finite=finite, identical=identical)


if __name__ == "__main__":
    main()
