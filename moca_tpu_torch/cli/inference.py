"""Batch text-to-video CLI (VideoCrafter2's scripts/evaluation/inference.py) on the port.

Port of moca_tpu/cli/inference.py, base mode: the same flags and defaults,
the same output layout (one mp4 per prompt, its --n_samples side by side),
run by moca_tpu_torch on the GPU:

    python -m moca_tpu_torch.cli.inference --ckpt_path model.ckpt \
        --prompt_file prompts.txt --savedir results/t2v --bs 4

  * the prompt file (one prompt a line), cut into contiguous shards by
    --num_processes / --rank (inference.py:71-77);
  * --bs prompts sampled in one batch a round (inference.py:30,92-101),
    base sampling only;
  * --n_samples samples a prompt, written side by side (funcs.py:600-612);
  * --freeinit_iters > 1: FreeInit re-sampling;
    --unconditional_guidance_scale_temporal: temporal guidance;
    --ddim_steps <= 0: ancestral DDPM.
Not yet ported: --mode i2v or an i2v config (ROADMAP Queue 1 item 5) and
--mesh (item 8); both raise NotImplementedError.

Noise: `sample_normal` maps (seed, global prompt index, sample index) to
the generator of one sampling call. A --bs round uses its first prompt's
generator and shares the draws across its prompts, so prompt 0 of a --bs 4
round draws what a --bs 1 run of prompt 0 draws, as the reference's
`jax.random.fold_in(seed, index)` keys do (moca_tpu/cli/inference.py:170-171,
198-200); the numbers are not JAX's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from moca_tpu_torch.cli.main import PRECISIONS, load_model
from moca_tpu_torch.io.video import save_video_grid
from moca_tpu_torch.models.tokenizer import load_tokenizer
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal
from moca_tpu_torch.utils.logging import get_logger

log = get_logger("moca_tpu_torch.inference")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("batch T2V inference")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--config", type=str, default="configs/inference_t2v_512_v2.0.yaml")
    p.add_argument("--prompt_file", type=str, required=True, help="one prompt per line")
    p.add_argument("--savedir", type=str, default="results/t2v")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--ddim_steps", type=int, default=50, help="<= 0: ancestral DDPM")
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--unconditional_guidance_scale", type=float, default=12.0)
    p.add_argument("--unconditional_guidance_scale_temporal", type=float, default=None,
                   help="temporal guidance (inference.py:36)")
    p.add_argument("--n_samples", type=int, default=1,
                   help="samples per prompt (inference.py:27)")
    p.add_argument("--bs", type=int, default=1,
                   help="prompts per batched sampling call (inference.py:30,92-101); base "
                        "mode only, FreeInit and n_samples stay per prompt")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--fps", type=int, default=28)
    p.add_argument("--savefps", type=int, default=10)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16", choices=sorted(PRECISIONS))
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--freeinit_iters", type=int, default=0,
                   help="FreeInit noise-reinit iterations (0 = off)")
    p.add_argument("--mode", type=str, default="base", choices=["base", "i2v"],
                   help="i2v: not ported yet")
    p.add_argument("--cond_image_dir", "--cond_input", type=str, default=None,
                   dest="cond_image_dir", help="i2v mode: conditioning images")
    p.add_argument("--mesh", type=str, default=None, metavar="DP,FIFO",
                   help="multi-device sharding; not ported to GPUs yet")
    return p


def sample_normal(seed: int, prompt_index: int, sample_index: int, n_samples: int,
                  device) -> GeneratorNormal:
    """The noise of one sampling call: a generator seeded from (seed, the
    prompt's index in the whole prompt file, the sample's index), one call's
    stream for each (prompt_index * n_samples + sample_index, as the
    reference's fold_in index). Seeds are non-negative."""
    index = prompt_index * max(n_samples, 1) + sample_index
    child = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return GeneratorNormal(int(child), device)


def load_pipeline(args, device=None) -> T2VPipeline:
    """The model of --config and --ckpt_path (cli.main.load_model) on
    `device`, the GPU unless the caller names one, behind a T2VPipeline."""
    model, cfg = load_model(args, device)
    return T2VPipeline.build(
        model, load_tokenizer(args.bpe_path), num_steps=args.ddim_steps, eta=args.ddim_eta,
        use_scale=cfg.diffusion.use_scale, guidance_scale=args.unconditional_guidance_scale,
        fps=args.fps, temporal_cfg_scale=args.unconditional_guidance_scale_temporal,
        uncond_type=cfg.diffusion.uncond_type)


def _host_frames(video: torch.Tensor):
    return list(video.float().cpu().numpy())


def main(args, pipe: T2VPipeline = None):
    """Write one mp4 per prompt of this process's shard into --savedir.
    `pipe` stands in for the pipeline `load_pipeline` builds from the files."""
    if args.mesh:
        raise NotImplementedError(
            "--mesh: multi-GPU sharding is not ported yet (ROADMAP Queue 1 item 8)")
    if args.mode == "i2v":
        raise NotImplementedError(
            "--mode i2v: the i2v model is not ported yet (ROADMAP Queue 1 item 5)")
    if args.bs > 1 and (args.freeinit_iters > 1 or args.n_samples != 1):
        raise ValueError("--bs>1 supports plain base sampling")
    with open(args.prompt_file) as f:
        prompts = [line.strip() for line in f if line.strip()]
    pipe = load_pipeline(args) if pipe is None else pipe
    # contiguous shard per process (inference.py:71-77)
    per = -(-len(prompts) // args.num_processes)
    first = args.rank * per
    shard = prompts[first: first + per]
    os.makedirs(args.savedir, exist_ok=True)
    device = pipe.model.device
    size = dict(height=args.height, width=args.width, frames=args.frames)
    path = lambda prompt: os.path.join(args.savedir, prompt[:100].replace("/", "_") + ".mp4")

    if args.bs > 1:
        for r0 in range(0, len(shard), args.bs):
            chunk = shard[r0: r0 + args.bs]
            t0 = time.perf_counter()
            videos = pipe(chunk, normal=sample_normal(args.seed, first + r0, 0, 1, device),
                          use_ddpm=args.ddim_steps <= 0, **size)
            for prompt, video in zip(chunk, videos):
                save_video_grid([_host_frames(video)], path(prompt), fps=args.savefps)
            log.info("batch [%d:%d]/%d %.1fs", r0, r0 + len(chunk), len(shard),
                     time.perf_counter() - t0)
        return

    for i, prompt in enumerate(shard):
        t0 = time.perf_counter()
        samples = []
        for s in range(args.n_samples):
            normal = sample_normal(args.seed, first + i, s, args.n_samples, device)
            if args.freeinit_iters > 1:
                video = pipe.sample_with_freeinit(prompt, normal=normal,
                                                  iterations=args.freeinit_iters, **size)
            else:
                video = pipe(prompt, normal=normal, use_ddpm=args.ddim_steps <= 0, **size)
            samples.append(_host_frames(video))
        save_video_grid(samples, path(prompt), fps=args.savefps)
        log.info("[%d/%d] %.1fs %s", i + 1, len(shard), time.perf_counter() - t0, prompt[:60])


def _entry():
    main(build_parser().parse_args())


if __name__ == "__main__":
    _entry()
