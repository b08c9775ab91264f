"""Batch text-to-video CLI (VideoCrafter2's scripts/evaluation/inference.py) on the port.

Port of moca_tpu/cli/inference.py: the same flags and defaults, the same
output layout (one mp4 per prompt, its --n_samples side by side), run by
moca_tpu_torch on the GPU:

    python -m moca_tpu_torch.cli.inference --ckpt_path model.ckpt \
        --prompt_file prompts.txt --savedir results/t2v --bs 4

  * the prompt file (one prompt a line), cut into contiguous shards by
    --num_processes / --rank (inference.py:71-77);
  * --bs prompts sampled in one batch a round (inference.py:30,92-101),
    base sampling only;
  * --n_samples samples a prompt, written side by side (funcs.py:600-612);
  * --freeinit_iters > 1: FreeInit re-sampling;
    --unconditional_guidance_scale_temporal: temporal guidance;
    --ddim_steps <= 0: ancestral DDPM;
  * --mode i2v: one conditioning image a prompt (.mp4/.png/.jpg in
    --cond_image_dir, sorted), read at (--height, --width), RGB; its CLIP
    image tokens (LatentVisualDiffusion.get_image_embeds) are appended to
    the text context, and the mp4 is named after the image's stem
    (inference.py:82-84,110-117). FreeInit samples without the image
    tokens, as the JAX CLI does. --mode i2v or an i2v config loads the i2v
    model; i2v runs one prompt a call (--bs 1);
  * a hybrid i2v config (DynamiCrafter's, configs/dynamicrafter_inference_1024_v1.0.yaml):
    the image's VAE latent is concatenated to every frame's input and the
    unconditional row's image tokens are an all-zero image's
    (`T2VPipeline.image_condition`); the config's zero-SNR v-prediction
    schedule is used, and DynamiCrafter's own flags set the rest:
        python -m moca_tpu_torch.cli.inference --mode i2v \
            --config configs/dynamicrafter_inference_1024_v1.0.yaml --height 576 --width 1024 \
            --frame_stride 10 --unconditional_guidance_scale 7.5 --guidance_rescale 0.7 \
            --timestep_spacing uniform_trailing --ddim_eta 1.0 ...
    (--frame_stride is the U-Net's frame-stride condition, in --fps's place;
    --guidance_rescale rescales the guided output, samplers/ddim.py;
    --timestep_spacing the DDIM timesteps, uniform by default);
  * --mesh DP,FIFO: one process a GPU (parallel/mesh.py), the 2*--bs CFG
    rows of each U-Net call and the decode's frame rows split over the ranks
    where they tile them, rank 0 writing the mp4s:
        torchrun --nproc_per_node N -m moca_tpu_torch.cli.inference --mesh 1,N ...
    Without torchrun only --mesh 1,1 (a one-rank group the CLI starts and
    ends itself). --rank / --num_processes still split the prompt file.

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

from moca_tpu_torch.cli.main import PRECISIONS, load_model, parse_mesh
from moca_tpu_torch.io.video import load_image_batch, save_video_grid
from moca_tpu_torch.models.tokenizer import load_tokenizer
from moca_tpu_torch.parallel.mesh import barrier, is_lead, own_group
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
    p.add_argument("--frame_stride", type=int, default=None,
                   help="the frame-stride condition of a DynamiCrafter U-Net (fs), in --fps's "
                        "place; by default --fps")
    p.add_argument("--guidance_rescale", type=float, default=0.0,
                   help="rescale the guided output to the conditional output's std by this "
                        "share (DynamiCrafter's samplers/ddim.py); 0 = off")
    p.add_argument("--timestep_spacing", type=str, default="uniform",
                   choices=["uniform", "uniform_trailing"],
                   help="DDIM timesteps: uniform (linspace 0..999) or uniform_trailing "
                        "(DynamiCrafter: 19, 39, ..., 999 for 50 steps)")
    p.add_argument("--savefps", type=int, default=10)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16", choices=sorted(PRECISIONS))
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--freeinit_iters", type=int, default=0,
                   help="FreeInit noise-reinit iterations (0 = off)")
    p.add_argument("--mode", type=str, default="base", choices=["base", "i2v"],
                   help="i2v: per-prompt conditioning images whose CLIP tokens are appended to "
                        "the text context (inference.py:110-117)")
    p.add_argument("--cond_image_dir", "--cond_input", type=str, default=None,
                   dest="cond_image_dir",
                   help="i2v mode: directory of images matched to prompts by sorted order "
                        "(--cond_input is the reference's flag name, inference.py:38)")
    p.add_argument("--mesh", type=str, default=None, metavar="DP,FIFO",
                   help="split the CFG rows and the decode over DP*FIFO ranks, one GPU each "
                        "(torchrun --nproc_per_node DP*FIFO)")
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
    `device`, the GPU unless the caller names one, behind a T2VPipeline; the
    i2v model with --mode i2v or an i2v config (moca_tpu/cli/inference.py:107-108),
    on the --mesh ranks."""
    mesh = parse_mesh(args)
    model, cfg = load_model(args, device, visual=True if args.mode == "i2v" else None)
    return T2VPipeline.build(
        model, load_tokenizer(args.bpe_path), num_steps=args.ddim_steps, eta=args.ddim_eta,
        use_scale=cfg.diffusion.use_scale, guidance_scale=args.unconditional_guidance_scale,
        fps=args.fps if args.frame_stride is None else args.frame_stride,
        temporal_cfg_scale=args.unconditional_guidance_scale_temporal,
        uncond_type=cfg.diffusion.uncond_type, mesh=mesh,
        guidance_rescale=args.guidance_rescale,
        hybrid=cfg.diffusion.conditioning_key == "hybrid",
        ddim_discretize=args.timestep_spacing, **cfg.sampling.schedule_kwargs())


def _host_frames(video: torch.Tensor):
    return list(video.float().cpu().numpy())


COND_EXTENSIONS = (".mp4", ".png", ".jpg")  # get_filelist's '[mpj][pn][4gj]' (funcs.py:567-573)


def load_cond_images(args, n_prompts: int):
    """(images [n, H, W, 3] in [-1, 1], their stems): the conditioning files
    of --cond_image_dir with a known extension, sorted, read at (--height,
    --width) and cut to RGB (the reference's png/jpg path keeps RGBA and then
    fails in its 3-channel normalize; DECISIONS.md). One image a prompt over
    the whole prompt file (inference.py:83)."""
    if not args.cond_image_dir:
        raise ValueError("--cond_image_dir required for i2v")
    files = sorted(f for f in os.listdir(args.cond_image_dir) if f.endswith(COND_EXTENSIONS))
    images = load_image_batch([os.path.join(args.cond_image_dir, f) for f in files],
                              (args.height, args.width))[..., :3]
    if len(images) != n_prompts:
        raise ValueError(f"Error: conditional input ({len(images)}) NOT match prompt "
                         f"({n_prompts})!")
    return images, [os.path.splitext(f)[0] for f in files]


def main(args, pipe: T2VPipeline = None):
    """Write one mp4 per prompt of this process's shard into --savedir.
    `pipe` stands in for the pipeline `load_pipeline` builds from the files.
    A process group that --mesh started here ends with it."""
    with own_group():
        _run(args, pipe)


def _run(args, pipe):
    if args.bs > 1 and (args.mode != "base" or args.freeinit_iters > 1 or args.n_samples != 1):
        raise ValueError("--bs>1 supports plain base sampling")
    with open(args.prompt_file) as f:
        prompts = [line.strip() for line in f if line.strip()]
    cond_images = cond_names = None
    if args.mode == "i2v":
        cond_images, cond_names = load_cond_images(args, len(prompts))
    pipe = load_pipeline(args) if pipe is None else pipe
    # contiguous shard per process (inference.py:71-77)
    per = -(-len(prompts) // args.num_processes)
    first = args.rank * per
    shard = prompts[first: first + per]
    os.makedirs(args.savedir, exist_ok=True)
    device = pipe.model.device
    size = dict(height=args.height, width=args.width, frames=args.frames)
    path = lambda prompt: os.path.join(args.savedir, prompt[:100].replace("/", "_") + ".mp4")

    def save(samples, out_path):
        if is_lead(pipe.mesh):
            save_video_grid(samples, out_path, fps=args.savefps)
        barrier(pipe.mesh)

    if args.bs > 1:
        for r0 in range(0, len(shard), args.bs):
            chunk = shard[r0: r0 + args.bs]
            t0 = time.perf_counter()
            videos = pipe(chunk, normal=sample_normal(args.seed, first + r0, 0, 1, device),
                          use_ddpm=args.ddim_steps <= 0, **size)
            for prompt, video in zip(chunk, videos):
                save([_host_frames(video)], path(prompt))
            log.info("batch [%d:%d]/%d %.1fs", r0, r0 + len(chunk), len(shard),
                     time.perf_counter() - t0)
        return

    for i, prompt in enumerate(shard):
        t0 = time.perf_counter()
        out_path = path(prompt)
        if cond_images is not None:  # global prompt index == image index
            out_path = os.path.join(args.savedir, cond_names[first + i] + ".mp4")
        samples = []
        for s in range(args.n_samples):
            normal = sample_normal(args.seed, first + i, s, args.n_samples, device)
            cond = ({} if cond_images is None
                    else pipe.image_condition(cond_images[first + i][None], normal))
            if args.freeinit_iters > 1:  # without the image tokens, as the JAX CLI
                video = pipe.sample_with_freeinit(prompt, normal=normal,
                                                  iterations=args.freeinit_iters, **size)
            else:
                video = pipe(prompt, normal=normal, use_ddpm=args.ddim_steps <= 0, **cond,
                             **size)
            samples.append(_host_frames(video))
        save(samples, out_path)
        log.info("[%d/%d] %.1fs %s", i + 1, len(shard), time.perf_counter() - t0, prompt[:60])


def _entry():
    main(build_parser().parse_args())


if __name__ == "__main__":
    _entry()
