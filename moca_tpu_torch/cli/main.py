"""MoCA-Video CLI on the port; the flags are the reference's videocrafter_main.py's.

Port of moca_tpu/cli/main.py: the same flags and defaults, the same output
layout and the same tail slices, run by moca_tpu_torch on the GPU.

Prompt mode:
    python -m moca_tpu_torch.cli.main --ckpt_path model.ckpt \
        --config configs/inference_t2v_512_v2.0.yaml \
        --prompt_file prompts/prompts.csv --prompt_index 0

DAVIS mode:
    python -m moca_tpu_torch.cli.main --use_davis --video_name blackswan ...

Several GPUs, one process each (parallel/mesh.py): every rank runs the
whole loop and the FIFO window batch and head decode are split over them;
rank 0 writes the files:
    torchrun --nproc_per_node N -m moca_tpu_torch.cli.main --mesh 1,N ...
`--mesh DP,FIFO` needs DP*FIFO ranks (torchrun's WORLD_SIZE); without
torchrun only `--mesh 1,1`, on a one-rank group the CLI starts and ends
itself. --rank / --num_processes still split the prompt rows.

Noise: --seed seeds the port's generator (sampling/ddim.py GeneratorNormal);
prompt row idx draws from a generator seeded with seed + idx.

An i2v config (LatentVisualDiffusion) runs as the JAX CLI runs it: the
MoCA path has no image input, so the model is the text-to-video bundle
with the config's U-Net, whose image cross-attention (to_k_ip / to_v_ip,
loaded from the checkpoint) attends to the context's tokens after the first
77, there the conditioned prompt's; the checkpoint's vision tower and
projector are skipped.

Ref: videocrafter_main.py:235-276 (argparse), :66-232 (main).
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from moca_tpu_torch import resolve_device
from moca_tpu_torch.config import load_model_config
from moca_tpu_torch.io.checkpoint import load_checkpoint
from moca_tpu_torch.io.davis import get_davis_prompt, load_davis_data
from moca_tpu_torch.io.prompts import load_prompts
from moca_tpu_torch.io.video import load_conditioning_image, save_video, tensor_to_uint8
from moca_tpu_torch.models.clip_vision import CLIPVisionConfig
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion, LatentVisualDiffusion
from moca_tpu_torch.models.tokenizer import load_tokenizer
from moca_tpu_torch.parallel.mesh import (
    barrier, initialize_distributed, is_lead, make_mesh, own_group,
)
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal
from moca_tpu_torch.sampling.moca import MoCAConfig
from moca_tpu_torch.utils.logging import get_logger
from moca_tpu_torch.utils.visualization import VisualizationSink

log = get_logger("moca_tpu_torch.cli")

DAVIS_FRAMES = 72  # frames read from a DAVIS clip (moca_tpu/cli/main.py:185)
PRECISIONS = {"bf16": torch.bfloat16, "fp32": torch.float32}


def precision_name(name: str) -> str:
    """--precision of the user scripts (eval_sweep, acceptance,
    generate_condition_images), which take every spelling that the JAX
    scripts' `_dtype_of` takes (moca_tpu/config.py:63-68): float32 and
    bfloat16 as fp32 and bf16. An argparse `type`; `choices` then refuses
    any other name."""
    return {"float32": "fp32", "bfloat16": "bf16"}.get(name, name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MoCA-Video on an NVIDIA GPU")
    # the reference's flags (videocrafter_main.py:236-269), defaults kept
    p.add_argument("--ckpt_path", type=str,
                   default="videocrafter_models/base_512_v2/model.ckpt")
    p.add_argument("--config", type=str, default="configs/inference_t2v_512_v2.0.yaml")
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--video_length", type=int, default=16, help="f in paper")
    p.add_argument("--num_partitions", "-n", type=int, default=4)
    p.add_argument("--num_inference_steps", type=int, default=16, help="forced to f*n")
    p.add_argument("--prompt_file", "-p", type=str, default="prompts/prompts.csv")
    p.add_argument("--new_video_length", "-l", type=int, default=100)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--save_frames", action="store_true", default=True)
    # The reference declares these three store_true with default=True, so
    # they cannot be turned off (videocrafter_main.py:249-252); negations added.
    p.add_argument("--no_save_frames", dest="save_frames", action="store_false")
    p.add_argument("--no_use_mp4", dest="use_mp4", action="store_false",
                   help="write .gif instead of .mp4")
    p.add_argument("--no_lookahead_denoising", dest="lookahead_denoising",
                   action="store_false")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--unconditional_guidance_scale", type=float, default=12.0)
    p.add_argument("--lookahead_denoising", "-ld", action="store_true", default=True)
    p.add_argument("--eta", "-e", type=float, default=1.0)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--use_mp4", action="store_true", default=True)
    p.add_argument("--output_fps", type=int, default=10)
    p.add_argument("--prompt_index", type=int, default=0)
    p.add_argument("--use_self_attention", type=bool, default=False)
    p.add_argument("--use_davis", action="store_true", default=False)
    p.add_argument("--davis_root", type=str, default="DAVIS")
    p.add_argument("--video_name", type=str, default=None)
    p.add_argument("--frame_stride", type=int, default=1)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--sampling_strategy", type=str, default="uniform",
                   choices=["first", "random", "uniform"])
    p.add_argument("--conditioned_image_path", type=str, default="assets/cats.png")
    # additions of the JAX package, same meaning here
    p.add_argument("--precision", type=str, default="bf16", choices=sorted(PRECISIONS),
                   help="parameter type of the three towers")
    p.add_argument("--bpe_path", type=str, default=None,
                   help="CLIP BPE vocab (or MOCA_TPU_BPE_PATH)")
    p.add_argument("--inject_into_queue", action="store_true", default=False,
                   help="let concept injection reach the FIFO queue (the reference computes "
                        "x_prev before injection)")
    p.add_argument("--multiprompts", nargs="+", default=None,
                   help="multi-scene stream: N prompts followed by ONE comma-separated list "
                        "of N frame counts (fifo_ddim_sampling_multiprompts, funcs.py:375-381)")
    p.add_argument("--save_visualizations", action="store_true", default=False,
                   help="dump the reference's per-step pred_x0/mask/cond PNGs "
                        "(ddim.py:611-641, 849-899)")
    p.add_argument("--tail_mode", type=str, default="freeinit", choices=["freeinit", "plain"],
                   help="queue-tail refill on shift: freeinit = LPF anchor+noise mix "
                        "(funcs.py:86-99), plain = fresh noise (funcs_mp.py:39-46)")
    p.add_argument("--mesh", type=str, default=None, metavar="DP,FIFO",
                   help="split the FIFO window batch and head decode over DP*FIFO ranks, one "
                        "GPU each (torchrun --nproc_per_node DP*FIFO)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="snapshot the FIFO state every N iterations; a killed run resumes "
                        "from the last snapshot")
    return p


def load_model(args, device=None, visual: bool | None = False):
    """(LatentDiffusion from --config and --ckpt_path on `device`, the GPU
    unless the caller names one, in --precision; its ModelConfig). `visual`:
    the i2v LatentVisualDiffusion (ViT-H/14 tower, the config's projector),
    whose image towers stay fp32 (moca_tpu/cli/inference.py:81-99); None: as
    the config says (`is_i2v`)."""
    cfg = load_model_config(args.config)
    visual = cfg.is_i2v if visual is None else visual
    key = cfg.diffusion.conditioning_key
    if not (key == "crossattn" or (key == "hybrid" and visual)):
        raise NotImplementedError("the port runs the crossattn model, and the hybrid one "
                                  "(DynamiCrafter) as an i2v model")
    if not os.path.exists(args.ckpt_path):
        raise FileNotFoundError(f"Error: checkpoint [{args.ckpt_path}] Not Found!")
    device = resolve_device(device)
    log.info("loading checkpoint %s", args.ckpt_path)
    with torch.device(device):
        if visual:
            model = LatentVisualDiffusion(cfg.unet, cfg.vae, cfg.clip, CLIPVisionConfig(),
                                          cfg.finegrained, scale_factor=cfg.diffusion.scale_factor,
                                          image_video_length=cfg.image_video_length)
        else:
            model = LatentDiffusion(cfg.unet, cfg.vae, cfg.clip,
                                    scale_factor=cfg.diffusion.scale_factor)
    model.to(PRECISIONS[args.precision]).eval().requires_grad_(False)
    if visual:
        model.keep_image_towers_fp32()
    skipped = load_checkpoint(args.ckpt_path, model)
    log.info("skipped %d non-model checkpoint keys", len(skipped))
    return model, cfg


def parse_mesh(args):
    """--mesh 'DP,FIFO' -> DeviceMesh over the ranks (None without --mesh).
    It joins torchrun's ranks (WORLD_SIZE) or, with no process group and no
    WORLD_SIZE, starts a one-rank group for a 1x1 mesh."""
    if not getattr(args, "mesh", None):
        return None
    dp, fifo = (int(v) for v in args.mesh.split(","))
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != dp * fifo:
        raise ValueError(f"--mesh {dp},{fifo} needs DP*FIFO = {dp * fifo} ranks, but WORLD_SIZE "
                         f"is {world}; launch it with torchrun --nproc_per_node {dp * fifo}")
    if not dist.is_initialized():
        initialize_distributed(num_processes=None if "WORLD_SIZE" in os.environ else 1)
    return make_mesh((dp, fifo))


def load_pipeline(args, device=None) -> MoCAVideoPipeline:
    """`load_model` behind a MoCAVideoPipeline on the --mesh ranks."""
    mesh = parse_mesh(args)
    model, cfg = load_model(args, device)
    moca = MoCAConfig(gamma=args.gamma, inject_into_queue=args.inject_into_queue)
    return MoCAVideoPipeline(
        model, load_tokenizer(args.bpe_path), video_length=args.video_length,
        num_partitions=args.num_partitions, new_video_length=args.new_video_length,
        guidance_scale=args.unconditional_guidance_scale, eta=args.eta, fps=args.fps,
        lookahead_denoising=args.lookahead_denoising, moca=moca,
        use_scale=cfg.diffusion.use_scale, checkpoint_every=args.checkpoint_every,
        tail_mode=args.tail_mode, uncond_type=cfg.diffusion.uncond_type, mesh=mesh)


def set_directory(args, prompt: str, conditioned_image_path: str):
    """Output and latents directories (videocrafter_main.py:25-63)."""
    if args.output_dir is None:
        output_dir = f"results/moca_tpu/{prompt[:100]}"
        if args.eta != 1.0:
            output_dir += f"/eta{args.eta}"
        if args.new_video_length != 100:
            output_dir += f"/{args.new_video_length}frames"
    else:
        output_dir = args.output_dir
    latents_dir = (f"results/moca_tpu/latents/{args.num_inference_steps}steps/"
                   f"{prompt[:100]}/eta{args.eta}")
    stem = os.path.splitext(os.path.basename(conditioned_image_path))[0]
    output_dir = os.path.join(output_dir, stem)
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(latents_dir, exist_ok=True)
    return output_dir, latents_dir


def main(args):
    """Run the CLI; a process group that --mesh started here ends with it."""
    with own_group():
        _run(args)


def _run(args):
    args.num_inference_steps = args.video_length * args.num_partitions
    pipe = load_pipeline(args)
    lead = is_lead(pipe.mesh)
    device = pipe.model.device
    latent_hw = (args.height // 8, args.width // 8)

    if args.use_davis:
        if not args.video_name:
            raise ValueError("--video_name required with --use_davis")
        frames, masks = load_davis_data(args.video_name, args.davis_root, video_size=latent_hw,
                                        video_frames=DAVIS_FRAMES,
                                        sampling_strategy=args.sampling_strategy)
        prompt = get_davis_prompt(args.video_name) + " cat."
        output_dir, _ = set_directory(args, args.video_name, args.conditioned_image_path)
        cond_image = load_conditioning_image(args.conditioned_image_path, latent_hw)
        normal = GeneratorNormal(args.seed, device)
        clean = pipe.model.encode_frames(frames[None], normal)
        video = pipe(prompt, normal=normal, cond_image=cond_image, gamma=args.gamma,
                     height=args.height, width=args.width, clean_latents=clean, masks=masks,
                     davis_frames=frames)
        out = os.path.join(output_dir, args.video_name)
        keep = video[: args.new_video_length // 2]  # videocrafter_main.py:172
        if lead:
            save_video(keep, out + (".mp4" if args.use_mp4 else ".gif"), fps=args.output_fps)
            log.info("wrote %s", out)
        barrier(pipe.mesh)
        return

    prompt_list = load_prompts(args.prompt_file, args.prompt_index)
    for idx in list(range(len(prompt_list)))[args.rank:: args.num_processes]:
        data = prompt_list[idx]
        prompt = data["prompt"]
        output_dir, latents_dir = set_directory(args, prompt, data["conditioned_image_path"])
        cond_image = load_conditioning_image(data["conditioned_image_path"], latent_hw)
        frame_cb = viz = None
        if args.save_frames and lead:
            # per-frame PNGs (funcs.py:362-365 fifo/{i}.png)
            sink = VisualizationSink(output_dir)

            def frame_cb(i, frame, _sink=sink):
                _sink.frame(i, tensor_to_uint8(frame))

        if args.save_visualizations:
            viz = VisualizationSink(os.path.join(output_dir, "visualizations"))
        multiprompts = None
        if args.multiprompts:
            *mp_prompts, mp_lengths = args.multiprompts
            counts = [int(v) for v in mp_lengths.split(",")]
            if len(counts) != len(mp_prompts):
                raise ValueError("--multiprompts needs N prompts + one comma-separated list "
                                 "of N frame counts")
            multiprompts = list(zip(mp_prompts, counts))
        video = pipe(prompt, seed=args.seed + idx, cond_image=cond_image,
                     conditioned_prompt=data["conditioned_prompt"], gamma=data["gamma"],
                     height=args.height, width=args.width, latents_dir=latents_dir,
                     frame_callback=frame_cb, viz=viz, multiprompts=multiprompts)
        out = os.path.join(output_dir, prompt[:100])
        # videocrafter_main.py:230: video_frames[-new_video_length//2:]; the
        # unary minus binds inside the floor division, so odd N keeps ceil(N/2)
        keep = video[-args.new_video_length // 2:]
        if lead:
            save_video(keep, out + (".mp4" if args.use_mp4 else ".gif"), fps=args.output_fps)
            log.info("wrote %s", out)
        barrier(pipe.mesh)


def _entry():
    main(build_parser().parse_args())


if __name__ == "__main__":
    _entry()
