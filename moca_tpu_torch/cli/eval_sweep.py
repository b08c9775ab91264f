"""Evaluation sweep on the port: prompts.csv -> MoCA videos -> metrics and VBench configs.

Port of scripts/eval_sweep.py, with its flags and outputs, run by
moca_tpu_torch on the GPU:

    python -m moca_tpu_torch.cli.eval_sweep --ckpt_path model.ckpt \
        --prompt_file prompts/prompts.csv --out_dir results/eval_sweep \
        [--clip_vision_ckpt visual.pt] [--lpips_ckpt lpips.pt] [--i3d_ckpt i3d.pt]

Prompt rows are dealt round-robin over --num_processes (the reference's
videocrafter_main.py:180-181). Each row runs MoCAVideoPipeline (f=16, n=4,
guidance 12, eta 1, fps 10, lookahead, gamma 0.5 beside the row's own) and
writes `{idx:03d}.mp4` (the last new_video_length // 2 frames); its metrics
are the adjacent-frame SSIM / PSNR and the temporal proxy. When the base
(unmixed) sample's latents are cached, its decoded clip is the source video
of three metrics that run only when their weights are given:

  * --clip_vision_ckpt (an OpenCLIP ViT-H/14 visual state dict, no prefix):
    CASS / relCASS from the frames' pooled embeddings and the prompt and
    conditioned prompt's text embeddings, from --ckpt_path's whole text tower
    (`io.checkpoint.load_text_tower`); the tower runs in fp32, the text
    tower in --precision, as in the JAX sweep;
  * --lpips_ckpt (a torch file {'alexnet': sd, 'lpips': sd}): LPIPS-I / -T;
  * --i3d_ckpt (pytorch-i3d's i3d_pretrained_400.pt state dict): FVD of the
    edited set against the source set (eval/fvd.py StreamingFVD).

`metrics_rank{r}.json` has the JAX sweep's keys, and the VBench full_info
config lists the videos. Noise: prompt row idx draws from
`cli.inference.sample_normal(seed, idx, 0, 1)`, a generator seeded from
(seed, idx) (the JAX sweep folds idx into its key). `main(args, pipe=...)`
takes a MoCAVideoPipeline in place of the one --config and --ckpt_path give.
"""

from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np
import torch

from moca_tpu_torch.cli.inference import sample_normal
from moca_tpu_torch.cli.main import PRECISIONS, load_pipeline
from moca_tpu_torch.eval.metrics import (
    concept_alignment_scores, psnr, ssim, temporal_lpips_proxy)
from moca_tpu_torch.eval.vbench import write_full_info
from moca_tpu_torch.io.prompts import load_prompts
from moca_tpu_torch.io.video import load_conditioning_image, save_video
from moca_tpu_torch.models.clip_vision import CLIPVisionConfig

CASS_CONVENTION = (
    "CASS/relCASS follow moca_tpu's own x100 convention "
    "(eval/metrics.py); NOT directly comparable to the paper's "
    "published 4.93/1.23 — the paper ships no metric code")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("evaluation sweep")
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--config", default="configs/inference_t2v_512_v2.0.yaml")
    p.add_argument("--prompt_file", default="prompts/prompts.csv")
    p.add_argument("--out_dir", default="results/eval_sweep")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--new_video_length", type=int, default=100)
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--bpe_path", default=None)
    p.add_argument("--precision", default="bf16", choices=sorted(PRECISIONS))
    # the Table-2 metrics whose weights the t2v checkpoint lacks
    p.add_argument("--clip_vision_ckpt", default=None,
                   help="OpenCLIP ViT-H visual state_dict → CASS/relCASS")
    p.add_argument("--lpips_ckpt", default=None,
                   help="torch file with {'alexnet': sd, 'lpips': sd} → LPIPS-I/T")
    p.add_argument("--i3d_ckpt", default=None,
                   help="pytorch-i3d i3d_pretrained_400.pt state_dict → "
                        "FVD(edited set, source set)")
    return p


def sweep_pipeline(args):
    """The MoCA pipeline of --config and --ckpt_path with the sweep's fixed
    settings (scripts/eval_sweep.py:56-62)."""
    a = types.SimpleNamespace(**vars(args))
    a.video_length, a.num_partitions = 16, 4
    a.unconditional_guidance_scale, a.eta, a.fps = 12.0, 1.0, 10
    a.lookahead_denoising, a.gamma, a.inject_into_queue = True, 0.5, False
    a.tail_mode, a.checkpoint_every = "freeinit", 0
    return load_pipeline(a)


def _cass_fns(args, pipe, device):
    """(frame embedder, text embedder): the fp32 ViT-H/14 tower of
    --clip_vision_ckpt and the whole text tower of --ckpt_path."""
    from moca_tpu_torch.io.checkpoint import load_text_tower, load_torch_state_dict
    from moca_tpu_torch.models.clip_vision import CLIPVisionEncoder

    with torch.device(device):
        vision = CLIPVisionEncoder(CLIPVisionConfig())
    vision.eval().requires_grad_(False)
    vision.load_state_dict(load_torch_state_dict(args.clip_vision_ckpt), strict=True)
    text = load_text_tower(args.ckpt_path, pipe.model.clip_cfg, device,
                           PRECISIONS[args.precision])

    @torch.inference_mode()
    def embed_frames(video):  # [T, H, W, 3] in [-1, 1] -> [T, output_dim]
        return vision(video)

    @torch.inference_mode()
    def embed_text(prompt):
        tokens = torch.as_tensor(pipe.tokenizer([prompt]), dtype=torch.long, device=device)
        return text(tokens, output="embed")[0]

    return embed_frames, embed_text


def main(args, pipe=None):
    """Run the sweep over this rank's prompt rows; `pipe` stands in for the
    pipeline that --config and --ckpt_path give. Returns the summary it
    prints."""
    pipe = sweep_pipeline(args) if pipe is None else pipe
    pipe.new_video_length = args.new_video_length
    device = pipe.model.device
    prompts = load_prompts(args.prompt_file)
    indices = list(range(len(prompts)))[args.rank:: args.num_processes]
    os.makedirs(args.out_dir, exist_ok=True)

    cass_fns = _cass_fns(args, pipe, device) if args.clip_vision_ckpt else None
    lpips_fns = None
    if args.lpips_ckpt:
        from moca_tpu_torch.eval.metrics import convert_lpips_weights, lpips_i, lpips_t

        blob = torch.load(args.lpips_ckpt, map_location="cpu")
        net, lins = convert_lpips_weights(blob["alexnet"], blob["lpips"])
        lpips_fns = (net.to(device), lins, lpips_i, lpips_t)
    fvd_stream = None
    if args.i3d_ckpt:
        from moca_tpu_torch.eval.fvd import StreamingFVD
        from moca_tpu_torch.eval.i3d import convert_i3d_weights, i3d_feature_fn

        # per-pair [1, 400] feature rows as the videos arrive, not the videos
        fvd_stream = StreamingFVD(i3d_feature_fn(convert_i3d_weights(
            torch.load(args.i3d_ckpt, map_location="cpu")), device))

    entries, metrics = [], {}
    for idx in indices:
        row = prompts[idx]
        cond = load_conditioning_image(row["conditioned_image_path"], (40, 64))
        latents_dir = os.path.join(args.out_dir, f"latents_{idx}")
        frames = pipe(row["prompt"], normal=sample_normal(args.seed, idx, 0, 1, device),
                      cond_image=cond, conditioned_prompt=row["conditioned_prompt"],
                      gamma=row["gamma"], latents_dir=latents_dir)
        video_path = os.path.join(args.out_dir, f"{idx:03d}.mp4")
        save_video(frames[-args.new_video_length // 2:], video_path, fps=10)
        with torch.inference_mode():
            vid = torch.as_tensor(np.stack(frames), device=device)
            unit = (vid + 1) / 2
            metrics[idx] = {
                "prompt": row["prompt"],
                "temporal_consistency": float(temporal_lpips_proxy(unit)),
                "frame_ssim_adjacent": float(torch.mean(ssim(unit[:-1], unit[1:]))),
                "frame_psnr_adjacent": float(torch.mean(psnr(unit[:-1], unit[1:]))),
            }
            # the source (unmixed) video from the cached base latents: the
            # CASS / LPIPS-I / FVD comparison target (Table 2)
            src_vid = None
            base_cache = os.path.join(latents_dir, f"{pipe.num_inference_steps}.npz")
            if (cass_fns or lpips_fns or fvd_stream) and os.path.exists(base_cache):
                base = torch.as_tensor(np.load(base_cache)["latents"], device=device)
                src_vid = pipe.model.decode_latents(base)[0].float()
            if cass_fns is not None and src_vid is not None:
                embed_frames, embed_text = cass_fns
                scores = concept_alignment_scores(
                    embed_frames(src_vid), embed_frames(vid[: len(src_vid)]),
                    embed_text(row["prompt"]),
                    embed_text(row["conditioned_prompt"] or row["prompt"]))
                metrics[idx].update({k: float(v) for k, v in scores.items()})
            if lpips_fns is not None and src_vid is not None:
                net, lins, f_i, f_t = lpips_fns
                n = min(len(src_vid), len(vid))
                metrics[idx]["lpips_i"] = float(f_i(src_vid[:n], vid[:n], net, lins))
                metrics[idx]["lpips_t"] = float(f_t(vid, net, lins))
            if fvd_stream is not None and src_vid is not None:
                fvd_stream.add(((vid + 1) / 2).cpu().numpy(), ((src_vid + 1) / 2).cpu().numpy())
        entries.append({"prompt": row["prompt"], "video_path": video_path})

    write_full_info(args.out_dir, entries)
    if cass_fns is not None:  # no CASS reference code to calibrate against
        metrics["_cass_convention"] = CASS_CONVENTION
    if fvd_stream is not None:  # a set metric: None with < 2 pairs
        r = fvd_stream.result()
        metrics["_fvd_edited_vs_source"] = None if r is None else float(r)
        if fvd_stream.skipped:
            metrics["_fvd_videos_skipped"] = fvd_stream.skipped
    with open(os.path.join(args.out_dir, f"metrics_rank{args.rank}.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    summary = {"videos": len(entries)}
    if cass_fns is not None:
        summary["cass_convention"] = CASS_CONVENTION
    print(json.dumps(summary))
    return summary


def _entry():
    main(build_parser().parse_args())


if __name__ == "__main__":
    _entry()
