"""One-command real-weights acceptance certification on the port.

Port of scripts/acceptance.py: the same stages, flags, defaults, artifact
names and verdict keys, so that one reader serves both packages' verdicts.
A user who holds the VideoCrafter2 weights gets the BASELINE.md verdict
(per-frame SSIM >= 0.98 against the CUDA reference) from the port, on the
GPU, in one command:

    python -m moca_tpu_torch.cli.acceptance \
        --ckpt /path/model.ckpt \
        --bpe /path/bpe_simple_vocab_16e6.txt.gz \
        [--config configs/inference_t2v_512_v2.0.yaml] \
        [--reference_frames ref.npz | dir-of-PNGs] \
        [--out acceptance.json] [--skip_oracles] [--reference_repo VideoCrafter]

Stages (each records ok / detail in the one-line JSON verdict):
  convert   — the torch checkpoint read directly into the port's towers
              (io/checkpoint.py: plain, Lightning and DeepSpeed layouts;
              LitEma shadows loaded when present), strictly, on the GPU in
              --precision (default fp32); key count, each tower's parameter
              count, every tensor finite
  tokenizer — the BPE table loads; known-answer ids when the real 16e6
              vocab is detected (openai/CLIP published tokenizations)
  oracles   — the reference's towers at the full shipped size held to the
              port's (`python -m moca_tpu_torch.cli.full_oracle_check`, in
              a subprocess, an hour at most; skipped cleanly when the
              reference repository named by --reference_repo is absent)
  golden    — a seeded concept-mixed MoCA clip with the loaded weights
              (videocrafter_main.py defaults: 512x320, f=16, n=4, 16 new
              frames, guidance 12, seed 321, f x n DDIM steps), finite and
              saved to --artifacts (golden_frames.npz, golden.mp4,
              frame_NNNN.png) for the CUDA side to diff. --masks (detector
              masks exported from the reference run) drives the injection
              path through PrecomputedMaskProvider. Faithful to the
              reference, injection and the gamma blend touch only the
              returned pred_x0 — the queue write-back x_prev is computed
              first (ddim.py:562 vs :565-609) and funcs.py decodes queue
              latents — so the emitted frames are identical with or without
              masks, and the SSIM gate is valid either way;
              --inject_into_queue opts into the documented fixed mode
              (frames then change; not for reference-parity runs).
  ssim      — per-frame SSIM (eval/metrics.py) of the golden clip against
              --reference_frames, tail-aligned, gated at --ssim_threshold
              (default 0.98, BASELINE.md)

The reference CLI exports the LAST new_video_length // 2 frames
(videocrafter_main.py:230); the golden stage keeps the same tail slice.
Reference frames: uint8 PNGs, or one .npz with key "frames" [N, H, W, 3]
float in [-1, 1]; detector masks: .npz key "masks" [T, H/8, W/8] binary.

Noise: the golden clip draws from `GeneratorNormal(--seed)` (the port's
generator); the numbers are not JAX's, so the port's golden clip and the
JAX package's agree only in distribution. Unlike the JAX script, which
imports the reference from a fixed location, the oracles stage takes the
reference repository's path from --reference_repo.

Exit code 0 iff no stage failed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from moca_tpu_torch import resolve_device
from moca_tpu_torch.cli.main import PRECISIONS, precision_name
from moca_tpu_torch.config import load_model_config
from moca_tpu_torch.eval.metrics import ssim
from moca_tpu_torch.io.checkpoint import load_torch_state_dict, split_checkpoint
from moca_tpu_torch.io.segmentation import PrecomputedMaskProvider
from moca_tpu_torch.io.video import save_video, tensor_to_uint8, uint8_to_tensor
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.tokenizer import SimpleTokenizer
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal
from moca_tpu_torch.sampling.moca import MoCAConfig

ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package
TOWERS = ("unet", "vae", "clip")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="VideoCrafter2 model.ckpt")
    p.add_argument("--bpe", required=True, help="OpenCLIP bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--config", default="configs/inference_t2v_512_v2.0.yaml")
    p.add_argument("--reference_frames", default=None,
                   help=".npz with 'frames' [N,H,W,3] in [-1,1], or a directory of frame_*.png "
                        "from the CUDA reference (the exported clip = the LAST "
                        "new_video_length//2 frames; streams are compared tail-aligned)")
    p.add_argument("--masks", default=None,
                   help=".npz with 'masks' [T, H/8, W/8] binary detector masks exported from "
                        "the reference run; routes them through PrecomputedMaskProvider so the "
                        "injection path runs (faithful to the reference, injection touches "
                        "only pred_x0: the emitted frames change only with "
                        "--inject_into_queue, ddim.py:562 vs :565-609)")
    p.add_argument("--inject_into_queue", action="store_true", default=False,
                   help="the documented 'fixed' injection mode (MoCAConfig.inject_into_queue): "
                        "injected pred_x0 feeds the queue write-back; OFF for reference "
                        "parity runs")
    p.add_argument("--out", default="acceptance.json")
    p.add_argument("--artifacts", default="acceptance_artifacts",
                   help="golden-clip frames/video land here")
    p.add_argument("--prompt", default="a cat running on the grass")
    p.add_argument("--conditioned_prompt", default="a cat")
    p.add_argument("--target", default="cat")
    p.add_argument("--seed", type=int, default=321)  # videocrafter_main.py:249
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--num_partitions", type=int, default=4)
    p.add_argument("--new_video_length", type=int, default=16)
    p.add_argument("--guidance_scale", type=float, default=12.0)
    p.add_argument("--ssim_threshold", type=float, default=0.98)
    p.add_argument("--skip_oracles", action="store_true",
                   help="skip the full-size reference-tower oracles (they need the reference "
                        "repository + ~25 GB RAM)")
    p.add_argument("--skip_golden", action="store_true",
                   help="certify conversion/tokenizer/oracles only")
    p.add_argument("--precision", default=None, type=precision_name, choices=sorted(PRECISIONS),
                   help="parameter type of the towers, bf16 (bfloat16) or fp32 (float32); "
                        "default fp32")
    p.add_argument("--reference_repo", default="VideoCrafter",
                   help="the upstream VideoCrafter repository (holds lvdm/), for the oracles")
    return p


def _stage(report, name):
    report["stages"][name] = entry = {"ok": None}
    return entry


def stage_convert(args, report, device):
    """The checkpoint into a LatentDiffusion on `device`; returns (config,
    model), or None when a tower holds a non-finite value."""
    entry = _stage(report, "convert")
    cfg = load_model_config(args.config)
    sd = load_torch_state_dict(args.ckpt)
    entry["ckpt_keys"] = len(sd)
    entry["ema_shadow_present"] = any(k.startswith("model_ema.") for k in sd)
    use_ema = entry["ema_shadow_present"]
    if use_ema:
        # inference uses the EMA weights when a LitEma shadow exists
        # (ddpm3d.py ema_scope); the shipped ckpt has use_ema false
        entry["note"] = "LitEma shadow found; loading EMA weights"
    with torch.device(device):
        model = LatentDiffusion(cfg.unet, cfg.vae, cfg.clip,
                                scale_factor=cfg.diffusion.scale_factor)
    model.to(PRECISIONS[args.precision or "fp32"]).eval().requires_grad_(False)
    towers, _ = split_checkpoint(sd, model, use_ema)
    del sd
    for name in TOWERS:
        tower = getattr(model, name)
        tower.load_state_dict(towers[name], strict=True)
        params = list(tower.parameters())
        entry[f"{name}_params"] = sum(p.numel() for p in params)
        if not all(bool(torch.isfinite(p).all()) for p in params):
            entry["ok"] = False
            entry["error"] = f"non-finite values in the loaded {name} tower"
            return None
    entry["ok"] = True
    return cfg, model


def stage_tokenizer(args, report):
    entry = _stage(report, "tokenizer")
    tok = SimpleTokenizer(args.bpe)
    framed = tok([args.prompt])
    entry["vocab_size"] = tok.sot + 2  # sot = vocab-2 by construction
    entry["prompt_tokens"] = int((framed[0] != 0).sum())
    if tok.sot == 49406:  # the real 16e6 table -> pin published ids
        known = {
            "a diagram": [320, 22697],
            "a dog": [320, 1929],
            "a cat": [320, 2368],
            "a photo of a cat": [320, 1125, 539, 320, 2368],
        }
        mismatches = {t: (tok.encode(t), ids) for t, ids in known.items()
                      if tok.encode(t) != ids}
        entry["known_answer_checked"] = True
        if mismatches:
            entry["ok"] = False
            entry["error"] = f"BPE known-answer mismatch: {mismatches}"
            return None
    else:
        entry["known_answer_checked"] = False
        entry["note"] = ("vocab is not the 49408-entry CLIP table; "
                         "known-answer ids not applicable")
    entry["ok"] = True
    return tok


def stage_oracles(args, report):
    """The full-size reference towers against the port's, in a subprocess
    (an hour at most): skipped when the reference repository or torch's
    prerequisites are missing, failed on a wrong reading."""
    entry = _stage(report, "oracles")
    if args.skip_oracles:
        entry["ok"] = None
        entry["skipped"] = "--skip_oracles"
        return
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-m", "moca_tpu_torch.cli.full_oracle_check",
                            "--reference_repo", os.path.abspath(args.reference_repo)],
                           capture_output=True, text=True, timeout=3600, cwd=ROOT)
    except subprocess.TimeoutExpired:
        entry["ok"] = False
        entry["error"] = "full_oracle_check timed out (1h)"
        return
    entry["seconds"] = round(time.time() - t0, 1)
    m = re.search(r"FULL ORACLE OK\s+unet=([\d.e+-]+)\s+vae=([\d.e+-]+)", r.stdout)
    if r.returncode == 0 and m:
        entry["unet_max_err"] = float(m.group(1))
        entry["vae_max_err"] = float(m.group(2))
        entry["ok"] = True
        return
    tail = (r.stderr or r.stdout).strip().splitlines()[-5:]
    if any(s in (r.stderr or "") for s in
           ("No module named", "ModuleNotFoundError", "FileNotFoundError")):
        # the reference repo isn't on the user's machine — the oracles
        # certify the towers' code, not the weights; record and move on
        entry["ok"] = None
        entry["skipped"] = f"oracle prerequisites missing: {tail[-1]}"
        return
    entry["ok"] = False
    entry["error"] = tail


def stage_golden(args, report, cfg, model, tok):
    entry = _stage(report, "golden")
    pipe = MoCAVideoPipeline(
        model, tok, video_length=args.video_length, num_partitions=args.num_partitions,
        new_video_length=args.new_video_length, guidance_scale=args.guidance_scale,
        moca=MoCAConfig(inject_into_queue=args.inject_into_queue),
        use_scale=cfg.diffusion.use_scale, uncond_type=cfg.diffusion.uncond_type,
        # deterministic lag-1 mask placement (the sync schedule) so the run
        # is reproducible against a reference-side mask export
        seg_async=False)
    mask_provider = None
    if args.masks is not None:
        mask_provider = PrecomputedMaskProvider(
            np.asarray(np.load(args.masks)["masks"], np.float32))
        entry["injection"] = "precomputed masks" + (
            " (into queue)" if args.inject_into_queue else
            " (pred_x0 only — reference-faithful; frames unchanged)")
    else:
        entry["injection"] = "inactive (no --masks): the injection gate requires masks"
    h, w = args.height // 8, args.width // 8
    # the reference's hard-coded conditioning image (assets/cats.png resized
    # to latent res, videocrafter_main.py:86-98) is a constant RGBA tensor;
    # a flat mid-gray stand-in keeps the run self-contained
    cond = np.full((h, w, 4), 0.5, np.float32)
    t0 = time.time()
    frames = pipe(args.prompt, normal=GeneratorNormal(args.seed, model.device), cond_image=cond,
                  conditioned_prompt=args.conditioned_prompt, gamma=0.5, height=args.height,
                  width=args.width, target=args.target, mask_provider=mask_provider)
    entry["seconds"] = round(time.time() - t0, 1)
    # the reference CLI exports the LAST new_video_length//2 frames
    # (videocrafter_main.py:230); NB -N//2 (floor): odd N keeps ceil(N/2)
    frames = frames[-args.new_video_length // 2:]
    arr = np.stack(frames)
    entry["frames"] = int(arr.shape[0])
    entry["finite"] = bool(np.isfinite(arr).all())
    os.makedirs(args.artifacts, exist_ok=True)
    np.savez(os.path.join(args.artifacts, "golden_frames.npz"), frames=arr)
    save_video(frames, os.path.join(args.artifacts, "golden.mp4"), fps=10)
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        for i, f in enumerate(frames):
            Image.fromarray(tensor_to_uint8(f)).save(
                os.path.join(args.artifacts, f"frame_{i:04d}.png"))
    entry["artifacts"] = os.path.abspath(args.artifacts)
    entry["ok"] = entry["finite"] and entry["frames"] > 0
    return arr if entry["ok"] else None


def load_reference_frames(path):
    """[N, H, W, 3] in [-1, 1] from an .npz ('frames') or a PNG directory."""
    if os.path.isdir(path):
        pngs = sorted(glob.glob(os.path.join(path, "*.png")))
        if not pngs:
            raise FileNotFoundError(f"no PNGs in {path}")
        from PIL import Image

        return np.stack([uint8_to_tensor(np.asarray(Image.open(p).convert("RGB")))
                         for p in pngs])
    return np.asarray(np.load(path)["frames"])


def stage_ssim(args, report, golden):
    entry = _stage(report, "ssim")
    if args.reference_frames is None:
        entry["ok"] = None
        entry["skipped"] = ("no --reference_frames given; generate them with the CUDA "
                            "reference at the same seed/prompt/shape and re-run")
        return
    if golden is None:
        entry["ok"] = None
        entry["skipped"] = "golden stage failed — nothing to compare (see stages.golden)"
        return
    ref = load_reference_frames(args.reference_frames)
    n = min(len(ref), len(golden))
    entry["compared_frames"] = int(n)
    if len(ref) != len(golden):
        entry["note"] = (f"frame count mismatch (ours {len(golden)}, reference {len(ref)}); "
                         f"compared the LAST {n} of each (both exports are tail slices of the "
                         "FIFO stream, videocrafter_main.py:230)")
    # SSIM on [0,1]; tail-aligned — both sides export the stream's tail
    a = (golden[-n:].astype(np.float32) + 1.0) / 2.0
    b = (ref[-n:].astype(np.float32) + 1.0) / 2.0
    per_frame = [float(ssim(a[i], b[i])) for i in range(n)]
    entry["ssim_per_frame_min"] = round(min(per_frame), 4)
    entry["ssim_mean"] = round(float(np.mean(per_frame)), 4)
    entry["threshold"] = args.ssim_threshold
    entry["ok"] = min(per_frame) >= args.ssim_threshold


def main(argv=None, device=None) -> int:
    """Run the stages on `device` (the GPU unless the caller names one),
    write the verdict to --out and print it; 0 iff no stage failed."""
    args = build_parser().parse_args(argv)
    report = {"stages": {}, "ckpt": os.path.abspath(args.ckpt), "config": args.config,
              "seed": args.seed}
    golden = None
    try:
        converted = stage_convert(args, report, resolve_device(device))
        tok = stage_tokenizer(args, report) if converted else None
        stage_oracles(args, report)
        if converted and tok is not None and not args.skip_golden:
            cfg, model = converted
            golden = stage_golden(args, report, cfg, model, tok)
            stage_ssim(args, report, golden)
    except Exception as e:  # a stage crash is a failed verdict, not a trace
        import traceback

        report["error"] = f"{type(e).__name__}: {e}"
        report["traceback"] = traceback.format_exc().splitlines()[-3:]
    oks = [s["ok"] for s in report["stages"].values()]
    report["ok"] = bool(oks) and all(ok is not False for ok in oks) and "error" not in report
    report["passed"] = sum(1 for ok in oks if ok is True)
    report["skipped"] = sum(1 for ok in oks if ok is None)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
