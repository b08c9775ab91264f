"""Generate the missing conditioning images of a prompt CSV on the port.

Port of scripts/generate_condition_images.py (the reference's
scripts/prep/generate_condition_images.py shells out to Stable Diffusion
2.1): the same flags, defaults and printed lines. For each CSV row whose
`conditioned_image_path` names a missing file, one frame is sampled from
the VideoCrafter2 stack itself (T2VPipeline with frames=1) for the row's
conditioned prompt (or its conditioned object) and saved there as RGBA:

    python -m moca_tpu_torch.cli.generate_condition_images --ckpt_path model.ckpt \
        --prompts_file prompts/prompts.csv --bpe_path bpe_simple_vocab_16e6.txt.gz

The model is loaded by `cli.main.load_model` (the torch checkpoint read
directly, io/checkpoint.py) in --precision, on the GPU unless the caller of
`main` names another device. Noise: the i-th missing row draws from
`cli.inference.sample_normal(seed, i, 0, 1)`, a generator seeded from
(seed, i), as the JAX script folds i into its key; the numbers are not
JAX's.
"""

from __future__ import annotations

import argparse
import os
from typing import List

from moca_tpu_torch.cli.inference import sample_normal
from moca_tpu_torch.cli.main import PRECISIONS, load_model, precision_name
from moca_tpu_torch.io.prompts import load_prompts
from moca_tpu_torch.io.video import tensor_to_uint8
from moca_tpu_torch.models.tokenizer import load_tokenizer
from moca_tpu_torch.pipelines.t2v import T2VPipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate missing conditioned images (GPU)")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--config", type=str, default="configs/inference_t2v_512_v2.0.yaml")
    p.add_argument("--prompts_file", type=str, default="prompts/prompts.csv")
    p.add_argument("--assets_dir", type=str, default="assets")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--precision", type=precision_name, default="bf16",
                   choices=sorted(PRECISIONS), help="bf16 (bfloat16) or fp32 (float32)")
    return p


def load_pipeline(args, device=None) -> T2VPipeline:
    """The model of --config and --ckpt_path on `device` (the GPU unless the
    caller names one) behind a T2VPipeline with --num_steps and
    --guidance_scale, as the JAX script builds it."""
    model, cfg = load_model(args, device)
    return T2VPipeline.build(model, load_tokenizer(args.bpe_path), num_steps=args.num_steps,
                             use_scale=cfg.diffusion.use_scale,
                             guidance_scale=args.guidance_scale)


def main(argv=None, pipe=None, device=None) -> List[str]:
    """Write each missing conditioning image; returns their paths. `pipe`:
    a T2VPipeline to use in place of `load_pipeline(args, device)`."""
    from PIL import Image

    args = build_parser().parse_args(argv)
    rows = load_prompts(args.prompts_file)
    missing = [r for r in rows
               if r["conditioned_image_path"] and not os.path.exists(r["conditioned_image_path"])]
    if not missing:
        print("all conditioned images present")
        return []
    pipe = load_pipeline(args, device) if pipe is None else pipe
    os.makedirs(args.assets_dir, exist_ok=True)
    written = []
    for i, row in enumerate(missing):
        prompt = row["conditioned_prompt"].rstrip(".") or row["conditioned_object"]
        frame = pipe(prompt, normal=sample_normal(args.seed, i, 0, 1, pipe.model.device),
                     height=args.height, width=args.width, frames=1)
        img = tensor_to_uint8(frame[0].float().cpu().numpy())
        out = row["conditioned_image_path"]
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        Image.fromarray(img).convert("RGBA").save(out)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
