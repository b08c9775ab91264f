"""Batch gif -> mp4 conversion on the port (the reference's convert_gifs.py).

Port of scripts/convert_gifs.py: the same positional root and --fps flag,
the same output names (each .gif beside it as .mp4) and printed lines. Gifs
are read by the port's `load_gif_frames` (PIL; the JAX script reads them
with imageio, which gives the same pixels) and written by its `save_video`
(io/video.py); no device work:

    python -m moca_tpu_torch.cli.convert_gifs results/ --fps 10
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List

from moca_tpu_torch.io.video import load_gif_frames, save_video


def convert(gif_path: str, fps: int = 10) -> str:
    """One gif -> the mp4 beside it (RGB, alpha dropped); returns its path."""
    out = os.path.splitext(gif_path)[0] + ".mp4"
    save_video(load_gif_frames(gif_path), out, fps=fps)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("root", help="directory tree to scan for .gif")
    p.add_argument("--fps", type=int, default=10)
    return p


def main(argv=None) -> List[str]:
    """Convert every .gif under root; returns the mp4 paths."""
    args = build_parser().parse_args(argv)
    outs = []
    for gif in glob.glob(os.path.join(args.root, "**", "*.gif"), recursive=True):
        outs.append(convert(gif, args.fps))
        print(outs[-1])
    return outs


if __name__ == "__main__":
    main()
