"""Video -> frame images on the port (the reference's utils/v2i.py).

Port of scripts/v2i.py: the same flags, defaults, frame_{N:06d}.{format}
file names and printed line, over the port's host IO (io/video.py
`load_video_frames(stride=)` and `tensor_to_uint8`); no device work:

    python -m moca_tpu_torch.cli.v2i --video_path clip.mp4 --output_dir frames \
        --frame_rate 2 --image_format png
"""

from __future__ import annotations

import argparse
import os
from typing import List

from moca_tpu_torch.io.video import load_video_frames, tensor_to_uint8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert video to images")
    p.add_argument("--video_path", required=True, help="Path to the input video file")
    p.add_argument("--output_dir", default="output_frames",
                   help="Directory to save extracted frames")
    p.add_argument("--frame_rate", type=int, default=1,
                   help="Extract one frame every N frames (default: 1)")
    p.add_argument("--image_format", default="jpg", help="Output image format (default: jpg)")
    return p


def main(argv=None) -> List[str]:
    """Write every --frame_rate-th frame of --video_path; returns the paths."""
    from PIL import Image

    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    frames = load_video_frames(args.video_path, stride=args.frame_rate)
    paths = []
    for i, f in enumerate(frames):
        paths.append(os.path.join(args.output_dir, f"frame_{i:06d}.{args.image_format}"))
        Image.fromarray(tensor_to_uint8(f)).save(paths[-1])
    print(f"Saved {len(frames)} frames to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
