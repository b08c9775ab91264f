"""DAVIS dataset loading (ref: scripts/evaluation/funcs.py:643-790).

Port of moca_tpu/io/davis.py: frames at 8x the latent resolution, binary
masks at the latent resolution, and the text-annotation prompt lookup. PIL
and cv2 are imported inside `load_davis_data`.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from moca_tpu_torch.io.video import uint8_to_tensor


def load_davis_data(video_name: str, davis_root: str,
                    video_size: Tuple[int, int] = (40, 64), video_frames: int = 16,
                    sampling_strategy: str = "first",
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [T, 8h, 8w, 3] float32 in [-1, 1], masks [T, h, w] float32
    binary) for the latent size `video_size` = (h, w).

    sampling_strategy "first", "uniform" (every total//video_frames-th
    frame) or "random" (sorted, without replacement, from a generator seeded
    with `seed` instead of the reference's global np.random, funcs.py:674)."""
    import cv2
    from PIL import Image

    frames_dir = os.path.join(davis_root, "JPEGImages", "480p", video_name)
    masks_dir = os.path.join(davis_root, "Annotations", "480p", video_name)
    frame_files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".jpg"))
    mask_files = sorted(f for f in os.listdir(masks_dir) if f.endswith(".png"))
    total = len(frame_files)

    n = min(video_frames, total)
    if sampling_strategy == "first":
        idxs: List[int] = list(range(n))
    elif sampling_strategy == "random":
        idxs = sorted(np.random.default_rng(seed).choice(total, size=n, replace=False).tolist())
    elif sampling_strategy == "uniform":
        idxs = list(range(0, total, max(1, total // video_frames)))[:video_frames]
    else:
        raise ValueError(f"unknown sampling strategy {sampling_strategy}")

    h, w = video_size
    frames, masks = [], []
    for i in idxs:
        # RGBA uint8 -> cv2 Lanczos4 (only when the size differs) -> RGB, the
        # reference's chain (funcs.py:694-702, 44-46); cv2's Lanczos4 has no
        # antialias prefilter, unlike PIL's
        img = np.asarray(Image.open(os.path.join(frames_dir, frame_files[i])).convert("RGBA"),
                         np.uint8)
        if img.shape[:2] != (h * 8, w * 8):
            img = cv2.resize(img, (w * 8, h * 8), interpolation=cv2.INTER_LANCZOS4)
        frames.append(img[..., :3])
        # masks on PIL NEAREST, as the reference (funcs.py:711-722)
        m = Image.open(os.path.join(masks_dir, mask_files[i])).convert("L")
        if m.size != (w, h):
            m = m.resize((w, h), Image.NEAREST)
        masks.append((np.asarray(m) > 0).astype(np.float32))
    return uint8_to_tensor(np.stack(frames)), np.stack(masks)


def get_davis_prompt(video_name: str,
                     annotations_file: str = "DAVIS/davis_text_annotations/Davis16_annot1.txt"
                     ) -> str:
    """'object <description>' from the annotations file (funcs.py:763-790),
    'object <video_name>' when the file or the line is missing."""
    try:
        with open(annotations_file) as f:
            for line in f:
                parts = line.strip().split(" ", 2)
                if len(parts) >= 3 and parts[0] == video_name:
                    return f"object {parts[2].strip(chr(34))}"
    except OSError:
        pass
    return f"object {video_name}"
