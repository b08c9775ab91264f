"""Host-side video and image IO (numpy arrays, CPU only).

Port of moca_tpu/io/video.py: uint8 <-> [-1, 1] float conversions
(funcs.py:565, 630-640), clip packing, mp4/gif writing, the n_samples grid
video (funcs.py:600-612), the concept image at latent resolution
(videocrafter_main.py:90-98), conditioning-image batches (funcs.py:576-597)
and mp4 frame loading (funcs.py:538-574). uint8 -> float goes through the host
library of native/ (io/fastio.py, built at first use) where it is
available, else numpy. Unlike the reference, float -> uint8 and the clip
packing stay on numpy: on the H100's host the library was no faster there
(chip_smoke.py phase 6 times all three; PERF.md). PIL, cv2
and imageio are imported inside the functions that use them, so the package
imports without them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from moca_tpu_torch.io import fastio


def tensor_to_uint8(frame: np.ndarray) -> np.ndarray:
    """[-1, 1] float [H, W, 3] -> uint8 (funcs.py:630-640 tensor2image)."""
    x = np.clip(np.asarray(frame, np.float32), -1.0, 1.0)
    return ((x + 1.0) * 127.5).astype(np.uint8)


def uint8_to_tensor(img: np.ndarray) -> np.ndarray:
    """uint8 -> [-1, 1] float32 (funcs.py:565)."""
    if fastio.available():
        return fastio.uint8_to_float(img)
    return (np.asarray(img).astype(np.float32) / 255.0 - 0.5) * 2.0


def stack_frames(frames: Sequence[np.ndarray]) -> np.ndarray:
    """Equally shaped frames -> one contiguous [T, ...] clip buffer."""
    return np.stack(frames)


def save_video(frames: Sequence[np.ndarray], path: str, fps: int = 10):
    """[-1, 1] float or uint8 [H, W, 3] frames -> mp4 (cv2.VideoWriter) or
    gif (imageio), by the path's extension."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = stack_frames([f if f.dtype == np.uint8 else tensor_to_uint8(f) for f in frames])
    if path.endswith(".gif"):
        import imageio

        imageio.mimsave(path, list(imgs), duration=int(1000 / fps))
        return
    import cv2

    h, w = imgs[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    for img in imgs:
        writer.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    writer.release()


def save_gif(frames: Sequence[np.ndarray], path: str, fps: int = 10):
    save_video(frames, path if path.endswith(".gif") else path + ".gif", fps)


def save_video_grid(sample_videos: Sequence[Sequence[np.ndarray]], path: str, fps: int = 10,
                    padding: int = 2):
    """One video of n samples side by side, the reference's save_videos
    layout (funcs.py:600-612: torchvision's make_grid(nrow=n_samples) per
    frame, padding 2, pad value 0 in [-1, 1], i.e. a 127-gray border, also
    around a single sample). sample_videos: n sequences of [H, W, 3] float
    frames in [-1, 1]."""
    n, t_len = len(sample_videos), len(sample_videos[0])
    h, w, c = np.asarray(sample_videos[0][0]).shape
    frames = []
    for t in range(t_len):
        grid = np.zeros((h + 2 * padding, n * (w + padding) + padding, c), np.float32)
        for i in range(n):
            x0 = padding + i * (w + padding)
            grid[padding:padding + h, x0:x0 + w] = np.clip(
                np.asarray(sample_videos[i][t], np.float32), -1.0, 1.0)
        frames.append(grid)
    save_video(frames, path, fps=fps)


def load_conditioning_image(path: str, latent_hw: Tuple[int, int]) -> np.ndarray:
    """Concept image at latent resolution, [h, w, 4] RGBA in [0, 1]:
    torchvision's Resize((h, w)) on a PIL image is PIL's bilinear resize to
    exactly (h, w), and ToTensor keeps the 0..1 range (videocrafter_main.py:90-98)."""
    from PIL import Image

    h, w = latent_hw
    img = Image.open(path).convert("RGBA").resize((w, h), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def load_image_batch(paths: Sequence[str],
                     image_size: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """Images, or the first frames of mp4s, -> [B, H, W, C] float32 in
    [-1, 1] (funcs.py:576-597): png/jpg keep RGBA like the reference's
    convert, resized by cv2's bilinear on the float 0..255 values and
    normalised after (funcs.py:587-595)."""
    import cv2
    from PIL import Image

    batch: List[np.ndarray] = []
    for path in paths:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".mp4":
            batch.append(load_video_frames(path, size=image_size, num_frames=1)[0])
            continue
        if ext not in (".png", ".jpg", ".jpeg"):
            raise NotImplementedError(f"image loading supports mp4/png/jpg, got {ext}")
        rgba = np.asarray(Image.open(path).convert("RGBA"), np.float32)
        rgba = cv2.resize(rgba, (image_size[1], image_size[0]), interpolation=cv2.INTER_LINEAR)
        batch.append((rgba / 255.0 - 0.5) * 2.0)
    return np.stack(batch)


def load_video_frames(path: str, size: Optional[Tuple[int, int]] = None,
                      num_frames: int = -1, stride: int = 1) -> np.ndarray:
    """mp4 -> [T, H, W, 3] float32 in [-1, 1] (funcs.py:538-574), padded by
    repeating the last frame when the clip is short."""
    import cv2
    from PIL import Image

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise OSError(f"could not open video {path}")
    frames: List[np.ndarray] = []
    i = -1
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        i += 1
        if i % stride:
            continue
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if size is not None:
            frame = np.asarray(Image.fromarray(frame).resize((size[1], size[0]), Image.BILINEAR))
        frames.append(frame)
        if 0 < num_frames <= len(frames):
            break
    cap.release()
    if 0 < num_frames and len(frames) < num_frames:
        frames += [frames[-1]] * (num_frames - len(frames))
    return uint8_to_tensor(np.stack(frames))
