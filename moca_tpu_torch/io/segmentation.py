"""Host-side segmentation-mask providers for open-vocabulary injection.

Port of moca_tpu/io/segmentation.py. The reference runs Grounding-DINO +
SAM2 inside its denoise loop (ddim.py:739-903); here a provider is called on
the host with each low-t queue slot's pre-injection pred_x0, and the FIFO
step consumes a queue-aligned mask tensor.

  * PrecomputedMaskProvider: masks from an array, the last one repeated.
  * CallbackMaskProvider: wraps `fn(frame_uint8, target_text) -> mask or
    None` and applies the reference's temporal-consistency gates: the
    previous mask on an empty detection (ddim.py:788-793) or when
    IoU(new, previous) < 0.5 (ddim.py:803-807), and no injection from a
    mask covering more than 80 % of the frame (ddim.py:819-821).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def latent_to_uint8_frame(latent_hwc: np.ndarray) -> np.ndarray:
    """The reference's latent -> uint8 image fed to the detector
    (ddim.py:744-763): the first 3 channels of the [h, w, C] latent, scaled
    by 255 only when the max is <= 1, otherwise cast directly."""
    frame = np.asarray(latent_hwc, np.float32)
    if frame.shape[-1] != 3:
        frame = np.repeat(frame, 3, axis=-1) if frame.shape[-1] == 1 else frame[:, :, :3]
    if np.floor(frame.max()) <= 1.0:
        return (frame * 255).astype(np.uint8)
    return frame.astype(np.uint8)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of binary masks (ddim.py:905-943); two empty masks -> 1."""
    a, b = a > 0.5, b > 0.5
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return float(inter) / float(union)


class PrecomputedMaskProvider:
    """Serve masks from a [T, h, w] array, repeating the last one."""

    def __init__(self, masks: np.ndarray):
        self.masks = np.asarray(masks, np.float32)

    def __call__(self, frame_index: int, frame=None, target=None) -> np.ndarray:
        return self.masks[min(frame_index, self.masks.shape[0] - 1)]


class CallbackMaskProvider:
    """Open-vocab provider with the reference's temporal-consistency gates."""

    def __init__(self, segment_fn: Callable[[np.ndarray, str], Optional[np.ndarray]],
                 iou_threshold: float = 0.5, coverage_max: float = 0.8):
        self.segment_fn = segment_fn
        self.iou_threshold = iou_threshold
        self.coverage_max = coverage_max
        self.prev_mask: Optional[np.ndarray] = None

    def __call__(self, frame_index: int, frame: np.ndarray,
                 target: str) -> Optional[np.ndarray]:
        if not target.endswith("."):
            target = target + "."  # ddim.py:741-742
        mask = self.segment_fn(frame, target)
        if mask is None:
            mask = self.prev_mask
        elif self.prev_mask is not None and mask_iou(mask, self.prev_mask) < self.iou_threshold:
            mask = self.prev_mask
        # the coverage gate skips the injection only: an oversized mask still
        # becomes the previous mask of the next frame (ddim.py:606, 819-821)
        self.prev_mask = mask
        if mask is not None and mask.mean() > self.coverage_max:
            return None
        return mask
