"""Debug visualization: host-side PNG dumps, off unless a sink is given.

Port of `VisualizationSink` and `latent_to_image` of
moca_tpu/utils/visualization.py: the CLI's per-frame PNGs (fifo/{i}.png,
funcs.py:362-365) and the pipeline's `viz` artifacts (the reference's inline
pred_x0/mask/cond PNGs, ddim.py:611-641, 849-899) in the same directory
layout. PIL is imported where an image is written, so the package imports
without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def latent_to_image(latent: np.ndarray) -> np.ndarray:
    """[h, w, C] latent -> uint8 RGB preview (first 3 channels, +-1 scaling)."""
    x = np.asarray(latent, np.float32)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    x = x[..., :3]
    return ((x + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


class VisualizationSink:
    """Writes latent/mask/frame previews under `root`, mirroring the
    reference's visualizations/{pred_x0,masks} layout."""

    def __init__(self, root: str = "visualizations"):
        self.root = root

    def _save(self, sub: str, name: str, img: np.ndarray):
        from PIL import Image

        d = os.path.join(self.root, sub)
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img).save(os.path.join(d, name))

    def pred_x0(self, step: int, frame_idx: int, latent: np.ndarray):
        self._save("pred_x0", f"pred_x0_step_{step}_frame_{frame_idx}.png",
                   latent_to_image(latent))

    def frame(self, index: int, frame_uint8: np.ndarray):
        self._save("fifo", f"{index}.png", frame_uint8)

    def moca_step(self, step: int, pred_x0_slots: np.ndarray, timesteps,
                  mask: Optional[np.ndarray] = None, cond: Optional[np.ndarray] = None):
        """pred_x0_slots: [k, h, w, C] pre-injection predictions of the
        low-t queue slots; timesteps: their schedule t values."""
        for j, t in enumerate(timesteps):
            self.pred_x0(int(t), j, pred_x0_slots[j])
        if mask is not None:
            m = np.asarray(mask, np.float32)
            self._save("masks", f"mask_step_{step}.png",
                       (m.reshape(m.shape[-3:-1]) * 255).clip(0, 255).astype(np.uint8))
        if cond is not None:
            # the reference writes the cond preview into the masks dir (ddim.py:894-899)
            self._save("masks", f"cond_image_step_{step}.png", latent_to_image(np.asarray(cond)))
