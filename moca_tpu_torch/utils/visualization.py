"""Debug visualization: host-side PNG dumps, off unless a sink is given.

Port of moca_tpu/utils/visualization.py: `VisualizationSink` and
`latent_to_image`, the CLI's per-frame PNGs (fifo/{i}.png, funcs.py:362-365)
and the pipeline's `viz` artifacts (the reference's inline pred_x0/mask/cond
PNGs, ddim.py:611-641, 849-899) in the same directory layout; and the plot
helpers of the reference's VisualizationHelper
(lvdm/models/samplers/visualization.py:10-155) on channels-last numpy arrays
([h, w, C] frames, [T, h, w, C] clips, [h, w] masks), raw dumps as .npy. PIL
and matplotlib are imported where an image is written, so the package
imports without them.
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


def _normalize01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _rgb3(x: np.ndarray) -> np.ndarray:
    """[h, w, C] -> [h, w, 3]: repeat one channel, else keep the first three
    or pad with zeros (visualization.py:622-632 in channels-last)."""
    if x.ndim == 2:
        x = x[..., None]
    c = x.shape[-1]
    if c == 1:
        return np.repeat(x, 3, axis=-1)
    if c >= 3:
        return x[..., :3]
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, 3 - c)])


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_mask_and_latent(mask: np.ndarray, latent: np.ndarray, timestep: int,
                              frame_idx: int, save_dir: str):
    """Mask heatmap beside the latent preview (visualization.py:12-45):
    timestep_{t:04d}/frame_{f:03d}.png and the raw mask_{f:03d}.npy and
    latent_{f:03d}.npy."""
    plt = _pyplot()
    step_dir = os.path.join(save_dir, f"timestep_{int(timestep):04d}")
    os.makedirs(step_dir, exist_ok=True)
    mask2d = np.asarray(mask, np.float32)
    mask2d = mask2d.reshape(mask2d.shape[-2:] if mask2d.ndim == 2 else mask2d.shape[-3:-1])
    latent_vis = _normalize01(_rgb3(np.asarray(latent, np.float32)))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 6))
    im = ax1.imshow(mask2d, cmap="hot")
    ax1.set_title(f"Mask (Frame {frame_idx})")
    fig.colorbar(im, ax=ax1)
    ax2.imshow(latent_vis)
    ax2.set_title(f"Latent (Frame {frame_idx})")
    fig.tight_layout()
    fig.savefig(os.path.join(step_dir, f"frame_{frame_idx:03d}.png"))
    plt.close(fig)
    np.save(os.path.join(step_dir, f"mask_{frame_idx:03d}.npy"), np.asarray(mask))
    np.save(os.path.join(step_dir, f"latent_{frame_idx:03d}.npy"), np.asarray(latent))


def visualize_sampling(pred_x0: np.ndarray, noise: np.ndarray, save_dir: str, step: int,
                       is_manipulated: bool = False):
    """The first frame of pred_x0 beside its noise, each min-max normalized
    (visualization.py:47-74): step_{s:03d}_{before|after}_manipulation/
    frame_000.png."""
    from PIL import Image

    status = "after_manipulation" if is_manipulated else "before_manipulation"
    step_dir = os.path.join(save_dir, f"step_{step:03d}_{status}")
    os.makedirs(step_dir, exist_ok=True)

    def tile(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 4:  # [T, h, w, C] -> the first frame
            x = x[0]
        return (_normalize01(_rgb3(x)) * 255).astype(np.uint8)

    grid = np.concatenate([tile(pred_x0), tile(noise)], axis=1)  # nrow=2
    Image.fromarray(grid).save(os.path.join(step_dir, "frame_000.png"))


def visualize_masks(masks, save_dir: str, step: int):
    """One PNG a mask (visualization.py:121-137): step_{s:03d}_masks/mask_{i:03d}.png."""
    from PIL import Image

    masks_dir = os.path.join(save_dir, f"step_{step:03d}_masks")
    os.makedirs(masks_dir, exist_ok=True)
    for i, m in enumerate(np.asarray(masks, np.float32)):
        img = (m.reshape(m.shape[:2]) * 255).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(masks_dir, f"mask_{i:03d}.png"))


def visualize_latents(latents: np.ndarray, save_dir: str):
    """One preview a frame (visualization.py:139-155): latents/frame_{i:03d}.png,
    min-max normalized once (the reference's second (x+1)/2, :146,153, is
    left out as in the JAX package; DECISIONS.md)."""
    from PIL import Image

    latents_dir = os.path.join(save_dir, "latents")
    os.makedirs(latents_dir, exist_ok=True)
    x = _normalize01(np.asarray(latents, np.float32))
    for i, frame in enumerate(x):
        img = (_rgb3(frame) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(latents_dir, f"frame_{i:03d}.png"))


def visualize_object_attention(pred_image: np.ndarray, cond_image: np.ndarray,
                               attention_mask: np.ndarray, attention_map: np.ndarray,
                               labeled_regions, target_object, save_dir: str, step: int):
    """The 2 x 3 attention panel (visualization.py:76-119):
    step_{s:03d}_object_attention/object_attention_{target}.png."""
    plt = _pyplot()
    step_dir = os.path.join(save_dir, f"step_{step:03d}_object_attention")
    os.makedirs(step_dir, exist_ok=True)
    pred = _rgb3(np.asarray(pred_image, np.float32))
    cond = _rgb3(np.asarray(cond_image, np.float32))
    amask = np.asarray(attention_mask, np.float32)
    amap = np.asarray(attention_map, np.float32)

    fig, axes = plt.subplots(2, 3, figsize=(18, 12))
    axes[0, 0].imshow(_normalize01(pred))
    axes[0, 0].set_title("Generated Image")
    axes[0, 1].imshow(_normalize01(cond))
    axes[0, 1].set_title("Conditioning Image")
    im = axes[0, 2].imshow(amap, cmap="hot")
    axes[0, 2].set_title("Raw Attention Map")
    fig.colorbar(im, ax=axes[0, 2])
    if labeled_regions is not None:
        axes[1, 0].imshow(np.asarray(labeled_regions), cmap="nipy_spectral")
        axes[1, 0].set_title("Connected Components")
    axes[1, 1].imshow(amask, cmap="hot")
    axes[1, 1].set_title(f"Mask for {target_object}" if target_object else "Overall Mask")
    masked = pred.copy()
    masked[amask > 0.5] = cond[amask > 0.5]
    axes[1, 2].imshow(_normalize01(masked))
    axes[1, 2].set_title("Masked Result")
    fig.savefig(os.path.join(step_dir, f"object_attention_{target_object}.png"))
    plt.close(fig)
