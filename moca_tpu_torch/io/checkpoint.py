"""The upstream VideoCrafter2 `model.ckpt` loaded straight into the port.

The port's modules carry the upstream key names, so the checkpoint's
tensors load into the three towers with no conversion step:

    model.diffusion_model.*     -> LatentDiffusion.unet
    first_stage_model.*         -> LatentDiffusion.vae
    cond_stage_model.model.*    -> LatentDiffusion.clip

and, for the i2v model (LatentVisualDiffusion, moca_tpu/cli/inference.py:81-99),

    embedder.model.visual.*     -> LatentVisualDiffusion.vision
    image_proj_model.*          -> LatentVisualDiffusion.image_proj

The file is a plain dict, a Lightning `state_dict` wrapper or a DeepSpeed
`module` dict whose keys carry a 16-character prefix (funcs.py:487-503);
`use_ema` overlays LitEma's shadow weights (moca_tpu/models/convert.py:395-461).
Every key of the towers must be present and loads strictly (the i2v U-Net's
to_k_ip / to_v_ip too). Keys under the known non-model prefixes below (the
schedule buffers, LitEma's shadows, OpenCLIP's visual tower and projection,
the text tower's last block when conditioning stops at the penultimate one,
the image embedder's text parts, and the image towers when the model has
none, as when the MoCA CLI runs an i2v checkpoint) are listed and skipped;
any other key is an error. A key belongs to the longest prefix it starts
with. `load_text_tower` reads the whole text tower with `text_projection`
for the CASS metric (the sweep's `convert_clip(full=True)`). The reference's
orbax cache (moca_tpu/io/checkpoint.py) has no counterpart: the torch file is
read directly.
"""

from __future__ import annotations

from typing import Dict, List

import torch

StateDict = Dict[str, torch.Tensor]

TOWERS = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
          "clip": "cond_stage_model.model."}
IMAGE_TOWERS = {"vision": "embedder.model.visual.", "image_proj": "image_proj_model."}
_SKIPPED_PREFIXES = (
    "model_ema.", "first_stage_model.loss.", "cond_stage_model.model.visual.",
    "cond_stage_model.model.text_projection", "cond_stage_model.model.logit_scale",
    "cond_stage_model.model.attn_mask", "embedder.")


def load_torch_state_dict(path: str) -> StateDict:
    """The checkpoint's flat state dict, from any of the three layouts."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    except RuntimeError:  # a legacy (non-zip) file cannot be memory-mapped
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "module" in ckpt:
        return {k[16:]: v for k, v in ckpt["module"].items()}
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return dict(ckpt["state_dict"])
    return dict(ckpt)


def extract_ema_weights(sd: StateDict, model_prefix: str = "model.",
                        ema_prefix: str = "model_ema.") -> StateDict:
    """`model.*`-keyed EMA weights from LitEma's shadow buffers, whose names
    are the live parameters' with the dots stripped (lvdm/ema.py:16-21)."""
    stripped: Dict[str, str] = {}
    for k in sd:
        if not k.startswith(model_prefix):
            continue
        dotted = k[len(model_prefix):]
        s = dotted.replace(".", "")
        if s in stripped:
            raise ValueError(f"ambiguous EMA name: {dotted!r} and {stripped[s]!r} both "
                             f"strip to {s!r}")
        stripped[s] = dotted
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith(ema_prefix):
            continue
        s = k[len(ema_prefix):]
        if s in ("decay", "num_updates"):
            continue
        if s not in stripped:
            raise KeyError(f"EMA shadow {k!r} has no matching model param")
        out[model_prefix + stripped[s]] = v
    return out


def _split(sd: StateDict, towers: Dict[str, str], skipped):
    """({tower: state dict}, skipped keys): each key goes to the longest of
    the tower and skipped prefixes it starts with (a tower on a tie); top-level
    keys (the schedule buffers) are skipped; raises on any other key."""
    prefixes = sorted([(p, name) for name, p in towers.items()] + [(p, None) for p in skipped],
                      key=lambda item: (len(item[0]), item[1] is not None), reverse=True)
    out: Dict[str, StateDict] = {name: {} for name in towers}
    skipped_keys: List[str] = []
    stray: List[str] = []
    for k, v in sd.items():
        match = next(((p, name) for p, name in prefixes if k.startswith(p)), None)
        if "." not in k or (match is not None and match[1] is None):
            skipped_keys.append(k)
        elif match is None:
            stray.append(k)
        else:
            out[match[1]][k[len(match[0]):]] = v
    if stray:
        raise ValueError(f"checkpoint keys outside the model: {sorted(stray)[:20]} "
                         f"({len(stray)} in all)")
    return out, sorted(skipped_keys)


def split_checkpoint(sd: StateDict, model, use_ema: bool = False):
    """({tower: state dict}, skipped keys) for a LatentDiffusion `model`, a
    LatentVisualDiffusion's image towers included; raises on a key that
    belongs to no tower and to no known prefix."""
    if use_ema:
        sd = {**sd, **extract_ema_weights(sd)}
    skipped = list(_SKIPPED_PREFIXES)
    if model.clip_cfg.penultimate:  # the text tower stops one block early
        skipped.append(f"{TOWERS['clip']}transformer.resblocks.{model.clip_cfg.layers - 1}.")
    towers = dict(TOWERS)
    if hasattr(model, "vision"):
        towers.update(IMAGE_TOWERS)
    else:  # an i2v checkpoint in a text-to-video model: no image towers to load
        skipped += list(IMAGE_TOWERS.values())
    return _split(sd, towers, skipped)


def load_checkpoint(path: str, model, use_ema: bool = False) -> List[str]:
    """Load `path` into the LatentDiffusion `model` in place (every tower
    strictly, cast to its parameters' type); returns the skipped keys."""
    towers, skipped = split_checkpoint(load_torch_state_dict(path), model, use_ema)
    for name, sd in towers.items():
        getattr(model, name).load_state_dict(sd, strict=True)
    return skipped


def load_text_tower(path: str, clip_cfg, device=None, dtype: torch.dtype = torch.float32):
    """The checkpoint's whole CLIP text tower with `text_projection`, strictly,
    as CLIPTextEncoder(clip_cfg, full=True) in `dtype` on `device` (the GPU
    unless the caller names one): the pooled text embedding of the CASS
    metric (scripts/eval_sweep.py `convert_clip(..., full=True)`). Every
    other part of the checkpoint is skipped."""
    from moca_tpu_torch import resolve_device
    from moca_tpu_torch.models.clip_text import CLIPTextEncoder

    sd = load_torch_state_dict(path)
    prefix = TOWERS["clip"]
    towers, _ = _split({k: v for k, v in sd.items() if k.startswith(prefix)}, {"clip": prefix},
                       [f"{prefix}visual.", f"{prefix}logit_scale", f"{prefix}attn_mask"])
    with torch.device(resolve_device(device)):
        tower = CLIPTextEncoder(clip_cfg, full=True)
    tower.to(dtype).eval().requires_grad_(False)
    tower.load_state_dict(towers["clip"], strict=True)
    return tower
