"""The system under test: moca_tpu_torch's models and pipelines, built from a
configuration file and given the weights that the benchmark made.

The only module of the benchmark that imports the program; the reference
(`benchmark/reference`) never does.
"""

from __future__ import annotations

import dataclasses

import torch

from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.clip_vision import CLIPVisionConfig
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion, LatentVisualDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.ops import flash_attention as fa

# the sizes LatentVisualDiffusion builds its Resampler with, beside dim =
# the vision tower's output_dim
PROGRAM_RESAMPLER = dict(depth=4, dim_head=64, heads=12, num_queries=16)


def _dataclass(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    tuples = {k: tuple(v) if isinstance(v, list) else v for k, v in values.items()}
    return cls(**tuples)


def build_model(config: dict, weights: dict) -> LatentDiffusion:
    """The program's model on the weights' device, its parameters the given
    tensors (the state dict's keys must match the program's exactly)."""
    unet = _dataclass(UNetConfig, config["unet"])
    vae = _dataclass(VAEConfig, config["vae"])
    clip = _dataclass(CLIPTextConfig, config["clip"])
    scale = config["diffusion"]["scale_factor"]
    with torch.device("meta"):
        if config["model"] == "LatentVisualDiffusion":
            want = dict(PROGRAM_RESAMPLER, dim=config["vision"]["output_dim"])
            if config["resampler"] != want:
                raise ValueError(f"the program builds its Resampler with {want}")
            model = LatentVisualDiffusion(unet, vae, clip,
                                          _dataclass(CLIPVisionConfig, config["vision"]),
                                          finegrained=config["finegrained"], scale_factor=scale)
        else:
            model = LatentDiffusion(unet, vae, clip, scale_factor=scale)
    model.load_state_dict(weights, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def tokenizer():
    return HashTokenizer()


def reset_launches() -> None:
    fa.reset_launch_counts()


def launches() -> dict:
    """{kernel wrapper: {shape key: launches}} since the last reset."""
    return {fn.__name__: dict(fn.launches) for fn in fa.KERNELS}
