"""Config system: the reference's YAML surface, read into the port's configs.

Port of moca_tpu/config.py. The reference builds its model from OmegaConf
YAML `target:` paths (utils/utils.py:27-42; configs/inference_t2v_512_v2.0.yaml).
The same files drive the port: the known targets resolve to the port's
`UNetConfig`, `VAEConfig`, `CLIPTextConfig` and `DiffusionParams`, with the
reference's defaults for absent keys, and a vestigial or unknown encoder
target is refused here. The parameter type is the caller's choice (the CLI's
`--precision`), not the YAML's. An i2v config (`is_i2v`) also names the
image projector: the Resampler when `model.params.finegrained` is set, else
ImageProjModel. PyYAML is imported inside `load_model_config`.

DynamiCrafter's configs (its configs/inference_1024_v1.0.yaml) read into the
same configs: `image_cross_attention` and `fs_condition` are its spellings
of `use_image_attention` and `fps_cond`, `img_cond_stage_config` and
`image_proj_stage_config` its image tower and Resampler (with `video_length`,
per-frame image tokens), and the keys of its schedule and sampler that the
JAX package's DiffusionParams lacks go into `SamplingParams`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig

# The reference DiffusionWrapper's conditioning modes (ddpm3d.py:702-762).
CONDITIONING_KEYS = (
    None, "concat", "crossattn", "hybrid", "resblockcond", "adm", "hybrid-adm",
    "hybrid-time", "concat-time-mask", "concat-adm-mask", "hybrid-adm-mask",
    "hybrid-time-adm")


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """LatentDiffusion-level knobs (yaml model.params, ddpm3d.py:329-405)."""

    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    beta_schedule: str = "linear"
    scale_factor: float = 0.18215
    use_scale: bool = True
    scale_b: float = 0.7
    uncond_type: str = "empty_seq"
    conditioning_key: str = "crossattn"
    image_size: Tuple[int, int] = (40, 64)
    channels: int = 4

    def __post_init__(self):
        if self.conditioning_key not in CONDITIONING_KEYS:
            raise NotImplementedError(
                f"conditioning_key '{self.conditioning_key}' is not a reference "
                f"DiffusionWrapper mode (ddpm3d.py:702-762); known keys: {CONDITIONING_KEYS}")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """DynamiCrafter's keys of model.params (lvdm/models/ddpm3d.py): a
    zero-terminal-SNR schedule, v-prediction and the dynamic rescale of x0
    (the `use_scale` ramp to `base_scale`). The defaults are VideoCrafter's.
    (unet_config's `default_fs` is the U-Net's frame stride when it is given
    none; the port's pipelines always give one, `--frame_stride`.)"""

    rescale_betas_zero_snr: bool = False
    parameterization: str = "eps"
    use_dynamic_rescale: bool = False
    base_scale: float = 0.7

    def schedule_kwargs(self) -> Dict[str, Any]:
        """The keywords of `schedule.make_schedule` that these set, none at
        the defaults."""
        out: Dict[str, Any] = {}
        if self.rescale_betas_zero_snr:
            out["rescale_betas_zero_snr"] = True
        if self.parameterization != "eps":
            out["parameterization"] = self.parameterization
        if self.use_dynamic_rescale:
            out.update(dynamic_rescale=True, scale_b=self.base_scale)
        return out


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    diffusion: DiffusionParams
    unet: UNetConfig
    vae: VAEConfig
    clip: CLIPTextConfig
    # i2v (LatentVisualDiffusion, ddpm3d.py:660-694): the YAML target says
    # LatentVisualDiffusion or has a cond_img_config
    is_i2v: bool = False
    # i2v projector: the Resampler on the vision tower's tokens (True) or
    # ImageProjModel on its pooled embedding
    finegrained: bool = False
    # the Resampler's queries for each of this many frames (DynamiCrafter)
    image_video_length: int | None = None
    sampling: SamplingParams = SamplingParams()


def _unet_from_yaml(p: Dict[str, Any]) -> UNetConfig:
    return UNetConfig(
        in_channels=p.get("in_channels", 4),
        out_channels=p.get("out_channels", 4),
        model_channels=p.get("model_channels", 320),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_head_channels=p.get("num_head_channels", 64),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim", 1024),
        use_linear=p.get("use_linear", True),
        temporal_conv=p.get("temporal_conv", True),
        tempspatial_aware=p.get("tempspatial_aware", False),
        temporal_attention=p.get("temporal_attention", True),
        temporal_selfatt_only=p.get("temporal_selfatt_only", True),
        use_relative_position=p.get("use_relative_position", False),
        use_causal_attention=p.get("use_causal_attention", False),
        temporal_length=p.get("temporal_length", 16),
        addition_attention=p.get("addition_attention", False),
        use_image_attention=p.get("use_image_attention", p.get("image_cross_attention", False)),
        fps_cond=p.get("fps_cond", p.get("fs_condition", False)),
    )


def _vae_from_yaml(p: Dict[str, Any]) -> VAEConfig:
    dd = p.get("ddconfig", {})
    return VAEConfig(
        double_z=dd.get("double_z", True),
        z_channels=dd.get("z_channels", 4),
        resolution=dd.get("resolution", 512),
        in_channels=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        embed_dim=p.get("embed_dim", 4),
    )


def _clip_from_yaml(p: Dict[str, Any]) -> CLIPTextConfig:
    """Reference YAMLs carry only `layer` (FrozenOpenCLIPEmbedder,
    condition.py:184); the size keys let shrunk test configs drive the
    checkpoint path and are absent from the reference's files (ViT-H)."""
    return CLIPTextConfig(
        penultimate=p.get("layer", "last") == "penultimate",
        width=p.get("width", 1024), heads=p.get("heads", 16), layers=p.get("layers", 24),
        vocab_size=p.get("vocab_size", 49408), context_length=p.get("context_length", 77))


# Encoder classes the reference ships but no shipped config builds
# (condition.py:57, 89, 136, 377): a YAML naming one fails here instead of
# silently getting the OpenCLIP tower.
_VESTIGIAL_ENCODERS = frozenset({
    "FrozenT5Embedder", "FrozenCLIPEmbedder", "ClipImageEmbedder", "FrozenCLIPT5Encoder"})
# The reference's encoders with a counterpart in the JAX package (the text
# tower, the image towers and the resampler of its i2v path).
_IMPLEMENTED_ENCODERS = frozenset({
    "FrozenOpenCLIPEmbedder", "FrozenOpenCLIPImageEmbedder",
    "FrozenOpenCLIPImageEmbedderV2", "Resampler"})


def _check_encoder_target(target: str, where: str) -> None:
    if not target:
        return  # shrunk test configs leave targets out
    name = target.rsplit(".", 1)[-1]
    if name in _IMPLEMENTED_ENCODERS:
        return
    if name in _VESTIGIAL_ENCODERS:
        raise NotImplementedError(
            f"{where} targets {name}: a vestigial encoder class the reference ships "
            "(lvdm/modules/encoders/condition.py) but no shipped config uses; only the "
            "OpenCLIP text and image towers are implemented")
    raise ValueError(f"unknown {where} target: {target!r}")


def load_model_config(path: str) -> ModelConfig:
    """Parse a reference-format YAML (e.g. configs/inference_t2v_512_v2.0.yaml)."""
    import yaml

    with open(path) as f:
        return model_config_from_dict(yaml.safe_load(f))


def model_config_from_dict(raw: Dict[str, Any]) -> ModelConfig:
    mp = raw["model"]["params"]
    diffusion = DiffusionParams(
        timesteps=mp.get("timesteps", 1000),
        linear_start=mp.get("linear_start", 0.00085),
        linear_end=mp.get("linear_end", 0.012),
        beta_schedule=mp.get("beta_schedule", "linear"),
        scale_factor=mp.get("scale_factor", 0.18215),
        use_scale=mp.get("use_scale", False),
        scale_b=mp.get("scale_b", 0.3),
        uncond_type=mp.get("uncond_type", "empty_seq"),
        conditioning_key=mp.get("conditioning_key", "crossattn"),
        image_size=tuple(mp.get("image_size", (40, 64))),
        channels=mp.get("channels", 4),
    )
    unet = _unet_from_yaml(mp["unet_config"]["params"])
    vae = _vae_from_yaml(mp["first_stage_config"]["params"])
    _check_encoder_target(mp["cond_stage_config"].get("target", ""), "cond_stage_config")
    for key in ("cond_img_config", "img_cond_stage_config", "image_proj_stage_config"):
        if key in mp:
            _check_encoder_target(mp[key].get("target", ""), key)
    clip = _clip_from_yaml(mp["cond_stage_config"].get("params", {}))
    is_i2v = ("LatentVisualDiffusion" in raw["model"].get("target", "")
              or "cond_img_config" in mp or "img_cond_stage_config" in mp)
    proj = mp.get("image_proj_stage_config", {})
    finegrained = mp.get("finegrained", proj.get("target", "").endswith("Resampler"))
    sampling = SamplingParams(
        rescale_betas_zero_snr=mp.get("rescale_betas_zero_snr", False),
        parameterization=mp.get("parameterization", "eps"),
        use_dynamic_rescale=mp.get("use_dynamic_rescale", False),
        base_scale=mp.get("base_scale", 0.7))
    return ModelConfig(diffusion=diffusion, unet=unet, vae=vae, clip=clip, is_i2v=is_i2v,
                       finegrained=finegrained,
                       image_video_length=proj.get("params", {}).get("video_length"),
                       sampling=sampling)
