"""Weights carried across from the JAX package's parameter trees.

Each function here is the inverse of the matching one in
moca_tpu/models/convert.py: it takes a JAX param tree (nested dicts of numpy
arrays, with or without the outer "params" key) and returns the port's
`state_dict` (torch tensors keyed by the upstream checkpoint names the port's
modules carry). Layout transforms, inverted:

    Dense   kernel [in, out]           -> Linear weight [out, in]
    Conv2d  kernel [kh, kw, I, O]      -> weight [O, I, kh, kw]
    Conv3d  kernel [kt, kh, kw, I, O]  -> weight [O, I, kt, kh, kw]
    GroupNorm_0 / LayerNorm_0 {scale, bias} -> {weight, bias}

The U-Net walk uses the port's own copy of `unet_plan`, the same walk the
reference converter and model use. `clip_vision_from_jax` and
`image_proj_from_jax` invert `convert_clip_vision` and `convert_image_proj`
(the i2v model's vision tower and projector).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.unet3d import UNetConfig, unet_plan
from moca_tpu_torch.models.vae import VAEConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _put(sd: StateDict, prefix: str, **tensors):
    for name, value in tensors.items():
        sd[f"{prefix}.{name}"] = _t(value)


def _linear(sd, prefix, p):
    _put(sd, prefix, weight=np.asarray(p["kernel"]).T)
    if "bias" in p:
        _put(sd, prefix, bias=p["bias"])


def _conv2d(sd, prefix, p):
    _put(sd, prefix, weight=np.asarray(p["kernel"]).transpose(3, 2, 0, 1), bias=p["bias"])


def _conv3d(sd, prefix, p):
    _put(sd, prefix, weight=np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2), bias=p["bias"])


def _norm(sd, prefix, p):
    inner = p.get("GroupNorm_0", p.get("LayerNorm_0", p))
    _put(sd, prefix, weight=inner["scale"], bias=inner["bias"])


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def _res_block(sd, prefix, p):
    _norm(sd, f"{prefix}.in_layers.0", p["in_norm"])
    _conv2d(sd, f"{prefix}.in_layers.2", p["in_conv"])
    _linear(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _norm(sd, f"{prefix}.out_layers.0", p["out_norm"])
    _conv2d(sd, f"{prefix}.out_layers.3", p["out_conv"])
    if "skip" in p:
        _conv2d(sd, f"{prefix}.skip_connection", p["skip"])
    if "temporal" in p:
        tc = p["temporal"]
        for i in range(1, 5):
            _norm(sd, f"{prefix}.temopral_conv.conv{i}.0", tc[f"conv{i}_norm"])
            _conv3d(sd, f"{prefix}.temopral_conv.conv{i}.{2 if i == 1 else 3}",
                    tc[f"conv{i}_conv"])


def _attn(sd, prefix, p):
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])
    for name in ("relative_position_k", "relative_position_v"):  # convert.py:113-117
        if name in p:
            _put(sd, f"{prefix}.{name}", embeddings_table=p[name]["embeddings_table"])
    for name in ("to_k_ip", "to_v_ip"):  # image cross-attention, convert.py:118-120
        if name in p:
            _linear(sd, f"{prefix}.{name}", p[name])


def _transformer(sd, prefix, p, depth, conv_proj=False):
    _norm(sd, f"{prefix}.norm", p["norm"])
    for name in ("proj_in", "proj_out"):
        _linear(sd, f"{prefix}.{name}", p[name])
        if conv_proj:  # kernel-1 Conv1d weight [out, in, 1]
            sd[f"{prefix}.{name}.weight"] = sd[f"{prefix}.{name}.weight"][..., None]
    for d in range(depth):
        blk, q = f"{prefix}.transformer_blocks.{d}", p[f"block{d}"]
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{blk}.{n}", q[n])
        _attn(sd, f"{blk}.attn1", q["attn1"])
        _attn(sd, f"{blk}.attn2", q["attn2"])
        _linear(sd, f"{blk}.ff.net.0.proj", q["ff"]["geglu"]["proj"])
        _linear(sd, f"{blk}.ff.net.2", q["ff"]["out"])


def unet_from_jax(params, cfg: UNetConfig) -> StateDict:
    """JAX UNet3D params -> the port's UNet3D state_dict."""
    p = _params(params)
    sd: StateDict = {}
    _linear(sd, "time_embed.0", p["time_embed_0"])
    _linear(sd, "time_embed.2", p["time_embed_2"])
    if cfg.fps_cond:
        _linear(sd, "fps_embedding.0", p["fps_embed_0"])
        _linear(sd, "fps_embedding.2", p["fps_embed_2"])

    def layer(spec, jax_name, prefix):
        kind, q = spec["kind"], p[jax_name]
        if kind == "conv_in":
            _conv2d(sd, prefix, q)
        elif kind == "res":
            _res_block(sd, prefix, q)
        elif kind == "spatial":
            _transformer(sd, prefix, q, cfg.transformer_depth)
        elif kind == "temporal":
            _transformer(sd, prefix, q, cfg.temporal_transformer_depth)
        elif kind == "down":
            _conv2d(sd, f"{prefix}.op", q["conv"])
        elif kind == "up":
            _conv2d(sd, f"{prefix}.conv", q["conv"])
        else:
            raise ValueError(kind)

    suffix = {"conv_in": "conv", "res": "res", "spatial": "spatial",
              "temporal": "temporal", "down": "down", "up": "up"}
    in_plan, mid_plan, out_plan = unet_plan(cfg)
    for i, block in enumerate(in_plan):
        for j, spec in enumerate(block):
            layer(spec, f"in{i}_{j}_{suffix[spec['kind']]}", f"input_blocks.{i}.{j}")
    if cfg.addition_attention:
        _transformer(sd, "init_attn.0", p["init_temporal"],
                     cfg.temporal_transformer_depth, conv_proj=True)
    for j, spec in enumerate(mid_plan):
        layer(spec, f"mid_{j}_{suffix[spec['kind']]}", f"middle_block.{j}")
    for i, block in enumerate(out_plan):
        for j, spec in enumerate(block):
            layer(spec, f"out{i}_{j}_{suffix[spec['kind']]}", f"output_blocks.{i}.{j}")
    _norm(sd, "out.0", p["out_norm"])
    _conv2d(sd, "out.2", p["out_conv"])
    return sd


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_resblock(sd, prefix, p):
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _conv2d(sd, f"{prefix}.conv1", p["conv1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    _conv2d(sd, f"{prefix}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv2d(sd, f"{prefix}.nin_shortcut", p["nin_shortcut"])


def _vae_attn(sd, prefix, p):
    _norm(sd, f"{prefix}.norm", p["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv2d(sd, f"{prefix}.{name}", p[name])


def vae_from_jax(params, cfg: VAEConfig) -> StateDict:
    """JAX AutoencoderKL params -> the port's state_dict (encoder,
    quant_conv, decoder, post_quant_conv)."""
    p = _params(params)
    enc, dec = p["encoder"], p["decoder"]
    sd: StateDict = {}
    _conv2d(sd, "encoder.conv_in", enc["conv_in"])
    curr_res = cfg.resolution
    for i in range(len(cfg.ch_mult)):
        for b in range(cfg.num_res_blocks):
            _vae_resblock(sd, f"encoder.down.{i}.block.{b}", enc[f"down{i}_block{b}"])
            if curr_res in cfg.attn_resolutions:
                _vae_attn(sd, f"encoder.down.{i}.attn.{b}", enc[f"down{i}_attn{b}"])
        if i != len(cfg.ch_mult) - 1:
            _conv2d(sd, f"encoder.down.{i}.downsample.conv", enc[f"down{i}_downsample"]["conv"])
            curr_res //= 2
    _vae_resblock(sd, "encoder.mid.block_1", enc["mid_block1"])
    _vae_attn(sd, "encoder.mid.attn_1", enc["mid_attn"])
    _vae_resblock(sd, "encoder.mid.block_2", enc["mid_block2"])
    _norm(sd, "encoder.norm_out", enc["norm_out"])
    _conv2d(sd, "encoder.conv_out", enc["conv_out"])
    _conv2d(sd, "quant_conv", p["quant_conv"])
    _conv2d(sd, "decoder.conv_in", dec["conv_in"])
    _vae_resblock(sd, "decoder.mid.block_1", dec["mid_block1"])
    _vae_attn(sd, "decoder.mid.attn_1", dec["mid_attn"])
    _vae_resblock(sd, "decoder.mid.block_2", dec["mid_block2"])
    curr_res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    for i in reversed(range(len(cfg.ch_mult))):
        for b in range(cfg.num_res_blocks + 1):
            _vae_resblock(sd, f"decoder.up.{i}.block.{b}", dec[f"up{i}_block{b}"])
            if curr_res in cfg.attn_resolutions:
                _vae_attn(sd, f"decoder.up.{i}.attn.{b}", dec[f"up{i}_attn{b}"])
        if i != 0:
            _conv2d(sd, f"decoder.up.{i}.upsample.conv", dec[f"up{i}_upsample"]["conv"])
            curr_res *= 2
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    _conv2d(sd, "decoder.conv_out", dec["conv_out"])
    _conv2d(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


# ---------------------------------------------------------------------------
# CLIP text tower
# ---------------------------------------------------------------------------

def _resblocks(sd, p, layers: int):
    """OpenCLIP resblocks 0..layers-1 (the text and the vision tower's)."""
    for i in range(layers):
        prefix, q = f"transformer.resblocks.{i}", p[f"resblock{i}"]
        _norm(sd, f"{prefix}.ln_1", q["ln_1"])
        _norm(sd, f"{prefix}.ln_2", q["ln_2"])
        _put(sd, f"{prefix}.attn", in_proj_weight=np.asarray(q["in_proj"]["kernel"]).T,
             in_proj_bias=q["in_proj"]["bias"])
        _linear(sd, f"{prefix}.attn.out_proj", q["out_proj"])
        _linear(sd, f"{prefix}.mlp.c_fc", q["c_fc"])
        _linear(sd, f"{prefix}.mlp.c_proj", q["c_proj"])


def clip_from_jax(params, cfg: CLIPTextConfig, full: bool = False) -> StateDict:
    """JAX CLIPTextEncoder params -> the port's state_dict; `full` for the
    whole tower and `text_projection` (CLIPTextEncoder(cfg, full=True), the
    tree of convert_clip(full=True))."""
    p = _params(params)
    sd: StateDict = {"token_embedding.weight": _t(p["token_embedding"]),
                     "positional_embedding": _t(p["positional_embedding"])}
    _norm(sd, "ln_final", p["ln_final"])
    if full:
        sd["text_projection"] = _t(p["text_projection"])
    _resblocks(sd, p, cfg.layers - (1 if cfg.penultimate and not full else 0))
    return sd


# ---------------------------------------------------------------------------
# i2v: CLIP vision tower and image projector
# ---------------------------------------------------------------------------

def clip_vision_from_jax(params, layers: int) -> StateDict:
    """JAX CLIPVisionEncoder params -> the port's (OpenCLIP visual) state_dict."""
    p = _params(params)
    sd: StateDict = {name: _t(p[name]) for name in
                     ("class_embedding", "positional_embedding", "proj")}
    sd["conv1.weight"] = _t(np.asarray(p["patch"]["kernel"]).transpose(3, 2, 0, 1))
    _norm(sd, "ln_pre", p["ln_pre"])
    _norm(sd, "ln_post", p["ln_post"])
    _resblocks(sd, p, layers)
    return sd


def image_proj_from_jax(params) -> StateDict:
    """JAX ImageProjModel or Resampler params -> the port's state_dict."""
    p = _params(params)
    sd: StateDict = {}
    if "proj" in p:  # ImageProjModel
        _linear(sd, "proj", p["proj"])
        _norm(sd, "norm", p["norm"])
        return sd
    sd["latents"] = _t(p["latents"])
    _linear(sd, "proj_in", p["proj_in"])
    _linear(sd, "proj_out", p["proj_out"])
    _norm(sd, "norm_out", p["norm_out"])
    i = 0
    while f"layer{i}_attn" in p:
        a, prefix = p[f"layer{i}_attn"], f"layers.{i}"
        _norm(sd, f"{prefix}.0.norm1", a["norm1"])
        _norm(sd, f"{prefix}.0.norm2", a["norm2"])
        for name in ("to_q", "to_kv", "to_out"):
            _linear(sd, f"{prefix}.0.{name}", a[name])
        _norm(sd, f"{prefix}.1.0", p[f"layer{i}_ff_norm"])
        _linear(sd, f"{prefix}.1.1", p[f"layer{i}_ff_in"])
        _linear(sd, f"{prefix}.1.3", p[f"layer{i}_ff_out"])
        i += 1
    return sd
