"""InceptionI3d feature extractor for FVD, the `videogpt` variant.

Port of moca_tpu/eval/i3d.py. The reference computes FVD through the
`common_metrics_on_video_quality` submodule, whose `videogpt` method runs
piergiaj/pytorch-i3d's `InceptionI3d` (Kinetics-400 head,
`i3d_pretrained_400.pt`) and feeds its 400 logits to the Fréchet fit
(eval/fvd.py). Here that network is a functional apply over a params tree of
tensors, BatchNorm folded into the convolutions at convert time (eval mode
only, as the reference runs it); `convert_i3d_weights` takes the pytorch-i3d
state dict the JAX sweep reads. Video tensors are channels-last
[B, T, H, W, C] at the public functions, as in the JAX package; everything
computes in fp32.

Layout notes:
- TF "SAME" padding, asymmetric at stride 2 (the lower side takes the
  smaller half), padded explicitly: zeros for the convolutions, -inf for the
  max-pools, as XLA pads (the original pads its pools with zeros, equal on
  its post-ReLU inputs).
- The logits head is the original's (2, 7, 7) VALID average pool, a
  1 x 1 x 1 convolution and a mean over time (not a global mean), so inputs
  must be >= 193 px spatial and >= 9 frames; `i3d_logits` refuses less.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from moca_tpu_torch import resolve_device

# Inception blocks: name -> (b0, b1a, b1b, b2a, b2b, b3b) output channels.
_INCEPTION_CFG = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def _same_pad(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """TF SAME padding of x [B, C, T, H, W] for `kernel` and `stride`."""
    pads = []
    for size, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):
        total = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(p: Dict, x: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    w = p["weight"]
    return F.conv3d(_same_pad(x, w.shape[2:], stride), w, p.get("bias"), stride)


def _unit(p: Dict, x: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    """Unit3D: convolution (BatchNorm folded in) and ReLU."""
    return F.relu(_conv(p, x, stride))


def _max_pool(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(_same_pad(x, kernel, stride, -float("inf")), kernel, stride)


def _inception(p: Dict, x: torch.Tensor) -> torch.Tensor:
    b0 = _unit(p["b0"], x)
    b1 = _unit(p["b1b"], _unit(p["b1a"], x))
    b2 = _unit(p["b2b"], _unit(p["b2a"], x))
    b3 = _unit(p["b3b"], _max_pool(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


def _backbone(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """[B, 3, T, H, W] -> Mixed_5c's [B, 1024, T/8, H/32, W/32]."""
    x = _unit(params["Conv3d_1a_7x7"], x, (2, 2, 2))
    x = _max_pool(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
    x = _unit(params["Conv3d_2b_1x1"], x)
    x = _unit(params["Conv3d_2c_3x3"], x)
    x = _max_pool(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
    x = _inception(params["Mixed_3b"], x)
    x = _inception(params["Mixed_3c"], x)
    x = _max_pool(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
    for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _inception(params[name], x)
    x = _max_pool(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
    x = _inception(params["Mixed_5b"], x)
    return _inception(params["Mixed_5c"], x)


def _channels_first(x) -> torch.Tensor:
    return torch.as_tensor(x).float().permute(0, 4, 1, 2, 3)


def i3d_features(params: Dict, x) -> torch.Tensor:
    """Backbone through Mixed_5c: x [B, T, H, W, 3] in [-1, 1] ->
    [B, T/8, H/32, W/32, 1024]."""
    return _backbone(params, _channels_first(x)).permute(0, 2, 3, 4, 1)


def i3d_logits(params: Dict, x) -> torch.Tensor:
    """Kinetics-400 logits [B, 400] of a preprocessed video [B, T, H, W, 3]
    in [-1, 1], the videogpt FVD feature vector."""
    if x.shape[1] < 9:
        raise ValueError(
            f"I3D needs ≥9 input frames (got T={x.shape[1]}): the temporal "
            "stride-8 backbone + (2,·,·) head window would otherwise "
            "silently mean over an empty axis → NaN logits")
    f = _backbone(params, _channels_first(x))
    if f.shape[3] < 7 or f.shape[4] < 7:
        raise ValueError(
            f"I3D head needs ≥7×7 Mixed_5c maps (got {f.shape[3]}×"
            f"{f.shape[4]}): input must be ≥193 px spatial (roughly "
            "224-class inputs), like the original's fixed (2,7,7) "
            "average pool")
    f = F.avg_pool3d(f, (2, 7, 7), stride=1)
    y = _conv(params["logits"], f)  # 1 x 1 x 1 convolution with bias, no activation
    return y.mean(dim=2)[:, :, 0, 0]


def i3d_preprocess(videos, target: int = 224) -> torch.Tensor:
    """[B, T, H, W, C] in [0, 1] -> bilinear resize to target x target (half-
    pixel centres, no antialias: torch's `interpolate(align_corners=False)`)
    -> [-1, 1], channels-last."""
    x = torch.as_tensor(videos).float()
    b, t, h, w, c = x.shape
    x = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(target, target), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1).reshape(b, t, target, target, c) * 2.0 - 1.0


def params_to(params: Dict, device) -> Dict:
    """The params tree with every tensor on `device`."""
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def i3d_feature_fn(params: Dict, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A `feature_fn` for `eval.fvd.fvd`: video batch [B, T, H, W, 3] in
    [0, 1] -> [B, 400] logits (numpy), computed on `device` (the GPU unless
    the caller names one)."""
    device = resolve_device(device)
    on_device = params_to(params, device)

    @torch.inference_mode()
    def fn(videos):
        x = i3d_preprocess(torch.as_tensor(np.asarray(videos), device=device))
        return i3d_logits(on_device, x).cpu().numpy()

    return fn


def convert_i3d_weights(state_dict) -> Dict:
    """piergiaj/pytorch-i3d `InceptionI3d(400)` state_dict -> params tree of
    fp32 CPU tensors {unit: {"weight" [O, I, kT, kH, kW], "bias" [O]}}.

    BatchNorm (eps=1e-3, the original Unit3D's) is folded:
    weight' = weight * g / sqrt(var + eps) per out-channel,
    bias' = b - mean * g / sqrt(var + eps). The logits unit has a real
    convolution bias and no BatchNorm."""

    def np32(t):
        return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)

    def unit(prefix, bn=True):
        w = np32(state_dict[f"{prefix}.conv3d.weight"])
        if bn:
            g, b = np32(state_dict[f"{prefix}.bn.weight"]), np32(state_dict[f"{prefix}.bn.bias"])
            m = np32(state_dict[f"{prefix}.bn.running_mean"])
            v = np32(state_dict[f"{prefix}.bn.running_var"])
            s = g / np.sqrt(v + 1e-3)
            return {"weight": torch.from_numpy(w * s[:, None, None, None, None]),
                    "bias": torch.from_numpy(b - m * s)}
        out = {"weight": torch.from_numpy(w)}
        if f"{prefix}.conv3d.bias" in state_dict:
            out["bias"] = torch.from_numpy(np32(state_dict[f"{prefix}.conv3d.bias"]))
        return out

    params = {name: unit(name) for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")}
    params["logits"] = unit("logits", bn=False)
    for name in _INCEPTION_CFG:
        params[name] = {b: unit(f"{name}.{b}") for b in _BRANCHES}
    return params
