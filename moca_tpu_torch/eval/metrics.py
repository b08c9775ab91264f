"""Video quality metrics: SSIM/PSNR, the temporal proxy, CASS/relCASS, LPIPS.

Port of moca_tpu/eval/metrics.py, on torch tensors on any device (the
sweep runs them on the GPU). SSIM (Wang et al., skimage's Gaussian-weighted
defaults) and PSNR over [..., H, W, C] images; `temporal_lpips_proxy`, the
mean 1 - SSIM of consecutive frames; the concept-alignment scores of the
MoCA-Video paper (`cass`, `rel_cass`, with the JAX package's x100
convention, DECISIONS.md); and LPIPS (Zhang et al. 2018) on torchvision's
AlexNet feature stages with the learned per-channel weights, both supplied
as torch state dicts (`convert_lpips_weights`, the keys the JAX sweep
reads). Everything computes in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).float()


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, max_val: float = 1.0, kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [..., H, W, C] images: the windowed formulation with a
    VALID Gaussian window, per channel."""
    a = _f32(a)
    b = _f32(b, a.device)
    k = _gaussian_kernel(kernel_size, sigma, a.device)[None, None]

    def filt(x):  # depthwise VALID filter over (H, W) of every channel
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        flat = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2).reshape(-1, 1, h, w)
        out = F.conv2d(flat, k)
        oh, ow = out.shape[-2:]
        return out.reshape(-1, c, oh, ow).permute(0, 2, 3, 1).reshape(lead + (oh, ow, c))

    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(-3, -2, -1))


def psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
    a = _f32(a)
    mse = torch.mean((a - _f32(b, a.device)) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def temporal_lpips_proxy(video) -> torch.Tensor:
    """Mean 1 - SSIM between consecutive frames of [T, H, W, C] (lower is
    smoother), the weight-free stand-in for LPIPS-T."""
    video = _f32(video)
    return torch.mean(1.0 - ssim(video[:-1], video[1:]))


# ---------------------------------------------------------------------------
# CASS / relCASS (the paper's concept-alignment metric; the convention is
# the JAX package's, moca_tpu/eval/metrics.py:73-148)
# ---------------------------------------------------------------------------

def clip_cosine(a, b) -> torch.Tensor:
    """Cosine similarity along the last axis (broadcasting batch dims)."""
    a, b = _f32(a), _f32(b)
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp(min=1e-8)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp(min=1e-8)
    return torch.sum(a * b, dim=-1)


def cass(sim_src_src, sim_src_tgt, sim_out_src, sim_out_tgt, scale: float = 100.0):
    """Concept Alignment Shift Score: scale * [(sim(out, tgt) - sim(src, tgt))
    + (sim(src, src) - sim(out, src))]; identity edits score 0."""
    return scale * ((sim_out_tgt - sim_src_tgt) + (sim_src_src - sim_out_src))


def rel_cass(sim_src_src, sim_src_tgt, sim_out_src, sim_out_tgt, scale: float = 1.0):
    """CASS with each shift term divided by its source-video baseline."""
    t = (sim_out_tgt - sim_src_tgt) / torch.clamp(torch.abs(sim_src_tgt), min=1e-8)
    s = (sim_src_src - sim_out_src) / torch.clamp(torch.abs(sim_src_src), min=1e-8)
    return scale * (t + s)


def concept_alignment_scores(src_frame_emb, out_frame_emb, src_text_emb, tgt_text_emb) -> dict:
    """The four video-prompt similarities and CASS / relCASS from CLIP
    embeddings: frames [T, D] of the source and edited videos
    (CLIPVisionEncoder 'pooled'), prompts [D] (CLIPTextEncoder 'embed')."""
    sim = {
        "sim_src_src": torch.mean(clip_cosine(src_frame_emb, src_text_emb)),
        "sim_src_tgt": torch.mean(clip_cosine(src_frame_emb, tgt_text_emb)),
        "sim_out_src": torch.mean(clip_cosine(out_frame_emb, src_text_emb)),
        "sim_out_tgt": torch.mean(clip_cosine(out_frame_emb, tgt_text_emb)),
    }
    args = (sim["sim_src_src"], sim["sim_src_tgt"], sim["sim_out_src"], sim["sim_out_tgt"])
    sim["cass"] = cass(*args)
    sim["rel_cass"] = rel_cass(*args)
    return sim


# ---------------------------------------------------------------------------
# LPIPS: AlexNet backbone, weights supplied by the caller
# ---------------------------------------------------------------------------

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet().features: (index, out, kernel, stride, padding) of
# conv1..conv5, each followed by a ReLU (the five LPIPS taps)
_ALEX_CONVS = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1), (8, 256, 3, 1, 1),
               (10, 256, 3, 1, 1))


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's feature stages tapped after each ReLU, the five
    LPIPS layers (64/192/384/256/256 channels): [N, H, W, 3] in the LPIPS
    space -> five channels-last maps. Max-pools (3, stride 2) after taps 1
    and 2."""

    def __init__(self):
        super().__init__()
        cin = 3
        for n, (_, cout, k, s, p) in enumerate(_ALEX_CONVS):
            self.add_module(f"conv{n + 1}", nn.Conv2d(cin, cout, k, stride=s, padding=p))
            cin = cout

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        feats = []
        for n in range(5):
            x = F.relu(getattr(self, f"conv{n + 1}")(x))
            feats.append(x.permute(0, 2, 3, 1))
            if n < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats


def lpips_from_features(feats_a, feats_b, lin_weights) -> torch.Tensor:
    """LPIPS given the per-layer channels-last features and the non-negative
    per-channel weights [C_l]: unit-normalize channels, squared difference,
    weighted channel sum, spatial mean, sum over layers."""
    total = 0.0
    for fa, fb, w in zip(feats_a, feats_b, lin_weights):
        na = fa / torch.linalg.norm(fa, dim=-1, keepdim=True).clamp(min=1e-10)
        nb = fb / torch.linalg.norm(fb, dim=-1, keepdim=True).clamp(min=1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=-1), dim=(-2, -1))
    return total


def lpips(a, b, net: AlexNetFeatures, lin_weights) -> torch.Tensor:
    """LPIPS between image batches [N, H, W, 3] in [-1, 1], on `net`'s device."""
    device = next(net.parameters()).device
    shift = torch.tensor(LPIPS_SHIFT, device=device)
    scale = torch.tensor(LPIPS_SCALE, device=device)
    norm = lambda x: (_f32(x, device) - shift) / scale
    lins = [_f32(w, device) for w in lin_weights]
    return lpips_from_features(net(norm(a)), net(norm(b)), lins)


def lpips_i(src_video, out_video, net, lin_weights) -> torch.Tensor:
    """LPIPS-I: the mean per-frame distance between the edited and the
    source video (higher is a stronger edit)."""
    return torch.mean(lpips(src_video, out_video, net, lin_weights))


def lpips_t(video, net, lin_weights) -> torch.Tensor:
    """LPIPS-T: the mean distance between consecutive frames (lower is
    smoother)."""
    return torch.mean(lpips(video[:-1], video[1:], net, lin_weights))


def convert_lpips_weights(alexnet_sd, lpips_sd) -> tuple:
    """(torchvision alexnet state_dict, LPIPS 'alex' lin state_dict) ->
    (AlexNetFeatures in fp32 on the CPU, [w_l] lin weights): the keys
    features.{0,3,6,8,10}.{weight,bias} and lin{0..4}.model.1.weight
    [1, C, 1, 1], as the JAX package's converter reads them."""
    net = AlexNetFeatures()
    net.load_state_dict({f"conv{n + 1}.{p}": _f32(alexnet_sd[f"features.{i}.{p}"])
                         for n, (i, *_) in enumerate(_ALEX_CONVS) for p in ("weight", "bias")})
    lins = [_f32(lpips_sd[f"lin{i}.model.1.weight"]).reshape(-1) for i in range(5)]
    return net.eval().requires_grad_(False), lins
