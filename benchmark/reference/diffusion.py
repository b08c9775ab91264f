"""Plain reference of the samplers around the networks, in float32.

The DDPM/DDIM schedule (VideoCrafter's `utils_diffusion.py` and
`ddim.py`, with its `use_scale` latent rescale), classifier-free guidance,
the DDIM step, MoCA's diagonal window step (momentum correction; the
injection and the gamma blend change only the discarded pred_x0, as in the
reference sampler with `inject_into_queue` off), the FIFO queue (its
diagonal layout with lookahead and the write-back of each window's second
half), the VAE posterior sample, and the stand-in tokenizer that hashes
words to ids.
Written for the benchmark alone; imports nothing of the measured program.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, Sequence

import numpy as np
import torch

SOT, EOT, CONTEXT_LENGTH = 49406, 49407, 77


def hash_tokens(texts: Sequence[str], vocab_size: int = 49408) -> np.ndarray:
    """[B, 77] ids: start token, md5 of each lower-cased word mod (vocab - 2),
    end token, zeros after (the stand-in for CLIP's BPE vocabulary)."""
    out = np.zeros((len(texts), CONTEXT_LENGTH), np.int64)
    for i, text in enumerate(texts):
        words = re.sub(r"\s+", " ", text).strip().lower().split(" ") if text.strip() else []
        ids = [int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % (vocab_size - 2)
               for w in words]
        toks = ([SOT] + ids + [EOT])[:CONTEXT_LENGTH]
        out[i, :len(toks)] = toks
    return out


class Schedule:
    """Linear-in-sqrt betas over 1000 steps, DDIM's uniform subset of
    `steps`, eta, and the use_scale ramp 1 -> scale_b over 400 steps."""

    def __init__(self, steps: int, eta: float, diffusion: dict, device):
        d = diffusion
        n = d["timesteps"]
        betas = np.linspace(d["linear_start"] ** 0.5, d["linear_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        ts = np.linspace(0, n - 1, steps).round().astype(np.int64)
        a = acp[ts]
        a_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
        sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        scale = np.concatenate([np.linspace(1.0, d["scale_b"], 400), np.full(n, d["scale_b"])])[:n]
        if not d["use_scale"]:
            scale = np.ones(n)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        self.timesteps = ts
        self.a, self.a_prev, self.sigma = f32(a), f32(a_prev), f32(sigma)
        self.sqrt_1ma = f32(np.sqrt(1.0 - a))
        self.scale = f32(scale[ts])
        self.scale_prev = f32(np.concatenate([scale[:1], scale[ts[:-1]]]))
        self.use_scale = d["use_scale"]


def cfg_parts(unet: Callable, x, t, ctx, uc, moves: list = None):
    """(e_c, e_u): the U-Net on the conditional and the unconditional
    context, the two rows of each input side by side; with `moves`, appends
    how far the conditioning moves the U-Net's output, ||e_c - e_u|| / ||e_u||."""
    b = x.shape[0]
    x2 = torch.cat([x, x])
    t2 = torch.cat([t, t])
    c2 = torch.cat([ctx.expand(b, -1, -1), uc.expand(b, -1, -1)])
    e = unet(x2, t2, c2)
    e_c, e_u = e[:b], e[b:]
    if moves is not None:
        moves.append(float(torch.linalg.vector_norm(e_c - e_u) / torch.linalg.vector_norm(e_u)))
    return e_c, e_u


def cfg_eps(unet: Callable, x, t, ctx, uc, scale: float, moves: list = None):
    """e_u + s (e_c - e_u): classifier-free guidance of `cfg_parts`."""
    e_c, e_u = cfg_parts(unet, x, t, ctx, uc, moves)
    return e_u + scale * (e_c - e_u)


def ddim_step(sch: Schedule, x, eps, index: int, noise):
    """p_sample_ddim with use_scale: x_{t-1} from x_t and eps at step `index`."""
    a, a_prev, sigma = sch.a[index], sch.a_prev[index], sch.sigma[index]
    pred_x0 = (x - sch.sqrt_1ma[index] * eps) / torch.sqrt(a)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps
    if sch.use_scale:
        pred_x0 = pred_x0 / sch.scale[index]
        return torch.sqrt(a_prev) * sch.scale_prev[index] * pred_x0 + dir_xt + sigma * noise
    return torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise


# --- MoCA on a FIFO queue ----------------------------------------------------

MOMENTUM_BETA, DIR_WEIGHT, CORRECTION_GAIN = 0.9, 1.5, 2.0


class Queue:
    """The diagonal queue of f*n noise levels, f/2 more at the cleanest
    level ahead of them with lookahead; 2n windows of f frames at stride f/2."""

    def __init__(self, sch: Schedule, f: int, n: int, lookahead: bool):
        if not lookahead:
            raise ValueError("the reference queue is the lookahead layout")
        self.f = f
        half = f // 2
        self.timesteps = np.concatenate([np.full(half, sch.timesteps[0]), sch.timesteps])
        self.indices = np.concatenate([np.zeros(half, np.int64), np.arange(f * n)])
        self.starts = np.arange(2 * n) * half


def moca_window(sch: Schedule, x, eps, indices, timesteps, noise_of):
    """One window's diagonal DDIM step with MoCA's momentum correction; x,
    eps [1, f, h, w, C]. noise_of(j) is frame j's draw. Returns x_prev."""
    prev = torch.zeros_like(x[:, 0])
    momentum = torch.zeros_like(x[:, 0])
    out = []
    for j in range(x.shape[1]):
        idx, t = int(indices[j]), int(timesteps[j])
        a, a_prev, sigma = sch.a[idx], sch.a_prev[idx], sch.sigma[idx]
        e = eps[:, j]
        pred_x0 = (x[:, j] - sch.sqrt_1ma[idx] * e) / torch.sqrt(a)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e
        if j > 0:
            momentum = MOMENTUM_BETA * momentum + (1 - MOMENTUM_BETA) * (
                pred_x0 - prev + DIR_WEIGHT * dir_xt)
            strength = CORRECTION_GAIN * (1.0 - np.float32(t) / np.float32(1000.0))
            pred_x0 = pred_x0 + float(strength) * momentum
        prev = pred_x0
        out.append(torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise_of(j))
    return torch.stack(out, dim=1)


def posterior_sample(mean, logvar, noise):
    return mean + torch.exp(0.5 * logvar) * noise
