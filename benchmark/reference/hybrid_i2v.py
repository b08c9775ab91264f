"""Plain reference of DynamiCrafter's image animation, in float32.

DynamiCrafter (Xing et al., arXiv 2310.12190; its configs/inference_1024_v1.0.yaml,
lvdm/models/ddpm3d.py, lvdm/models/samplers/ddim.py,
lvdm/modules/networks/openaimodel3d.py, lvdm/modules/encoders/resampler.py)
is the VideoCrafter U-Net of `nets.UNet` conditioned in two streams:

  * the image's VAE latent concatenated on the channel axis to every
    frame's input (`in_channels` 8; the hybrid conditioning);
  * 16 image tokens for each frame from a Resampler with 16 x T queries,
    each frame's cross-attention reading the 77 text tokens and its own 16
    (`FrameContextUNet`); the unconditional row's from an all-zero image;

and sampled by v-prediction on a zero-terminal-SNR schedule with trailing
DDIM timesteps, guidance rescale and the dynamic rescale of x0 (`Schedule`,
`guided`, `v_step`). Written for the benchmark alone: it imports nothing of
the measured program, and nothing of the other reference but its networks
(`nets`), its tokenizer stand-in and its posterior sample (`diffusion`).
Every attention is `nets.attention`, in blocks of the batch so that the
logits at S = 9216 fit. `layout`, `build` and `meta_model` are
`benchmark.reference`'s for this bundle; `benchmark.reference.control`
takes it as it is.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference import diffusion as rd
from benchmark.reference import nets


class FrameContextUNet(nets.UNet):
    """`nets.UNet` whose context is [77 text tokens ; `frame_tokens` image
    tokens for each of the T frames], frame-major: frame f of each row
    attends to the text and to image tokens [77 + f n, 77 + (f + 1) n)."""

    def __init__(self, c: dict, frame_tokens: int):
        super().__init__(c)
        self.frame_tokens = frame_tokens

    def frame_context(self, context, frames):
        b, _, d = context.shape
        text = context[:, :nets.TEXT_TOKENS].repeat_interleave(frames, dim=0)
        image = context[:, nets.TEXT_TOKENS:]
        if image.shape[1] != frames * self.frame_tokens:
            raise ValueError(f"{image.shape[1]} image tokens for {frames} frames of "
                             f"{self.frame_tokens}")
        return torch.cat([text, image.reshape(b * frames, self.frame_tokens, d)], dim=1)

    def forward(self, x, t, context, fps):
        b, f, hh, ww, _ = x.shape
        emb = self.time_embed(nets.timestep_embedding(t, self.mc))
        fps_bt = torch.full((b, f), float(fps), device=x.device)
        emb = (emb + self.fps_embedding(nets.timestep_embedding(fps_bt, self.mc))).reshape(b * f, -1)
        ctx = self.frame_context(context.float(), f)
        h = x.float().reshape(b * f, hh, ww, x.shape[-1])
        hs = []
        for i, block in enumerate(self.input_blocks):
            h = self._run(block, h, emb, ctx, b)
            if i == 0:
                h = self._run(self.init_attn, h, emb, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, b)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx, b)
        return self.out(h).reshape(b, f, hh, ww, self.out_ch)


class HybridDiffusion(nn.Module):
    """unet, vae, clip (text), vision and image_proj under the names the
    program's bundle uses: one state dict loads into both."""

    def __init__(self, cfg: dict):
        super().__init__()
        u, v, r = cfg["unet"], cfg["vision"], cfg["resampler"]
        if r["embedding_dim"] != v["width"] or r["output_dim"] != u["context_dim"]:
            raise ValueError("the Resampler reads the vision tower's tokens and writes the "
                             "U-Net's context")
        self.scale_factor = cfg["diffusion"]["scale_factor"]
        self.unet = FrameContextUNet(u, r["num_queries"])
        self.vae = nets.AutoencoderKL(cfg["vae"])
        self.clip = nets.TextEncoder(cfg["clip"])
        self.vision = nets.VisionEncoder(v)
        # the queries of every frame together: the Perceiver attends over all of them
        self.image_proj = nets.Resampler(
            dim=r["dim"], depth=r["depth"], dim_head=r["dim_head"], heads=r["heads"],
            num_queries=r["num_queries"] * r["video_length"], embedding_dim=r["embedding_dim"],
            output_dim=r["output_dim"], ff_mult=r["ff_mult"])

    def image_embeds(self, images):
        """[B, H, W, 3] in [-1, 1] -> [B, T x 16, context] image tokens."""
        return self.image_proj(self.vision(images))

    def image_latent(self, images, noise):
        """[B, H, W, 3] in [-1, 1] -> the scaled posterior sample [B, h, w, 4]
        with the standard normal draw `noise`."""
        mean, logvar = self.vae.moments(images)
        return self.scale_factor * rd.posterior_sample(mean, logvar, noise)

    def decode(self, z):
        """Scaled latents [N, h, w, 4] -> frames [N, H, W, 3] in [-1, 1]."""
        return self.vae.decode(z / self.scale_factor).clamp(-1.0, 1.0)


def layout(config: dict):
    """({name: shape} of the state dict both sides load, the names of the
    normalization layers' scales)."""
    with torch.device("meta"):
        model = HybridDiffusion(config)
    shapes = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    norms = frozenset(f"{name}.weight" for name, m in model.named_modules()
                      if isinstance(m, (nets.GroupNorm, nets.LayerNorm)))
    return shapes, norms


def build(config: dict, weights: dict) -> HybridDiffusion:
    """The reference on the weights' device, in float32."""
    with torch.device("meta"):
        model = HybridDiffusion(config)
    model.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def meta_model(config: dict) -> HybridDiffusion:
    with torch.device("meta"):
        return HybridDiffusion(config).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

class Schedule:
    """Scaled-linear betas rescaled to zero terminal SNR, `steps` trailing
    DDIM timesteps, eta, and the dynamic rescale r: 1 -> base_scale over 400
    timesteps, then flat, taken at the DDIM timesteps, r_prev the same array
    shifted by one with its first entry repeated (samplers/ddim.py)."""

    def __init__(self, steps: int, eta: float, diffusion: dict, device):
        d = diffusion
        n = d["timesteps"]
        betas = np.linspace(d["linear_start"] ** 0.5, d["linear_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        if d["rescale_betas_zero_snr"]:
            root = np.sqrt(np.cumprod(1.0 - betas))
            root = (root - root[-1]) * root[0] / (root[0] - root[-1])
            acp = root**2
        else:
            acp = np.cumprod(1.0 - betas)
        ts = np.round(np.arange(n, 0, -n / steps))[::-1].astype(np.int64) - 1
        a = acp[ts]
        a_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
        sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        r = np.ones(n)
        if d["use_dynamic_rescale"]:
            r = np.concatenate([np.linspace(1.0, d["base_scale"], 400),
                                np.full(n, d["base_scale"])])[:n]
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        self.timesteps, self.alphas_cumprod = ts, acp
        self.a_prev, self.sigma = f32(a_prev), f32(sigma)
        self.sqrt_a, self.sqrt_1ma = f32(np.sqrt(a)), f32(np.sqrt(1.0 - a))
        self.r = f32(r[ts])
        self.r_prev = f32(np.concatenate([r[ts][:1], r[ts][:-1]]))


def guided(v_c, v_u, scale: float, rescale: float):
    """(v, k): classifier-free guidance v_u + s (v_c - v_u), then guidance
    rescale, v <- phi v std(v_c) / std(v) + (1 - phi) v, the standard
    deviations (unbiased, as torch.std) over every axis but the batch. k is
    the factor the rescale applied to each row, so that v = k (s v_c -
    (s - 1) v_u)."""
    v = v_u + scale * (v_c - v_u)
    if not rescale:
        return v, torch.ones((v.shape[0],) + (1,) * (v.ndim - 1), device=v.device)
    dims = tuple(range(1, v.ndim))
    k = rescale * v_c.std(dim=dims, keepdim=True) / v.std(dim=dims, keepdim=True) + (1 - rescale)
    return k * v, k


def v_step(sch: Schedule, x, v, index: int, noise):
    """x_{t-1} from x_t and the model's v at DDIM step `index`: eps =
    sqrt(a) v + sqrt(1 - a) x and x0 = sqrt(a) x - sqrt(1 - a) v
    (ddpm3d.py predict_eps_from_z_and_v, predict_start_from_z_and_v), x0
    times r_prev / r, then the DDIM update (its square root clamped at 0,
    where upstream takes the root of a rounding-negative number)."""
    sa, s1a = sch.sqrt_a[index], sch.sqrt_1ma[index]
    a_prev, sigma = sch.a_prev[index], sch.sigma[index]
    eps = sa * v + s1a * x
    x0 = (sa * x - s1a * v) * (sch.r_prev[index] / sch.r[index])
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps
    return torch.sqrt(a_prev) * x0 + dir_xt + sigma * noise
