"""Shipped-config oracle on the port: the reference's own towers at full size.

Port of scripts/full_oracle_check.py. The upstream VideoCrafter repository's
UNetModel (the 1.4B-parameter U-Net: model_channels 320, mult [1, 2, 4, 4],
attention at ds {1, 2, 4}, context 1024, temporal_length 16,
addition_attention and fps_cond) and AutoencoderKL (ch 128, mult
[1, 2, 4, 4]) are built at the shipped size and filled from seeds as in the
JAX script; their state dicts load straight into the port's UNet3D and
AutoencoderKL (the port's modules carry the upstream key names, no
conversion step) with strict=True, so every real checkpoint key, Sequential
index and layer width is exercised. The same inputs go through both: a
[1, 16, 8, 8, 4] latent at FIFO per-frame timesteps with a 77 x 1024
context, and a 64 x 64 image through the VAE's encoder and decoder. The
limits are the JAX script's: max abs error < 5e-4.

The reference runs on the CPU; the port on the GPU unless the caller of
`main` names another device, in fp32 with TF32 off while it runs (the
oracle certifies fp32 arithmetic; the temporal attention takes K2's fp32
path). Prints `FULL ORACLE OK  unet=...  vae=...` on success:

    python -m moca_tpu_torch.cli.full_oracle_check --reference_repo VideoCrafter

The reference repository is not part of this one: --reference_repo names a
checkout of it (the directory holding `lvdm/`). Without one the script
stops with ModuleNotFoundError, which `cli.acceptance` records as a skipped
stage. Needs ~25 GB of host memory for the reference towers.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import types

import numpy as np
import torch

from moca_tpu_torch import resolve_device
from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig
from moca_tpu_torch.models.vae import AutoencoderKL, VAEConfig

LIMIT = 5e-4  # max abs error, the JAX script's


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference_repo", default="VideoCrafter",
                   help="a checkout of the upstream VideoCrafter repository (holds lvdm/)")
    return p


def load_reference(repo: str):
    """The reference's openaimodel3d and autoencoder modules from `repo`
    (pytorch_lightning stubbed: the towers need only nn.Module)."""
    sys.path.insert(0, os.path.abspath(repo))
    if "pytorch_lightning" not in sys.modules:
        pl = types.ModuleType("pytorch_lightning")
        pl.LightningModule = torch.nn.Module
        sys.modules["pytorch_lightning"] = pl
    from lvdm.models import autoencoder
    from lvdm.modules.networks import openaimodel3d

    return types.SimpleNamespace(openaimodel3d=openaimodel3d, autoencoder=autoencoder)


def randomize(module, seed=0, scale=0.05):
    """Every parameter (and relative-position buffer) ~ N(0, scale^2) from
    a CPU generator seeded `seed`, in the JAX script's order."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        for name, b in module.named_buffers():
            if b.dtype.is_floating_point and "relative" in name:
                b.copy_(torch.randn(b.shape, generator=g) * scale)


@contextlib.contextmanager
def full_fp32():
    """No TF32 in matmuls or convolutions while the port's towers run."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def check_unet(ref, device) -> float:
    t0 = time.time()
    t_unet = ref.openaimodel3d.UNetModel(
        in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
        attention_resolutions=[1, 2, 4], dropout=0.0, channel_mult=[1, 2, 4, 4], dims=2,
        context_dim=1024, num_head_channels=64, transformer_depth=1, use_linear=True,
        temporal_conv=True, tempspatial_aware=False, temporal_attention=True,
        temporal_selfatt_only=True, use_relative_position=False, use_causal_attention=False,
        temporal_length=16, addition_attention=True, use_image_attention=False,
        temporal_transformer_depth=1, fps_cond=True)
    t_unet.eval()
    randomize(t_unet, seed=0)
    print(f"[{time.time() - t0:.0f}s] reference UNetModel built: "
          f"{sum(p.numel() for p in t_unet.parameters()) / 1e9:.3f}B params", flush=True)
    with torch.device(device):
        unet = UNet3D(UNetConfig())  # shipped defaults
    unet.eval().requires_grad_(False)
    unet.load_state_dict(t_unet.state_dict(), strict=True)
    print(f"[{time.time() - t0:.0f}s] loaded into the port's UNet3D on {device}", flush=True)

    rng = np.random.default_rng(1)
    b, t, h, w = 1, 16, 8, 8
    x = rng.standard_normal((b, t, h, w, 4)).astype(np.float32) * 0.5
    ctx = rng.standard_normal((b, 77, 1024)).astype(np.float32) * 0.5
    # FIFO per-frame timesteps (the is_fifo branch, openaimodel3d.py:535-549)
    ts = np.linspace(40, 960, t).round().astype(np.int64)
    with torch.no_grad():
        out_t = t_unet(torch.from_numpy(np.moveaxis(x, -1, 1)).contiguous(),
                       torch.from_numpy(ts), context=torch.from_numpy(ctx), fps=16)
    out_t = np.moveaxis(out_t.numpy(), 1, -1)
    print(f"[{time.time() - t0:.0f}s] reference forward done", flush=True)
    with torch.inference_mode(), full_fp32():
        out_p = unet(torch.from_numpy(x).to(device), torch.from_numpy(np.tile(ts[None], (b, 1))).to(device),
                     torch.from_numpy(ctx).to(device), fps=16).float().cpu().numpy()
    print(f"[{time.time() - t0:.0f}s] port forward done", flush=True)
    err = float(np.abs(out_p - out_t).max())
    print(f"U-Net shipped-config parity: max abs err {err:.3e} "
          f"(|out| max {np.abs(out_t).max():.3e})", flush=True)
    assert err < LIMIT, err
    return err


def check_vae(ref, device) -> float:
    ddconfig = dict(double_z=True, z_channels=4, resolution=256, in_channels=3, out_ch=3,
                    ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[],
                    dropout=0.0)
    t_vae = ref.autoencoder.AutoencoderKL(
        ddconfig=ddconfig, lossconfig={"target": "torch.nn.Identity"}, embed_dim=4)
    t_vae.eval()
    randomize(t_vae, seed=2, scale=0.03)
    with torch.device(device):
        vae = AutoencoderKL(VAEConfig())
    vae.eval().requires_grad_(False)
    vae.load_state_dict({k: v for k, v in t_vae.state_dict().items()
                         if not k.startswith("loss.")}, strict=True)

    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        mean_t = t_vae.encode(torch.from_numpy(np.moveaxis(img, -1, 1)).contiguous()).mean
        dec_t = t_vae.decode(mean_t).numpy()
    with torch.inference_mode(), full_fp32():
        mean_p, _ = vae.encode_moments(torch.from_numpy(img).to(device))
        dec_p = vae.decode(mean_p).cpu().numpy()
    e1 = float(np.abs(mean_p.cpu().numpy() - np.moveaxis(mean_t.numpy(), 1, -1)).max())
    e2 = float(np.abs(dec_p - np.moveaxis(dec_t, 1, -1)).max())
    print(f"VAE shipped-config parity: encode err {e1:.3e}, decode err {e2:.3e}", flush=True)
    assert e1 < LIMIT and e2 < LIMIT, (e1, e2)
    return max(e1, e2)


def main(argv=None, device=None):
    """Both checks on `device` (the GPU unless the caller names one);
    returns (unet error, vae error)."""
    args = build_parser().parse_args(argv)
    ref = load_reference(args.reference_repo)
    device = resolve_device(device)
    vae_err = check_vae(ref, device)
    unet_err = check_unet(ref, device)
    print(f"FULL ORACLE OK  unet={unet_err:.3e}  vae={vae_err:.3e}", flush=True)
    return unet_err, vae_err


if __name__ == "__main__":
    main()
