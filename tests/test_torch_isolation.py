"""The port stands alone: no JAX and nothing of the JAX package.

A fresh interpreter imports every module of moca_tpu_torch and everything
chip_smoke.py imports, then lists the loaded modules: no JAX, nothing of the
JAX package, and no image, plot or YAML library (PIL, cv2, imageio,
matplotlib, yaml), which the GPU machine need not have; the port imports
those inside the functions that use them. And the port's entry points
refuse to run without a GPU unless the caller names the CPU.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import moca_tpu_torch
from moca_tpu_torch import resolve_device
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.latent_diffusion import init_random_model
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.schedule import make_schedule

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke_imports():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return sorted(names)


def test_port_and_chip_smoke_import_no_jax_and_no_moca_tpu():
    port = ["moca_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(moca_tpu_torch.__path__, "moca_tpu_torch."))
    assert {"moca_tpu_torch.pipelines.moca_video", "moca_tpu_torch.cli.main",
            "moca_tpu_torch.io.davis", "moca_tpu_torch.config",
            "moca_tpu_torch.cli.inference", "moca_tpu_torch.pipelines.t2v",
            "moca_tpu_torch.sampling.ddpm", "moca_tpu_torch.models.clip_vision",
            "moca_tpu_torch.models.ip_resampler", "moca_tpu_torch.eval.metrics",
            "moca_tpu_torch.eval.fvd", "moca_tpu_torch.eval.i3d", "moca_tpu_torch.eval.vbench",
            "moca_tpu_torch.cli.eval_sweep", "moca_tpu_torch.parallel.mesh",
            "moca_tpu_torch.io.fastio", "moca_tpu_torch.utils.profiling",
            "moca_tpu_torch.utils.ema", "moca_tpu_torch.utils.visualization"} <= set(port)
    modules = port + _chip_smoke_imports() + ["chip_smoke"]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "moca_tpu", "PIL", "cv2", "imageio",
                                  "yaml", "matplotlib")]
    assert not bad, bad
    assert "moca_tpu_torch.ops.flash_attention" in loaded


def test_entry_points_without_device_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_schedule(8)
    tiny = (UNetConfig(model_channels=32, num_head_channels=8, context_dim=16,
                       channel_mult=(1,), attention_resolutions=(), num_res_blocks=1),
            VAEConfig(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, resolution=32),
            CLIPTextConfig(width=16, heads=2, layers=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_random_model(*tiny)
    model = init_random_model(*tiny, device="cpu")
    assert model.device.type == "cpu"
