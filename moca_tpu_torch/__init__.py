"""moca_tpu_torch — the PyTorch/CUDA port of moca_tpu, for an NVIDIA H100.

Mirrors the `moca_tpu` package file by file: each module here has one
reference module there (same relative path), held to it by the
`tests/test_torch_*.py` suite. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path has a hand-written CUDA kernel under
`csrc/`, built with `nvcc` for `sm_90a` at first use (ops/flash_attention.py).

Conventions kept from the reference: video tensors are channels-last
[B, T, H, W, C] and timesteps are per-frame [B, T] at every public function.

Entry points run on the GPU unless the caller passes `device="cpu"`; with no
device given and no GPU present they raise instead of running on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; raises without a GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "moca_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
