"""Operations and bytes, worked out from shapes, and the card's peaks.

The bounds of the attention kernels are copied from the repository's
`chip_smoke.py` (`peak_flops`, `attention_bound_ms`, `fused_qkv_bound_ms`),
restated on the shape keys of the program's launch tallies: each input byte
read once and each output byte written once, at 3.35 TB/s, against the peak
of the unit the path uses. Model FLOPs come from the reference networks run
on the meta device under torch's FLOP counter: the matrix products,
convolutions and attention a layer needs, whatever implements it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM, dense: bf16 tensor cores; the 3xTF32 ceiling for the fp32
# kernel paths (TF32's 494.7 TFLOP/s over three products); HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 494.7e12 / 3
H100_BYTES_PER_S = 3.35e12


def _peak(fp32: bool) -> float:
    return H100_FP32_FLOPS if fp32 else H100_BF16_FLOPS


def _bound_ms(flops: float, nbytes: float, fp32: bool) -> float:
    return max(flops / _peak(fp32), nbytes / H100_BYTES_PER_S) * 1e3


def attention_bound_ms(b, sq, sk, h, d, fp32=False) -> float:
    """K1 / K4: q [b, sq, h, d] over k, v [b, sk, h, d]; QK^T and PV."""
    elem = 4 if fp32 else 2
    return _bound_ms(4 * b * h * sq * sk * d, (2 * b * sq + 2 * b * sk) * h * d * elem, fp32)


def packed_bound_ms(n, s, c, heads, fp32=False) -> float:
    """K2: self-attention of [n, s, c] on packed heads; q, k, v read, o written."""
    elem = 4 if fp32 else 2
    return _bound_ms(4 * n * s * s * c, 4 * n * s * c * elem, fp32)


def fused_qkv_bound_ms(n, s, c, fp32=False) -> float:
    """K3: four c x c projections and the s x s attention of [n, s, c]."""
    elem = 4 if fp32 else 2
    return _bound_ms(8 * n * s * c * c + 4 * n * s * s * c,
                     (2 * n * s * c + 4 * c * c + c) * elem, fp32)


BOUNDS = {"flash_attention": attention_bound_ms, "flash_attention_onepass": attention_bound_ms,
          "packed_attention": packed_bound_ms, "fused_qkv_attention": fused_qkv_bound_ms}


def launches_bound_ms(launches: dict) -> float:
    """The least time of every launch in {wrapper: {shape key: n}}."""
    total = 0.0
    for wrapper, by_shape in launches.items():
        for key, n in by_shape.items():
            fp32 = key[-1] == "fp32"
            dims = key[:-1] if fp32 else key
            total += n * BOUNDS[wrapper](*dims, fp32=fp32)
    return total


def count_flops(fn, *args) -> float:
    """FLOPs of fn(*args), run on the meta device."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
