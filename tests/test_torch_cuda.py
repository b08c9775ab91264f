"""The port's CUDA kernels against their plain versions, on a card.

Needs an NVIDIA GPU and nvcc; skips without them. The file imports neither
JAX nor the JAX package, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the largest relative L2 error of one output row (the d-vector of
one query and head), ||kernel - plain|| / ||plain||, at most 2e-2. Kernel and
plain version round the probabilities and the output to bf16 at different
points, a few 2^-8 relative. The same limit is held in chip_smoke.py, and
each case also checks that a planted fault (the last kv tile or key left
out, the softmax scale halved) exceeds it.
"""

import pytest
import torch

from moca_tpu_torch.ops import flash_attention as tfa

TOL = 2e-2


def max_row_rel_err(out, ref, d=64):
    """max over rows of ||out - ref|| / ||ref||, rows being d-vectors."""
    out, ref = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    ref_norm = ref.norm(dim=1)
    return ((out - ref).norm(dim=1) / ref_norm.clamp_min(1e-6 * ref_norm.max())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("flash", (2, 160, 4, 64)),    # one row tile per warp, ragged tail
    ("flash", (2, 640, 2, 64)),    # two row tiles per warp
    ("flash", (2, 200, 2, 128)),   # D = 128
    ("packed", (64, 16, 320)),     # C = 320 (5 heads)
    ("packed", (64, 8, 128)),      # S = 8, padded to a whole tile
    ("packed", (64, 24, 1280)),    # S = 24, two row tiles
])
def test_cuda_kernel_matches_plain(kernel, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    tfa.reset_launch_counts()
    d = shape[-1] if kernel == "flash" else 64
    if kernel == "flash":
        out, ref = tfa.flash_attention(q, k, v), tfa.attention_plain(q, k, v)
        assert sum(tfa.flash_attention.launches.values()) == 1
        cut = k.shape[1] - 64  # the last kv tile left out
        faults = (tfa.flash_attention(q, k[:, :cut].contiguous(), v[:, :cut].contiguous()),
                  tfa.flash_attention(q * 0.5, k, v))
    else:
        heads = shape[-1] // 64
        out = tfa.packed_attention(q, k, v, heads)
        ref = tfa.packed_attention_plain(q, k, v, heads)
        assert sum(tfa.packed_attention.launches.values()) == 1
        v_cut = v.clone()
        v_cut[:, -1] = 0  # the last key left out of the PV product
        faults = (tfa.packed_attention(q, k, v_cut, heads),
                  tfa.packed_attention(q * 0.5, k, v, heads))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert max_row_rel_err(out, ref, d) <= TOL
    for fault in faults:
        assert max_row_rel_err(fault, ref, d) > TOL


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q = torch.zeros(2, 160, 2, 64, device="cuda")  # fp32: no kernel, no fallback
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    p = torch.zeros(4, 16, 96, device="cuda", dtype=torch.bfloat16)  # d = 48
    with pytest.raises(ValueError, match="unsupported"):
        tfa.packed_attention(p, p, p, 2)
