"""Attention dispatch: hand-written CUDA kernels with the plain path beside.

Port of moca_tpu/ops/attention.py. The routing is the reference's
(`_use_pallas` :39-58, `use_packed_tiny` :61-76) with "the tensor lies on a
CUDA device" in place of "the backend is a TPU":

  * spatial self-attention with Sq, Sk >= 128 and d in {64, 128} -> K1;
  * tiny self-attention (temporal transformers, S <= 32, S % 8 == 0) -> K2;
  * everything the reference leaves to XLA takes the plain path, on the
    card as well: a bias, Sk < 128 (text cross-attention, kv = 77), the mid
    block's S = 40, and the rel-pos or causal branches.

The plain path is `_xla_attention`'s arithmetic: fp32 logits and softmax,
probabilities cast to v's type before the PV product. The reference's
opt-in fused QKV kernel (`use_fused_qkv`, off by default) is not ported.
"""

from __future__ import annotations

from moca_tpu_torch.ops import flash_attention as _flash
from moca_tpu_torch.ops.flash_attention import attention_plain as _plain_attention


def flash_shape_ok(sq: int, sk: int, d: int, bias) -> bool:
    """Shapes the reference sends to its flash kernel (`_use_pallas`)."""
    return bias is None and d in (64, 128) and sq >= 128 and sk >= 128


def packed_shape_ok(seq_len: int, kv_len: int, bias, channels: int) -> bool:
    """Shapes the reference sends to its packed tiny-S kernel."""
    return (bias is None and seq_len == kv_len and seq_len <= 32
            and seq_len % 8 == 0 and 0 < channels <= 1280)


def use_packed_tiny(q, seq_len: int, kv_len: int, bias, channels: int) -> bool:
    """Route a tiny self-attention through K2 (CUDA tensors only)."""
    return q.is_cuda and packed_shape_ok(seq_len, kv_len, bias, channels)


def packed_attention(q, k, v, heads: int):
    """[N, S, H*D] packed-heads attention (see flash_attention.packed_attention)."""
    return _flash.packed_attention(q, k, v, heads)


def dot_product_attention(q, k, v, bias=None):
    """Multi-head attention on [B, S, H, D] (heads in dim 2), fp32 softmax.

    K1 on CUDA tensors at the reference's flash shapes, else the plain path."""
    if q.is_cuda and flash_shape_ok(q.shape[1], k.shape[1], q.shape[-1], bias):
        return _flash.flash_attention(q, k, v)
    return _plain_attention(q, k, v, bias)
