"""Attention dispatch: hand-written CUDA kernels with the plain path beside.

Port of moca_tpu/ops/attention.py. The routing is the reference's
(`_use_pallas` :39-58, `use_packed_tiny` :61-76, `use_fused_qkv` :84-120 and
the one-pass branch of `flash_attention`, flash_attention.py:684-733) with
"the tensor lies on a CUDA device" in place of "the backend is a TPU":

  * spatial self-attention with Sq, Sk >= 128 and d in {64, 128} -> K1, or
    K4 with MOCA_TPU_FA_ONEPASS=1 where the reference takes its one-pass
    kernel (not the small-S path, and one kv block: `onepass_full_kv`);
  * tiny self-attention (temporal transformers, S <= 32, S % 8 == 0, any
    head width) -> K2, or, with MOCA_TPU_FA_FUSED_QKV, the projections, the
    attention and the out projection together -> K3 (`use_fused_qkv`,
    called by the U-Net);
  * everything the reference leaves to XLA takes the plain path, on the
    card as well: a bias, Sk < 128 (text cross-attention, kv = 77), the mid
    block's S = 40, and the rel-pos or causal branches.

Switches read, as the reference reads them, at call time: MOCA_TPU_FA_ONEPASS
("1" on) and MOCA_TPU_FA_FUSED_QKV ("0"/empty off, "1" on, or a list of
widths such as "320,512"). Not carried over: MOCA_TPU_FA_PACKED_LANE,
MOCA_TPU_FA_PACKED_SLICE and MOCA_TPU_FA_PACKEDQM pick between TPU layouts of
the one function that K2 computes once; the block-size knobs (MOCA_TPU_FA_BQ,
_BKV, _SMALL_CAP_MB, _LANE_NB, _PACKED_NB, _FUSED_NB) and the softmax modes
(MOCA_TPU_FA_SOFTMAX, _NOMAX) are TPU tuning whose output the exact kernels
here equal; and MOCA_TPU_NO_PALLAS would send a CUDA tensor to the plain path,
which the port never does.

The plain path is `_xla_attention`'s arithmetic: fp32 logits and softmax,
probabilities cast to v's type before the PV product.
"""

from __future__ import annotations

import os

from moca_tpu_torch.ops import flash_attention as _flash
from moca_tpu_torch.ops.flash_attention import attention_plain as _plain_attention

# fp32 logits-tile cap of the reference's whole-S / full-KV blocks
# (flash_attention.py:631), a TPU VMEM size; only used to decide where the
# reference runs its one-pass kernel, not a limit of the card
_WHOLE_S_CAP = 27 * 1024 * 1024


def flash_shape_ok(sq: int, sk: int, d: int, bias) -> bool:
    """Shapes the reference sends to its flash kernel (`_use_pallas`)."""
    return bias is None and d in (64, 128) and sq >= 128 and sk >= 128


def _pick_block(size: int, candidates) -> int:
    for c in candidates:
        if size % c == 0 and c <= size:
            return c
    return size


def onepass_full_kv(sq: int, sk: int) -> bool:
    """Does the reference's block policy give one kv block, bkv == sk?

    A copy of `_choose_flash_blocks(sq, sk, big_vmem=True)`
    (flash_attention.py:634-663) without its env overrides: big VMEM is the
    TPU compile option the reference's product path (`tuned_jit`) always has
    on. The reference takes its one-pass kernel exactly there.

    The caps (27 MB and 8 MB of fp32 logits) and the candidate blocks are
    the reference's TPU VMEM policy, kept only as its routing contract: they
    say where the reference runs its one-pass kernel, not what K4 can take
    on a Hopper card (K4 sweeps KV twice and has no cap on Sk)."""
    if sq * sk * 4 <= _WHOLE_S_CAP:
        bq = sq
    else:
        bq = _pick_block(sq, (640, 512, 256, 128, 64, 32, 16, 8))
    full_kv_cap = _WHOLE_S_CAP if bq == sq else 8 * 1024 * 1024
    if bq * sk * 4 <= full_kv_cap:
        return True
    return _pick_block(sk, (1280, 1024, 640, 512, 256, 128, 64, 32, 16, 8)) == sk


def use_onepass(sq: int, sk: int) -> bool:
    """With MOCA_TPU_FA_ONEPASS=1, a flash-shaped call that the reference
    neither sends to `_small_attention` (flash_attention.py:684) nor blocks
    over kv goes to K4."""
    if os.environ.get("MOCA_TPU_FA_ONEPASS", "0") != "1":
        return False
    if sq == sk and sq <= 640 and sq % 8 == 0:
        return False
    return onepass_full_kv(sq, sk)


def packed_shape_ok(seq_len: int, kv_len: int, bias, channels: int, heads: int) -> bool:
    """Shapes the reference sends to its packed tiny-S kernels
    (`use_packed_tiny`): every head count that divides C, as K2 takes any
    head width."""
    return (bias is None and seq_len == kv_len and seq_len <= 32
            and seq_len % 8 == 0 and 0 < channels <= 1280
            and heads > 0 and channels % heads == 0)


def use_packed_tiny(q, seq_len: int, kv_len: int, bias, channels: int, heads: int) -> bool:
    """Route a tiny self-attention through K2 (CUDA tensors only)."""
    return q.is_cuda and packed_shape_ok(seq_len, kv_len, bias, channels, heads)


def packed_attention(q, k, v, heads: int):
    """[N, S, H*D] packed-heads attention (see flash_attention.packed_attention)."""
    return _flash.packed_attention(q, k, v, heads)


def use_fused_qkv(x, seq_len: int, channels: int, heads: int, dim_head: int) -> bool:
    """Route a tiny-S self-attention through K3 (projections + attention +
    out projection), as the reference's `use_fused_qkv` (attention.py:84-120).

    Off unless MOCA_TPU_FA_FUSED_QKV is "1" or a list of widths that holds
    `channels`. Then for CUDA tensors only, with d = 64, inner == channels,
    S <= 32 and S % 8 == 0, and C = 320 or C % 128 == 0 up to 1280. The
    reference also gates C = 1280 on its big-VMEM compile option; that is a
    TPU compile option that its product path (`tuned_jit`) always has on, so
    it is not carried over."""
    sel = os.environ.get("MOCA_TPU_FA_FUSED_QKV", "0")
    if sel in ("0", ""):
        return False
    if sel != "1" and str(channels) not in [t.strip() for t in sel.split(",")]:
        return False
    if not x.is_cuda:
        return False
    if dim_head != 64 or heads * dim_head != channels:
        return False
    if not (seq_len <= 32 and seq_len % 8 == 0):
        return False
    return channels == 320 or (channels % 128 == 0 and channels <= 1280)


def fused_qkv_attention(x, wq, wk, wv, wo, bo, heads: int):
    """See flash_attention.fused_qkv_attention (weights in nn.Linear layout)."""
    return _flash.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)


def dot_product_attention(q, k, v, bias=None):
    """Multi-head attention on [B, S, H, D] (heads in dim 2), fp32 softmax.

    K1 (or K4, see `use_onepass`) on CUDA tensors at the reference's flash
    shapes, else the plain path."""
    sq, sk = q.shape[1], k.shape[1]
    if q.is_cuda and flash_shape_ok(sq, sk, q.shape[-1], bias):
        if use_onepass(sq, sk):
            return _flash.flash_attention_onepass(q, k, v)
        return _flash.flash_attention(q, k, v)
    return _plain_attention(q, k, v, bias)
