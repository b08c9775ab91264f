// The fp32 path of K1 (csrc/flash_attention.cu) and K4 (csrc/flash_onepass.cu):
// attention of q [B, Sq, H, D] over k, v [B, Sk, H, D], float32 in and out,
// D in {64, 128}.
//
// What it computes is what the Pallas bodies `_fa_kernel`
// (moca_tpu/ops/flash_attention.py:93) and `_fa_onepass_kernel` (:184) compute
// on fp32 refs: q scaled by scale*log2(e) in fp32 (the cast back to the refs'
// type is then exact); fp32 logits; base-2 exponents; p kept in fp32 (v's
// type) for PV with fp32 accumulation; the output divided by the fp32 row sum.
// K1 takes the online softmax (running max, rescale of the row sum and the
// accumulator at every kv tile); K4 (ONEPASS) sweeps KV twice, the first for
// the row max alone, the second for exp2(s - max), the row sum and PV with
// no rescale.
//
// What bounds it on an H100: the same 4*B*H*Sq*Sk*D operations as the bf16
// path (6*... for K4), here on the FP32 pipes (67 TFLOP/s of FFMA) instead of
// the tensor cores: at S = 2560 it is bound by operations. Plain TF32 would
// round the products to a 2^-11 unit and miss the fp32 path's 1e-4 limit, so
// every product is a scalar FFMA.
//
// Design, simple first. A CTA of 128 threads owns 128 q rows of one (batch,
// head) at D = 64, 64 rows at D = 128; a thread owns 64 dimensions of one row
// (two threads a row at D = 128, their partial logits summed by a shuffle):
// its scaled q and its output accumulator in registers, in float4 chunks that
// interleave with the row's other thread so that the pair reads neighbouring
// 16 bytes of shared memory. K and V tiles of 32 rows are copied by 16-byte
// cp.async into a double-buffered ring; every thread reads the same kv row at
// once (a broadcast), 4 FFMAs a 16-byte read. Rows past Sk are zero-filled
// and their logits masked with -inf; rows past Sq compute on a clamped row
// and are not stored.
#pragma once

#include "mma.cuh"

namespace moca {
namespace f32 {

constexpr int THREADS = 128;
constexpr int BN = 32;  // kv rows a tile

template <int D>
struct AttnCfg {
  static constexpr int TPR = D / 64;          // threads a q row
  static constexpr int ROWS = THREADS / TPR;  // q rows a CTA
  static constexpr int TILE = BN * D;         // floats of one K or V tile
  static constexpr int BYTES = 4 * TILE * static_cast<int>(sizeof(float));  // K, V x 2 stages
};

// Rows [row0, row0 + BN) of one head of a [.., S, H, D] fp32 tensor into
// shared [BN][D]; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv_tile(float* dst, const float* head, int row0, int S,
                                             long long row_stride, int tid) {
  constexpr int CH = D / 4;
  for (int c = tid; c < BN * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    float* d = dst + r * D + col;
    if (row0 + r < S) {
      cp_async16(d, head + static_cast<long long>(row0 + r) * row_stride + col);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int D, bool ONEPASS>
__global__ void __launch_bounds__(THREADS)
    attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                  float scale_log2) {
  using C = AttnCfg<D>;
  constexpr int TPR = C::TPR;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;             // [2][BN][D]
  float* sV = sK + 2 * C::TILE;     // [2][BN][D]

  const int tid = threadIdx.x, part = tid % TPR;
  const int row = blockIdx.x * C::ROWS + tid / TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const float* kh = k + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  const float* vh = v + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  const long long qoff = (static_cast<long long>(b) * Sq + min(row, Sq - 1)) * rs +
                         static_cast<long long>(h) * D;

  const int ntiles = (Sk + BN - 1) / BN;
  const int steps = ONEPASS ? 2 * ntiles : ntiles;
  auto issue = [&](int i) {  // step i: sweep i / ntiles, kv tile i % ntiles
    const int buf = i & 1, row0 = (i % ntiles) * BN;
    load_kv_tile<D>(sK + buf * C::TILE, kh, row0, Sk, rs, tid);
    if (!ONEPASS || i >= ntiles) load_kv_tile<D>(sV + buf * C::TILE, vh, row0, Sk, rs, tid);
    cp_async_commit();
  };
  issue(0);

  float4 qr[16], acc[16];  // chunk c holds dimensions 4 * (part + TPR * c) .. + 3
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(q + qoff + 4 * (part + TPR * c));
    qr[c] = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2, x.w * scale_log2);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + (i & 1) * C::TILE;
    const float* cV = sV + (i & 1) * C::TILE;
    const int kv0 = (i % ntiles) * BN;

    float s[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 4 * (part + TPR * c);
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(cK + j * D + col);
        s[j] = fmaf(qr[c].x, kk.x, s[j]);
        s[j] = fmaf(qr[c].y, kk.y, s[j]);
        s[j] = fmaf(qr[c].z, kk.z, s[j]);
        s[j] = fmaf(qr[c].w, kk.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      if (TPR == 2) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      if (kv0 + j >= Sk) s[j] = -INFINITY;
    }

    if (ONEPASS && i < ntiles) {  // sweep 1: the row max alone
#pragma unroll
      for (int j = 0; j < BN; ++j) m = fmaxf(m, s[j]);
    } else {
      if (!ONEPASS) {  // online softmax: a new max rescales what came before
        float mn = m;
#pragma unroll
        for (int j = 0; j < BN; ++j) mn = fmaxf(mn, s[j]);
        const float al = exp2f(m - mn);  // the first tile: exp2(-inf) = 0
        l *= al;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          acc[c].x *= al;
          acc[c].y *= al;
          acc[c].z *= al;
          acc[c].w *= al;
        }
        m = mn;
      }
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        const float p = exp2f(s[j] - m);
        l += p;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(cV + j * D + 4 * (part + TPR * c));
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  if (row < Sq) {
    const float inv = 1.f / l;
    float* orow = o + qoff;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      *reinterpret_cast<float4*>(orow + 4 * (part + TPR * c)) =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
  }
}

template <int D, bool ONEPASS>
int launch_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                     int H, float scale_log2, cudaStream_t stream) {
  using C = AttnCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd<D, ONEPASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::ROWS - 1) / C::ROWS, H, B);
  attention_fwd<D, ONEPASS><<<grid, THREADS, C::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The C entry points' body: D in {64, 128}, Sq, Sk >= 1.
template <bool ONEPASS>
int attention(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
              int D, float scale_log2, cudaStream_t s) {
  if (Sq <= 0 || Sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch_attention<64, ONEPASS>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  if (D == 128) return launch_attention<128, ONEPASS>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace f32
}  // namespace moca
