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
// path (6*... for K4), at S = 2560 bound by operations. Plain TF32 products
// would round each input to a 2^-11 unit and miss the fp32 path's 1e-4 limit.
// The fastest unit that keeps fp32 accuracy is the tensor cores in 3xTF32:
// each operand x is split into x = hi + lo with hi a tf32 value, and
// hi*hi + hi*lo + lo*hi (the lo*lo term is below fp32's unit) is summed in
// fp32 accumulators, within ~2^-21 of an fp32 product, at a ceiling of the
// dense TF32 peak over three (494.7/3 TFLOP/s), 2.5x the FP32 FFMA peak.
//
// The design, FlashAttention-2 style on mma.sync.m16n8k8 (`tf32x3_fwd`):
//
// A CTA of 4 warps owns 16 * MT q rows a warp of one (batch, head): MT = 2 at
// D = 64 once Sq >= 512, else 1. K and V tiles of 64 rows are copied by
// 16-byte cp.async into a double-buffered ring, raw fp32.
//
// The split. Every operand is split where its fragment is loaded: q (read
// through L1 at every tile and scaled there, which frees the 32 * MT registers
// it would hold) once per pair of k8 steps, K and V per fragment, p from the
// softmax's C fragments. Split at the fragment rather than once per tile into
// hi and lo tiles: those would double the ring's shared memory and every
// fragment load, and add a pass and a barrier per tile. The split is
// `split_tf32` in mma.cuh (beside `mma_3xtf32`): three instructions, two of
// them on the integer pipe; cvt.rna.tf32.f32 for hi and for lo ran slower on
// an H100, and so did Veltkamp's split (four FP32 instructions), which this
// path took first.
//
// Fragment layouts of m16n8k8.tf32 (g = lane / 4, t = lane % 4): A a0 (g, k t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C
// (g, 2t..2t+1), (g+8, 2t..2t+1). They are loaded with plain loads (ldmatrix is
// b16). The sum over d is taken in any order, so for QK^T the k index of a pair
// of k8 steps is relabelled onto d columns 16j + 4t .. 4t + 3: one 16-byte load
// gives a lane both steps' q and K fragments. For PV the C fragment of P
// (columns 2t, 2t+1) is the A fragment with k = t taken as kv row 2t and
// k = t + 4 as kv row 2t + 1, and b0, b1 read V's rows 2t and 2t + 1 to match:
// no shuffle. K rows are padded to D + 16 floats (16-byte loads, a quarter-warp's
// 8 lanes on two rows 16 banks apart), V rows to D + 4 (4-byte loads, rows 2t
// apart land 8t banks apart): no bank conflicts.
//
// The softmax runs on the C fragments, a row's max and sum over its four lanes,
// exp2 on the SFU (ex2.approx, ~2^-22 relative). Both of K4's sweeps compute
// the same logits with the same instructions, so s - max <= 0 holds exactly.
//
// Rows past Sk are zero-filled and their logits masked with -inf;
// rows past Sq compute on a clamped row and are not stored.
#pragma once

#include "mma.cuh"

namespace moca {
namespace f32 {

constexpr int THREADS = 128;

// Rows [row0, row0 + ROWS) of one head of a [.., S, H, D] fp32 tensor into
// shared [ROWS][LD]; rows at or past S are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* head, int row0, int S,
                                          long long row_stride, int tid) {
  constexpr int CH = D / 4;
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    float* d = dst + r * LD + col;
    if (row0 + r < S) {
      cp_async16(d, head + static_cast<long long>(row0 + r) * row_stride + col);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int TC_BN = 64;  // kv rows a tile

template <int D, int MT>
struct TcCfg {
  static constexpr int BR = 4 * 16 * MT;  // q rows a CTA (4 warps of MT m16 row tiles)
  static constexpr int LDK = D + 16;      // K row stride (floats)
  static constexpr int LDV = D + 4;       // V row stride
  static constexpr int KT = TC_BN * LDK;  // floats of one K tile
  static constexpr int VT = TC_BN * LDV;
  static constexpr int BYTES = 2 * (KT + VT) * static_cast<int>(sizeof(float));  // 2 stages
};

template <int D, int MT, bool ONEPASS>
__global__ void __launch_bounds__(THREADS)
    tf32x3_fwd(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
               float scale_log2) {
  using C = TcCfg<D, MT>;
  constexpr int KP = D / 16;     // pairs of k8 steps over D (QK^T)
  constexpr int NS = TC_BN / 8;  // n8 tiles of logits a row tile = k8 steps of PV
  constexpr int NO = D / 8;      // n8 tiles of output
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;        // [2][BN][LDK]
  float* sV = sK + 2 * C::KT;  // [2][BN][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * C::BR + warp * 16 * MT;  // this warp's first q row
  const long long rs = static_cast<long long>(H) * D;
  const float* kh = k + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  const float* vh = v + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  const float* qh = q + static_cast<long long>(b) * Sq * rs + static_cast<long long>(h) * D;
  float* oh = o + static_cast<long long>(b) * Sq * rs + static_cast<long long>(h) * D;

  const int ntiles = (Sk + TC_BN - 1) / TC_BN;
  const int steps = ONEPASS ? 2 * ntiles : ntiles;
  auto issue = [&](int i) {  // step i: sweep i / ntiles, kv tile i % ntiles
    const int buf = i & 1, row0 = (i % ntiles) * TC_BN;
    load_rows<D, C::LDK, TC_BN>(sK + buf * C::KT, kh, row0, Sk, rs, tid);
    if (!ONEPASS || i >= ntiles) load_rows<D, C::LDV, TC_BN>(sV + buf * C::VT, vh, row0, Sk, rs, tid);
    cp_async_commit();
  };
  issue(0);

  // This lane's q: rows r0 + 16 mt + 8 r + g, columns 16 j + 4 t .. + 3 (k = t,
  // t + 4 of step 2j, then of step 2j + 1), read through L1 at every tile and
  // scaled there: held in registers it would take 32 * MT of them.
  const float* qrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qrow[mt][r] = qh + static_cast<long long>(min(r0 + 16 * mt + 8 * r + g, Sq - 1)) * rs + 4 * t;

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // row max (of the whole row: after quad_max) and this lane's row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + (i & 1) * C::KT;
    const float* cV = sV + (i & 1) * C::VT;
    const int kv0 = (i % ntiles) * TC_BN;

    // s = q k^T on this tile, 3xTF32
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      Frag<4> a[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 x0 = __ldg(reinterpret_cast<const float4*>(qrow[mt][0] + 16 * j));
        const float4 x1 = __ldg(reinterpret_cast<const float4*>(qrow[mt][1] + 16 * j));
        const float s0[4] = {x0.x * scale_log2, x1.x * scale_log2, x0.y * scale_log2,
                             x1.y * scale_log2};
        const float s1[4] = {x0.z * scale_log2, x1.z * scale_log2, x0.w * scale_log2,
                             x1.w * scale_log2};
        a[mt][0] = split(s0);
        a[mt][1] = split(s1);
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float4 y = *reinterpret_cast<const float4*>(cK + (nt * 8 + g) * C::LDK + 16 * j + 4 * t);
        const float y0[2] = {y.x, y.y}, y1[2] = {y.z, y.w};
        const Frag<2> b0 = split(y0), b1 = split(y1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(s[mt][nt], a[mt][0], b0);
          mma_3xtf32(s[mt][nt], a[mt][1], b1);
        }
      }
    }
    if (kv0 + TC_BN > Sk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kv0 + nt * 8 + 2 * t + e >= Sk) s[mt][nt][e] = s[mt][nt][2 + e] = -INFINITY;
    }

    if (ONEPASS && i < ntiles) {  // sweep 1: the row max alone
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          m[mt][0] = fmaxf(m[mt][0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
          m[mt][1] = fmaxf(m[mt][1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
        }
        if (i == ntiles - 1) {  // the end of sweep 1: the max over the row's four lanes
          m[mt][0] = quad_max(m[mt][0]);
          m[mt][1] = quad_max(m[mt][1]);
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (!ONEPASS) {  // online softmax: a new max rescales what came before
          float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
          for (int nt = 0; nt < NS; ++nt) {
            mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
          }
          mx0 = quad_max(mx0);
          mx1 = quad_max(mx1);
          // the first tile: exp2(-inf) = 0
          const float al0 = fast_exp2(m[mt][0] - mx0), al1 = fast_exp2(m[mt][1] - mx1);
          m[mt][0] = mx0;
          m[mt][1] = mx1;
          l[mt][0] *= al0;
          l[mt][1] *= al1;
#pragma unroll
          for (int nt = 0; nt < NO; ++nt) {
            acc[mt][nt][0] *= al0;
            acc[mt][nt][1] *= al0;
            acc[mt][nt][2] *= al1;
            acc[mt][nt][3] *= al1;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          s[mt][nt][0] = fast_exp2(s[mt][nt][0] - m[mt][0]);
          s[mt][nt][1] = fast_exp2(s[mt][nt][1] - m[mt][0]);
          s[mt][nt][2] = fast_exp2(s[mt][nt][2] - m[mt][1]);
          s[mt][nt][3] = fast_exp2(s[mt][nt][3] - m[mt][1]);
          l[mt][0] += s[mt][nt][0] + s[mt][nt][1];
          l[mt][1] += s[mt][nt][2] + s[mt][nt][3];
        }
      }
      // acc += p v, 3xTF32; k8 step kk is the logits' n8 tile kk
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        Frag<4> a[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float p[4] = {s[mt][kk][0], s[mt][kk][2], s[mt][kk][1], s[mt][kk][3]};
          a[mt] = split(p);
        }
        const float* v0 = cV + (kk * 8 + 2 * t) * C::LDV + g;
#pragma unroll
        for (int dt = 0; dt < NO; ++dt) {
          const float y[2] = {v0[dt * 8], v0[C::LDV + dt * 8]};
          const Frag<2> bv = split(y);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][dt], a[mt], bv);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * mt + 8 * r + g;
      const float inv = 1.f / quad_sum(l[mt][r]);
      if (row < Sq) {
        float* orow = oh + static_cast<long long>(row) * rs + 2 * t;
#pragma unroll
        for (int dt = 0; dt < NO; ++dt)
          *reinterpret_cast<float2*>(orow + dt * 8) =
              make_float2(acc[mt][dt][2 * r] * inv, acc[mt][dt][2 * r + 1] * inv);
      }
    }
}

template <int D, int MT, bool ONEPASS>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                  int H, float scale_log2, cudaStream_t stream) {
  using C = TcCfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(tf32x3_fwd<D, MT, ONEPASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BR - 1) / C::BR, H, B);
  tf32x3_fwd<D, MT, ONEPASS><<<grid, THREADS, C::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// D in {64, 128}, Sq, Sk >= 1.
template <bool ONEPASS>
int attention(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
              int D, float scale_log2, cudaStream_t s) {
  if (Sq <= 0 || Sk <= 0 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  // Two row tiles a warp (128 q rows a CTA) once the q tile is mostly full;
  // at D = 128 their accumulators would not fit in the registers.
  if (D == 128) return launch_tf32x3<128, 1, ONEPASS>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  return Sq >= 512 ? launch_tf32x3<64, 2, ONEPASS>(q, k, v, o, B, Sq, Sk, H, scale_log2, s)
                   : launch_tf32x3<64, 1, ONEPASS>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
}

}  // namespace f32
}  // namespace moca
