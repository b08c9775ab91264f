// K4: one-pass attention of q [B, Sq, H, D] over k, v [B, Sk, H, D], bf16,
// D in {64, 128}: the row max is known before any exponent is taken, and
// nothing is rescaled.
//
// The fp32 path (`moca_flash_onepass_f32`, csrc/attention_f32.cuh) takes
// fp32 q, k, v and returns fp32: the same two sweeps in 3xTF32 on the tensor
// cores, one design at every shape.
//
// Replaces the Pallas TPU kernel `_fa_onepass_kernel`
// (moca_tpu/ops/flash_attention.py:184, launched at :713 by `flash_attention`
// when MOCA_TPU_FA_ONEPASS=1 and the TPU block policy gives one kv block). On
// the product path with that switch it serves spatial self-attention at
// S = 2560 (5 heads) and the text cross-attention at kv = 154 for Sq = 2560,
// 640 and 160 (5, 10 and 20 heads), d = 64.
//
// What the Pallas body computes, and this kernel with it: q is scaled by
// scale*log2(e) in fp32 and rounded back to the input type; s = q k^T in fp32;
// p = exp2(s - max_row(s)) over the whole row; o = (p in the input type) v,
// accumulated in fp32, divided by sum_row(p) (fp32) and rounded once.
//
// What bounds it on an H100: as K1 (csrc/flash_attention.cu), tensor-core work
// and the exp2 evaluations at S = 2560, bytes at kv = 154. Two sweeps over KV
// do QK^T twice, 1.5x K1's operations (6*B*H*Sq*Sk*D against 4*B*H*Sq*Sk*D);
// sweep 2 takes no rescale.
//
// Two sweeps over KV inside one CTA rather than the logits on chip: the TPU
// kernel holds a [bq, Sk] fp32 logits tile in its many-megabyte VMEM; here a
// 64-row tile's logits at Sk = 2560 are 640 KB, more than an SM's shared
// memory. A cluster design that held them in distributed shared memory (QK^T
// once) ran 1.5-2.2x slower than two sweeps at every main-path shape on an
// H100 (PERF.md section 6) and was removed. Sweep 1 streams K tiles and keeps
// each row's max in registers (no exponent is taken); sweep 2 streams K and V
// tiles, recomputes QK^T, takes exp2(s - max) with the final max, and
// accumulates the row sum and PV with no rescale. No cap on Sk.
//
// Two designs, chosen by shape in `plan` (moca_flash_onepass_plan):
//   * wgmma (flash_hopper.cuh, ONEPASS): both sweeps on K1's Hopper pipeline,
//     TMA loads, a producer warpgroup and two ping-ponged consumer
//     warpgroups; the scaled q is rounded in shared memory before the first
//     wgmma reads it. Sweep 1 is QK^T alone, a third of the products and no
//     exponent, so K4 costs about 1.1x the new K1 at S = 2560 and runs in
//     about 0.6x the mma.sync kernel's time there; at kv = 154 it is faster
//     than that kernel for Sq >= 384 (PERF.md section 6).
//   * mma.sync (`onepass_fwd` below): one block of 4 warps per (batch, head,
//     q tile), each warp MT m16 row tiles, 64-row kv tiles double buffered by
//     16-byte cp.async copies (one pipeline across both sweeps), mma.sync
//     m16n8k16, P fed from the QK^T accumulators as the A fragments of PV, V
//     read with ldmatrix.trans, ragged tails zero-filled and masked with -inf.
//     The q scale is applied to the q fragments in registers.
#include "attention_f32.cuh"
#include "flash_hopper.cuh"
#include "mma.cuh"

using namespace moca;

namespace {

constexpr int BC = 64;  // kv rows per tile
constexpr int WARPS = 4;
constexpr int PAD = 8;  // row padding (bf16) that keeps ldmatrix free of bank conflicts

template <int D, int MT>
struct Cfg {
  static constexpr int BR = WARPS * 16 * MT;  // q rows per block
  static constexpr int LD = D + PAD;
  static constexpr int Q = BR * LD;
  static constexpr int KV = BC * LD;
  static constexpr int BYTES = (Q + 4 * KV) * static_cast<int>(sizeof(bf16));  // Q + 2 x (K, V)
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 pair times s in fp32, rounded back to bf16 (the Pallas body's q scale).
__device__ __forceinline__ uint32_t scale_pair(uint32_t r, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return pack_bf16(f.x * s, f.y * s);
}

// Rows [row0, row0 + ROWS) of one head of a [.., S, H, D] tensor into shared
// [ROWS][D + PAD]; rows at or past S are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* head, int row0, int S,
                                          long long row_stride, int tid) {
  constexpr int CH = D / 8;
  constexpr int LD = D + PAD;
  for (int c = tid; c < ROWS * CH; c += WARPS * 32) {
    const int r = c / CH, col = (c % CH) * 8;
    bf16* d = dst + r * LD + col;
    if (row0 + r < S) {
      cp_async16(d, head + static_cast<long long>(row0 + r) * row_stride + col);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(WARPS * 32)
    onepass_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                bf16* __restrict__ o, int Sq, int Sk, int H, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cfg<D, MT>;
  constexpr int LD = C::LD;
  constexpr int KSTEPS = D / 16;  // k16 steps of QK^T
  constexpr int NT_S = BC / 8;    // n8 tiles of logits per row tile
  constexpr int NT_O = D / 8;     // n8 tiles of output per row tile

  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + C::Q;
  bf16* sV = sK + 2 * C::KV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * C::BR, h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const bf16* qh = q + static_cast<long long>(b) * Sq * rs + static_cast<long long>(h) * D;
  const bf16* kh = k + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  const bf16* vh = v + static_cast<long long>(b) * Sk * rs + static_cast<long long>(h) * D;
  bf16* oh = o + static_cast<long long>(b) * Sq * rs + static_cast<long long>(h) * D;

  const int ntiles = (Sk + BC - 1) / BC;
  const int steps = 2 * ntiles;  // step j < ntiles: sweep 1 on kv tile j; else sweep 2 on j - ntiles
  // K tile of a step (and its V tile in sweep 2) into buffer `buf`
  auto fetch = [&](int step, int buf) {
    const int j = step < ntiles ? step : step - ntiles;
    load_tile<D, BC>(sK + buf * C::KV, kh, j * BC, Sk, rs, tid);
    if (step >= ntiles) load_tile<D, BC>(sV + buf * C::KV, vh, j * BC, Sk, rs, tid);
  };
  load_tile<D, C::BR>(sQ, qh, q0, Sq, rs, tid);
  fetch(0, 0);
  cp_async_commit();

  uint32_t qf[MT][KSTEPS][4];
  float acc[MT][NT_O][4];
  float m[MT][2], l[MT][2];  // row max (base-2 logits; this lane's part until sweep 1 ends), denominators
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NT_O; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      fetch(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          ldmatrix_x4(qf[mt][ks], frag_a_addr(sQ, LD, (warp * MT + mt) * 16, ks * 16, lane));
#pragma unroll
          for (int r = 0; r < 4; ++r) qf[mt][ks][r] = scale_pair(qf[mt][ks][r], scale_log2);
        }
    }
    const bf16* cK = sK + buf * C::KV;
    const bf16* cV = sV + buf * C::KV;

    float s[MT][NT_S][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NT_S; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, frag_bt_addr(cK, LD, np * 16, ks * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(s[mt][2 * np], qf[mt][ks], bk[0], bk[1]);
          mma_16816(s[mt][2 * np + 1], qf[mt][ks], bk[2], bk[3]);
        }
      }
    }

    const bool sweep1 = step < ntiles;
    const int kv0 = (sweep1 ? step : step - ntiles) * BC;
    if (kv0 + BC > Sk) {  // ragged last tile
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kv0 + nt * 8 + 2 * t + e >= Sk) s[mt][nt][e] = s[mt][nt][2 + e] = -INFINITY;
    }

    if (sweep1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          m[mt][0] = fmaxf(m[mt][0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
          m[mt][1] = fmaxf(m[mt][1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
        }
        if (step == ntiles - 1) {  // the whole row seen: combine the four lanes of a row
          m[mt][0] = quad_max(m[mt][0]);
          m[mt][1] = quad_max(m[mt][1]);
        }
      }
    } else {
      uint32_t pf[MT][NT_S][2];  // P as bf16 pairs: [.][nt][0] row g, [.][nt][1] row g + 8
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          const float p00 = fast_exp2(s[mt][nt][0] - m[mt][0]);
          const float p01 = fast_exp2(s[mt][nt][1] - m[mt][0]);
          const float p10 = fast_exp2(s[mt][nt][2] - m[mt][1]);
          const float p11 = fast_exp2(s[mt][nt][3] - m[mt][1]);
          l[mt][0] += p00 + p01;
          l[mt][1] += p10 + p11;
          pf[mt][nt][0] = pack_bf16(p00, p01);
          pf[mt][nt][1] = pack_bf16(p10, p11);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < NT_O / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, frag_a_addr(cV, LD, kk * 16, dp * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a[4] = {pf[mt][2 * kk][0], pf[mt][2 * kk][1], pf[mt][2 * kk + 1][0],
                                   pf[mt][2 * kk + 1][1]};
            mma_16816(acc[mt][2 * dp], a, bv[0], bv[1]);
            mma_16816(acc[mt][2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // Epilogue: normalise, stage this warp's rows in its (consumed) part of sQ,
  // then write 16-byte chunks of whole rows.
  bf16* so = sQ + warp * MT * 16 * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float inv0 = 1.f / quad_sum(l[mt][0]), inv1 = 1.f / quad_sum(l[mt][1]);
    bf16* st = so + mt * 16 * LD;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      *reinterpret_cast<uint32_t*>(st + g * LD + nt * 8 + 2 * t) =
          pack_bf16(acc[mt][nt][0] * inv0, acc[mt][nt][1] * inv0);
      *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + nt * 8 + 2 * t) =
          pack_bf16(acc[mt][nt][2] * inv1, acc[mt][nt][3] * inv1);
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int c = lane; c < MT * 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * 8;
    const int row = q0 + warp * MT * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(oh + static_cast<long long>(row) * rs + col) =
          *reinterpret_cast<const uint4*>(so + r * LD + col);
  }
}

template <int D, int MT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(onepass_fwd<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BR - 1) / C::BR, H, B);
  onepass_fwd<D, MT><<<grid, WARPS * 32, C::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BN>
__global__ void __launch_bounds__(flash::THREADS, 1)
    onepass_fwd_wgmma(const __grid_constant__ flash::Maps maps, bf16* __restrict__ o, int B, int Sq,
                      int Sk, int H, float scale_log2) {
  flash::attention_fwd<D, BN, true>(maps, o, B, Sq, Sk, H, scale_log2);
}

// Paths (ATTENTION_PATHS in ops/flash_attention.py): 0 mma.sync, 1 wgmma with
// 64-row kv tiles, 2 wgmma with 128-row kv tiles. The choice follows the
// designs' times on an H100 (PERF.md section 6): a q of under 3 tiles of
// 128 rows over a short kv row (S = 160) is bound by bytes and wastes a third
// or more of the wgmma design's rows, where mma.sync takes 64-row tiles; over
// a long kv row (Sq = 128, Sk = 8192) the products win again. A short kv row
// computes fewer masked keys in 64-row tiles; long rows run faster on
// 128-row tiles.
// D = 128 (no main-path shape) takes 64-row tiles only: its 128-row tiles
// need more registers than a consumer has.
int plan(int B, int Sq, int Sk, int H, int D) {
  (void)B;
  (void)H;
  if (Sq < 3 * flash::ROWS && Sk <= 256) return 0;
  return Sk <= 256 || D == 128 ? 1 : 2;
}

template <int D>
int launch_wgmma(int path, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                 int Sk, int H, float scale_log2, cudaStream_t s) {
  if constexpr (D == 64) {
    if (path == 2)
      return flash::launch<64, 128>(onepass_fwd_wgmma<64, 128>, q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  }
  return flash::launch<D, 64>(onepass_fwd_wgmma<D, 64>, q, k, v, o, B, Sq, Sk, H, scale_log2, s);
}

}  // namespace

extern "C" int moca_flash_onepass_plan(int B, int Sq, int Sk, int H, int D) {
  return plan(B, Sq, Sk, H, D);
}

// path: as `plan` numbers them, or -1 for the plan's choice.
extern "C" int moca_flash_onepass(const void* q, const void* k, const void* v, void* o, int B,
                                  int Sq, int Sk, int H, int D, float scale_log2, int path,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (path < 0) path = plan(B, Sq, Sk, H, D);
  if (path == 0) {
    // Two row tiles per warp pay off once the q tile is mostly full (the
    // 128-row tile wastes a third of its work at Sq = 160).
    if (D == 128) return launch<128, 1>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
    return Sq >= 512 ? launch<64, 2>(q, k, v, o, B, Sq, Sk, H, scale_log2, s)
                     : launch<64, 1>(q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  }
  if (path > 2) return static_cast<int>(cudaErrorInvalidValue);
  return D == 128 ? launch_wgmma<128>(path, q, k, v, o, B, Sq, Sk, H, scale_log2, s)
                  : launch_wgmma<64>(path, q, k, v, o, B, Sq, Sk, H, scale_log2, s);
}

// The fp32 path: fp32 q, k, v and o, one design (path must be -1).
extern "C" int moca_flash_onepass_f32(const void* q, const void* k, const void* v, void* o, int B,
                                      int Sq, int Sk, int H, int D, float scale_log2, int path,
                                      void* stream) {
  if (path >= 0) return static_cast<int>(cudaErrorInvalidValue);
  return f32::attention<true>(q, k, v, o, B, Sq, Sk, H, D, scale_log2,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
