// K1: fused attention of q [B, Sq, H, D] over k, v [B, Sk, H, D], bf16,
// D in {64, 128}.
//
// The fp32 path (`moca_flash_attention_f32`, csrc/attention_f32.cuh) takes
// fp32 q, k, v and returns fp32: the online softmax in 3xTF32 on the tensor
// cores, one design at every shape.
//
// Replaces the Pallas TPU kernels `_fa_kernel` (moca_tpu/ops/flash_attention.py:93,
// launched at :765 by `flash_attention`) and `_fa_small_kernel` (:223, launched at
// :298 by `_small_attention`). On the product path it serves the U-Net's spatial
// self-attention: S = 2560 (5 heads), 640 (10 heads) and 160 (20 heads), d = 64;
// and, as in the reference, text cross-attention whenever the context has at
// least 128 tokens (154 with a conditioned prompt).
//
// What bounds it on an H100: at S = 2560 the QK^T and PV products are 4*B*H*S^2*D
// operations against 4*B*S*H*D*2 bytes, i.e. ~1280 operations per byte, far
// above the card's ~295 bf16 operations per byte, so it is bound by tensor-core
// work and, as tightly at d = 64, by the S^2 exp2 evaluations on the SFU. At
// S = 160 and at kv = 154 it is bound by bytes.
//
// The softmax is the exact online max-shifted form in base 2: the running max
// is taken on the raw fp32 logits and exp2(s*scale*log2(e) - m) is one FFMA and
// one ex2.approx, with fp32 running max, denominator and output accumulator;
// the output is written once, in the input type.
//
// Two designs, chosen by shape in `plan` (moca_flash_attention_plan):
//   * wgmma (flash_hopper.cuh): TMA loads, a producer warpgroup and two
//     ping-ponged consumer warpgroups on wgmma, the softmax overlapped with
//     the products; 128 q rows a CTA, kv tiles of 64 or 128 rows.
//   * mma.sync (`flash_fwd` below): one block of 4 warps owns one (batch,
//     head, q tile); each warp owns MT m16 row tiles (MT = 2 for long q at
//     D = 64, else 1). K and V tiles of 64 rows are staged by 16-byte cp.async
//     copies, double buffered; QK^T and PV run on mma.sync m16n8k16; ragged
//     tails are zero-filled in shared memory and masked with -inf.
//
// The TPU's `nomax` and `guarded` softmax modes (flash_attention.py:64-90) are VPU
// economies whose output equals this exact form wherever it is finite; they and
// the guarded flag-and-rerun are not carried over. Neither is the TPU block
// policy (`_choose_flash_blocks`, the VMEM caps): tiles here are sized for
// Hopper's shared memory and registers.
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
    flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
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

  load_tile<D, C::BR>(sQ, qh, q0, Sq, rs, tid);
  load_tile<D, BC>(sK, kh, 0, Sk, rs, tid);
  load_tile<D, BC>(sV, vh, 0, Sk, rs, tid);
  cp_async_commit();

  uint32_t qf[MT][KSTEPS][4];
  float acc[MT][NT_O][4];
  float m[MT][2], l[MT][2];  // running max (scaled, base 2) and this lane's denominators
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NT_O; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int ntiles = (Sk + BC - 1) / BC;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile<D, BC>(sK + (buf ^ 1) * C::KV, kh, (j + 1) * BC, Sk, rs, tid);
      load_tile<D, BC>(sV + (buf ^ 1) * C::KV, vh, (j + 1) * BC, Sk, rs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldmatrix_x4(qf[mt][ks], frag_a_addr(sQ, LD, (warp * MT + mt) * 16, ks * 16, lane));
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

    const int kv0 = j * BC;
    const bool ragged = kv0 + BC > Sk;
    uint32_t pf[MT][NT_S][2];  // P as bf16 pairs: [.][nt][0] row g, [.][nt][1] row g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;  // raw logits: scale > 0 keeps the argmax
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ragged && kv0 + nt * 8 + 2 * t + e >= Sk) s[mt][nt][e] = s[mt][nt][2 + e] = -INFINITY;
          mx0 = fmaxf(mx0, s[mt][nt][e]);
          mx1 = fmaxf(mx1, s[mt][nt][2 + e]);
        }
      }
      const float mn0 = fmaxf(m[mt][0], quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m[mt][1], quad_max(mx1) * scale_log2);
      const float al0 = fast_exp2(m[mt][0] - mn0), al1 = fast_exp2(m[mt][1] - mn1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const float p00 = fast_exp2(fmaf(s[mt][nt][0], scale_log2, -mn0));
        const float p01 = fast_exp2(fmaf(s[mt][nt][1], scale_log2, -mn0));
        const float p10 = fast_exp2(fmaf(s[mt][nt][2], scale_log2, -mn1));
        const float p11 = fast_exp2(fmaf(s[mt][nt][3], scale_log2, -mn1));
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        pf[mt][nt][0] = pack_bf16(p00, p01);
        pf[mt][nt][1] = pack_bf16(p10, p11);
      }
      l[mt][0] = l[mt][0] * al0 + rs0;
      l[mt][1] = l[mt][1] * al1 + rs1;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        acc[mt][nt][0] *= al0;
        acc[mt][nt][1] *= al0;
        acc[mt][nt][2] *= al1;
        acc[mt][nt][3] *= al1;
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
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BR - 1) / C::BR, H, B);
  flash_fwd<D, MT><<<grid, WARPS * 32, C::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BN>
__global__ void __launch_bounds__(flash::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ flash::Maps maps, bf16* __restrict__ o, int B, int Sq,
                    int Sk, int H, float scale_log2) {
  flash::attention_fwd<D, BN, false>(maps, o, B, Sq, Sk, H, scale_log2);
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
      return flash::launch<64, 128>(flash_fwd_wgmma<64, 128>, q, k, v, o, B, Sq, Sk, H, scale_log2, s);
  }
  return flash::launch<D, 64>(flash_fwd_wgmma<D, 64>, q, k, v, o, B, Sq, Sk, H, scale_log2, s);
}

}  // namespace

extern "C" int moca_flash_attention_plan(int B, int Sq, int Sk, int H, int D) {
  return plan(B, Sq, Sk, H, D);
}

// path: as `plan` numbers them, or -1 for the plan's choice.
extern "C" int moca_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
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
extern "C" int moca_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                        int B, int Sq, int Sk, int H, int D, float scale_log2,
                                        int path, void* stream) {
  if (path >= 0) return static_cast<int>(cudaErrorInvalidValue);
  return f32::attention<false>(q, k, v, o, B, Sq, Sk, H, D, scale_log2,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
