// K2: tiny-sequence self-attention on packed heads, [N, S, H*d] bf16 or fp32,
// S in {8, 16, 24, 32}, any head width d.
//
// Replaces the Pallas TPU kernels `_packed_slice_kernel`
// (moca_tpu/ops/flash_attention.py:359, launched at :614 by `packed_attention`),
// `_packed_lane_kernel` (:385, launched at :559 by `_packed_lane_attention`) and
// `_packed_tiny_kernel` (:320, launched at :614). On the product path it serves
// the temporal transformers: S = 16 frames over N = batch*height*width pixel
// rows, d = 64 at C = 320 (5 heads), 512 (the 8-head init attention), 640 and
// 1280. A U-Net built with another head width (`num_head_channels`, any
// positive integer) gives it that d, as it gives the reference's
// `_packed_tiny_kernel`, which takes every width.
//
// What bounds it on an H100: one (row, head) problem is 4*S*S*d operations
// against 4*S*d*itemsize bytes, S/2 operations per byte in bf16 (8 at S = 16)
// and S/4 in fp32, at any d, so it is bound by bytes: one read of q, k and v
// and one write of o is the floor (four [40960, 16, 320] bf16 tensors, 1.68
// GB, ~0.50 ms, at C = 320).
//
// Two designs, chosen by head width in `plan` (moca_packed_attention_plan),
// which the wrapper's private `_packed_call` may override, for timing.
//
// The head-tile design (`packed_fwd<S, DP>`, d % 8 == 0 and d <= 128): one
// warp owns one (row, head) problem. It copies the head's d contiguous
// channels at offset h*d of each of the S rows of q, k and v into shared
// memory with 16-byte cp.async copies; consecutive lanes take consecutive
// 16-byte chunks of a row, so at d = 64 every warp-wide copy moves four whole
// 128-byte rows and the traffic is coalesced. Where d % 16 != 0 the row is
// zero-padded to the next multiple of 16 (DP), the mma depth: the padded
// columns add nothing to QK^T and give zero output columns that are not
// stored. QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate); the S x S logits stay in registers and the softmax is
// exact in fp32, normalised before PV as the Pallas bodies do. The output is
// staged through shared memory and written as whole rows. The lane-slice and
// lane-mask tricks of the TPU kernels work around Mosaic's lane layout and
// have no counterpart here. A head row at another width is not a whole number
// of aligned 16-byte chunks, so this design cannot copy it.
//
// The span design (`span_narrow`, `span_wide`, any d) is in packed_span.cu,
// compiled beside this file into the same library.
//
// The fp32 path (`moca_packed_attention_f32`) takes fp32 q, k, v and returns
// fp32, as the Pallas bodies do on fp32 refs: fp32 logits, the exact softmax
// normalised before PV, fp32 accumulation. It is bound by bytes as the bf16
// path is, with twice the bytes, and every product is a scalar FFMA (plain
// TF32, a 2^-11 unit, would miss the fp32 limit). Head tile
// (`packed_fwd_f32`): one warp owns one (row, head) problem and copies the
// head's S rows of k and v into shared memory (16-byte cp.async); L = 32 / S
// lanes share a q row where S divides 32 (one lane a row at S = 24, 8 lanes
// idle), each owning every L-th float4 chunk of the row: its partial logits
// over its chunks are summed by shuffles, then it writes its chunks of the
// output.
#include <algorithm>

#include "mma.cuh"

using namespace moca;

namespace moca {
// The span design at [N, S, H * d] (packed_span.cu): 0 or a CUDA error.
int span_launch(const void* q, const void* k, const void* v, void* o, long long N, int S, int H,
                int d, float scale_log2, bool f32, cudaStream_t st);
}  // namespace moca

namespace {

constexpr int STATIC_SMEM = 48 * 1024;  // static shared memory a block may use

// S rows of q/k/v per problem, DP = d rounded up to the mma depth (16).
template <int S, int DP>
struct Cfg {
  static constexpr int LD = DP + 8;         // padded row (bf16), conflict-free ldmatrix
  static constexpr int CH = DP / 8;         // 16-byte chunks per padded row
  static constexpr int MT = (S + 15) / 16;  // m16 tiles of q rows
  static constexpr int SP = MT * 16;        // rows padded to whole tiles
  static constexpr int NT = SP / 8;         // n8 tiles of logits
  static constexpr int WARP_ELEMS = 3 * SP * LD;  // q, k, v
  static constexpr int WARP_BYTES = WARP_ELEMS * static_cast<int>(sizeof(bf16));
  static constexpr int W0 = MT == 1 ? 4 : 2;
  // as many of W0 warps as the static shared memory holds (d = 128 needs fewer)
  static constexpr int WARPS = W0 * WARP_BYTES <= STATIC_SMEM       ? W0
                               : (W0 / 2) * WARP_BYTES <= STATIC_SMEM ? W0 / 2
                                                                      : 1;
};

template <int S, int DP>
__global__ void __launch_bounds__(Cfg<S, DP>::WARPS * 32)
    packed_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, long long items, int H, int d, float scale_log2) {
  using P = Cfg<S, DP>;
  constexpr int SP = P::SP, MT = P::MT, NT = P::NT, LD = P::LD, CH = P::CH;
  __shared__ __align__(16) bf16 smem[P::WARPS * P::WARP_ELEMS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long item = static_cast<long long>(blockIdx.x) * P::WARPS + warp;
  if (item >= items) return;  // the whole warp leaves together; no block barrier follows
  const long long n = item / H;
  const int h = static_cast<int>(item % H);
  const long long C = static_cast<long long>(H) * d;
  const long long base = n * S * C + static_cast<long long>(h) * d;
  const int dch = d >> 3;  // 16-byte chunks of a head's row; chunks dch..CH-1 are padding

  bf16* sq = smem + warp * P::WARP_ELEMS;
  bf16* sk = sq + SP * LD;
  bf16* sv = sk + SP * LD;

  for (int c = lane; c < 3 * SP * CH; c += 32) {
    const int which = c / (SP * CH), rem = c % (SP * CH);
    const int r = rem / CH, ch = rem % CH, col = ch * 8;
    bf16* dst = sq + which * SP * LD + r * LD + col;
    if (r < S && ch < dch) {
      const bf16* src = (which == 0 ? q : which == 1 ? k : v) + base + r * C + col;
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, frag_a_addr(sq, LD, mt * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < MT; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, frag_bt_addr(sk, LD, np * 16, ks * 16, lane));
        mma_16816(s[2 * np], a, bk[0], bk[1]);
        mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = nt * 8 + 2 * t + e < S;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][2 + e] = ok ? s[nt][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    uint32_t pf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pf[nt][0] = pack_bf16(s[nt][0] / sum0, s[nt][1] / sum0);
      pf[nt][1] = pack_bf16(s[nt][2] / sum1, s[nt][3] / sum1);
    }

    float acc[DP / 8][4];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, frag_a_addr(sv, LD, kk * 16, dp * 16, lane));
        mma_16816(acc[2 * dp], a, bv[0], bv[1]);
        mma_16816(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncwarp();  // this tile's q rows are consumed: stage the output there
    bf16* so = sq + mt * 16 * LD;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(so + g * LD + nt * 8 + 2 * t) = pack_bf16(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
  __syncwarp();
  for (int c = lane; c < S * CH; c += 32) {
    const int r = c / CH, ch = c % CH, col = ch * 8;
    if (ch < dch)
      *reinterpret_cast<uint4*>(o + base + r * C + col) =
          *reinterpret_cast<const uint4*>(sq + r * LD + col);
  }
}

template <int S, int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long N, int H, int d,
           float scale_log2, cudaStream_t stream) {
  using P = Cfg<S, DP>;
  const long long items = N * H;
  const long long blocks = (items + P::WARPS - 1) / P::WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  packed_fwd<S, DP><<<static_cast<unsigned>(blocks), P::WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), items, H, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_d(const void* q, const void* k, const void* v, void* o, long long N, int H, int d,
             float scale_log2, cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return launch<S, 16>(q, k, v, o, N, H, d, scale_log2, st);
    case 2: return launch<S, 32>(q, k, v, o, N, H, d, scale_log2, st);
    case 3: return launch<S, 48>(q, k, v, o, N, H, d, scale_log2, st);
    case 4: return launch<S, 64>(q, k, v, o, N, H, d, scale_log2, st);
    case 5: return launch<S, 80>(q, k, v, o, N, H, d, scale_log2, st);
    case 6: return launch<S, 96>(q, k, v, o, N, H, d, scale_log2, st);
    case 7: return launch<S, 112>(q, k, v, o, N, H, d, scale_log2, st);
    case 8: return launch<S, 128>(q, k, v, o, N, H, d, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The fp32 path
// ---------------------------------------------------------------------------

constexpr int F32_WARPS = 4;

template <int S>
__global__ void __launch_bounds__(F32_WARPS * 32)
    packed_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, long long items, int H,
                   int d, float scale_log2) {
  constexpr int L = 32 % S == 0 ? 32 / S : 1;  // lanes a q row
  extern __shared__ __align__(16) float smem_f32[];  // per warp: k, v [S][d]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * F32_WARPS + warp;
  if (item >= items) return;  // the whole warp leaves together; no block barrier follows
  const long long n = item / H;
  const int h = static_cast<int>(item % H);
  const long long C = static_cast<long long>(H) * d;
  const long long base = n * S * C + static_cast<long long>(h) * d;
  const int nch = d >> 2;  // float4 chunks of a head's row

  float* sk = smem_f32 + static_cast<long long>(warp) * 2 * S * d;
  float* sv = sk + S * d;
  for (int c = lane; c < 2 * S * nch; c += 32) {
    const int which = c / (S * nch), rem = c % (S * nch);
    const int r = rem / nch, col = (rem % nch) * 4;
    cp_async16((which == 0 ? sk : sv) + r * d + col, (which == 0 ? k : v) + base + r * C + col);
  }
  cp_async_commit();

  const int row = min(lane / L, S - 1), part = lane % L;  // lanes past S * L repeat row S - 1
  const float* qrow = q + base + row * C;
  cp_async_wait<0>();
  __syncwarp();

  float s[S];
#pragma unroll
  for (int j = 0; j < S; ++j) s[j] = 0.f;
  for (int c = part; c < nch; c += L) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + 4 * c);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(sk + j * d + 4 * c);
      s[j] = fmaf(x.x, kk.x, s[j]);
      s[j] = fmaf(x.y, kk.y, s[j]);
      s[j] = fmaf(x.z, kk.z, s[j]);
      s[j] = fmaf(x.w, kk.w, s[j]);
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int off = 1; off < L; off <<= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    s[j] *= scale_log2;
    mx = fmaxf(mx, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    s[j] = exp2f(s[j] - mx);
    sum += s[j];
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int j = 0; j < S; ++j) s[j] *= inv;

  if (lane >= S * L) return;  // no shuffle follows
  float* orow = o + base + row * C;
  for (int c = part; c < nch; c += L) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(sv + j * d + 4 * c);
      acc.x = fmaf(s[j], vv.x, acc.x);
      acc.y = fmaf(s[j], vv.y, acc.y);
      acc.z = fmaf(s[j], vv.z, acc.z);
      acc.w = fmaf(s[j], vv.w, acc.w);
    }
    *reinterpret_cast<float4*>(orow + 4 * c) = acc;
  }
}

template <int S>
int launch_f32(const void* q, const void* k, const void* v, void* o, long long N, int H, int d,
               float scale_log2, cudaStream_t stream) {
  const int bytes = F32_WARPS * 2 * S * d * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(packed_fwd_f32<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = N * H;
  const long long blocks = (items + F32_WARPS - 1) / F32_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  packed_fwd_f32<S><<<static_cast<unsigned>(blocks), F32_WARPS * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), items, H, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool head_tile_takes(int d) { return d % 8 == 0 && d <= 128; }

// The design K2 takes at head width d: 0 the head tile (d % 8 == 0 from 16 to
// 128), 1 the span design (every other d). At d = 8 both take the width; the
// span design is routed there: at N = 40960, S = 16, C = 320 it was the faster
// in fp32 in every run and in bf16 in every run but one, on a card that ran
// instruction-heavy rows ~7 % slower, where it read 1 % slower (chip_smoke.py
// phase 2; the readings are in PERF.md).
int plan(int d) { return head_tile_takes(d) && d >= 16 ? 0 : 1; }

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long N, int S, int H,
             int d, float scale_log2, int path, cudaStream_t st) {
  constexpr bool F32 = sizeof(T) == 4;
  if (H <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (path < 0) path = plan(d);
  if (path == 0) {
    if (!head_tile_takes(d)) return static_cast<int>(cudaErrorInvalidValue);
    switch (S) {
      case 8: return F32 ? launch_f32<8>(q, k, v, o, N, H, d, scale_log2, st)
                         : launch_d<8>(q, k, v, o, N, H, d, scale_log2, st);
      case 16: return F32 ? launch_f32<16>(q, k, v, o, N, H, d, scale_log2, st)
                          : launch_d<16>(q, k, v, o, N, H, d, scale_log2, st);
      case 24: return F32 ? launch_f32<24>(q, k, v, o, N, H, d, scale_log2, st)
                          : launch_d<24>(q, k, v, o, N, H, d, scale_log2, st);
      case 32: return F32 ? launch_f32<32>(q, k, v, o, N, H, d, scale_log2, st)
                          : launch_d<32>(q, k, v, o, N, H, d, scale_log2, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  return span_launch(q, k, v, o, N, S, H, d, scale_log2, F32, st);
}

}  // namespace

extern "C" int moca_packed_attention_plan(int d) { return plan(d); }

// `path`: as `plan` numbers the designs, or -1 for the plan's choice.
extern "C" int moca_packed_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         long long N, int S, int H, int d, float scale_log2,
                                         int path, void* stream) {
  return dispatch<float>(q, k, v, o, N, S, H, d, scale_log2, path,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int moca_packed_attention(const void* q, const void* k, const void* v, void* o,
                                     long long N, int S, int H, int d, float scale_log2, int path,
                                     void* stream) {
  return dispatch<bf16>(q, k, v, o, N, S, H, d, scale_log2, path,
                        static_cast<cudaStream_t>(stream));
}

__global__ void empty_kernel() {}

// An empty kernel launched through this library's ctypes route: the launch
// floor that chip_smoke.py prints beside K2's smallest rows.
extern "C" int moca_packed_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
