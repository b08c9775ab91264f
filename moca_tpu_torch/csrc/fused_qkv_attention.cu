// K3: fused self-attention of a tiny sequence, x [N, S, C] bf16 -> o [N, S, C]:
//   o = to_out(attention(x Wq^T, x Wk^T, x Wv^T)) + bo,
// heads of d = 64 (C = 64 * heads <= 1280), S in {8, 16, 24, 32}, weights in
// nn.Linear's [out, in] layout, bias [C].
//
// Replaces the Pallas TPU kernel `_fused_qkv_kernel`
// (moca_tpu/ops/flash_attention.py:431, launched at :524 by
// `fused_qkv_attention` :500). On the product path with MOCA_TPU_FA_FUSED_QKV
// it serves every temporal self-attention: S = 16 over N = batch*height*width
// pixel rows at C = 320, 512 (the 8-head init attention), 640 and 1280.
//
// Rounding points, those of the Pallas body (:451-497): q, k and v are
// rounded to bf16 after fp32 accumulation; the softmax is fp32 and the
// normalised probabilities are rounded to bf16 before PV; each head's output
// is rounded to bf16; the out projection is accumulated in fp32 and rounded,
// then bo is added in bf16 (one more rounding).
//
// What bounds it on an H100: 8*N*S*C^2 + 4*N*S^2*C tensor-core operations
// against 2*N*S*C*2 + 4*C^2*2 + C*2 bytes, i.e. ~C/2 operations per byte
// (160 at C = 320, 640 at C = 1280), so the operations bound it at C >= 640
// and the bytes come close at C = 320 (~0.55 ms either way at the main path's
// widths, ~1.4 ms at the init attention's C = 512 and N = 40960).
//
// Design (simple and right first; persistent blocks and wgmma are later work).
// One block of 4 warps owns whole sequences: T = 64 tokens where its x tile and
// its attention-output tile [T, C] fit beside the weight stages in shared
// memory (C <= 640), else 32 (C = 1280: 2 x 80 KB). x is copied in once with
// 16-byte cp.async. For each head, the head's 64 rows of Wq, Wk and Wv are
// streamed through shared memory in [64, 64] chunks, double buffered, and the
// three [T, 64] projections accumulate in registers, each warp owning 16 of
// the 64 columns over all T rows (mma.sync m16n8k16, bf16 in, fp32
// accumulate; nn.Linear's [out, in] rows are already the .col B operand, so
// nothing is transposed). q, k and v are rounded and staged in the (now free)
// weight buffers; each warp then takes whole sequences, forms the S x S logits
// in registers, takes the exact fp32 softmax and PV, and writes the head's
// output columns into the attention tile. After the last head, Wo is streamed
// the same way in 64-row chunks (64 output columns each); the rounded
// projection plus bias is staged in the x tile (no longer read) and written
// out as whole rows. The weights (0.8-13.1 MB) stay in the 50 MB L2, so every
// block reads them from there, not from device memory. The TPU kernel's
// 64/128-lane head slices and masks dodge Mosaic's lane layout and have no
// counterpart here. The S x S attention is done per sequence with rows padded
// to whole m16 tiles: keys past S are masked with -inf, query rows past S are
// computed on the next sequence's (or zero) rows and not stored.
#include "mma.cuh"

using namespace moca;

namespace {

constexpr int D = 64;                     // head width
constexpr int KC = 64;                    // contraction columns per streamed weight chunk
constexpr int LDW = KC + 8;               // padded weight-chunk row (conflict-free ldmatrix)
constexpr int LDH = D + 8;                // padded q/k/v staging row
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WCHUNK = D * LDW;           // one [64][KC] weight chunk
constexpr int UNION_ELEMS = 2 * 3 * WCHUNK;  // two stages of three chunks; the staging reuses them
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a block may use (sm_90)

template <int S, int TMAX>
struct Cfg {
  static constexpr int NS = TMAX / S;           // whole sequences per block
  static constexpr int T = NS * S;              // tokens per block
  static constexpr int MTILES = (T + 15) / 16;  // m16 tiles of tokens
  static constexpr int TP = MTILES * 16;        // tokens padded to whole tiles (zero rows)
  static constexpr int MTS = (S + 15) / 16;     // m16 tiles of one sequence
  static constexpr int NTS = MTS * 2;           // n8 tiles of one sequence's logits
  static constexpr int STG = TP + 16;           // staging rows: the last sequence's tile may read 8 past TP
  static_assert(3 * STG * LDH <= UNION_ELEMS, "the q/k/v staging must fit in the weight stages");

  static int bytes(int C) { return (2 * TP * (C + 8) + UNION_ELEMS) * static_cast<int>(sizeof(bf16)); }
};

template <int S, int TMAX>
__global__ void __launch_bounds__(THREADS)
    fused_qkv_fwd(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                  const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bo, bf16* __restrict__ o,
                  long long N, int C, float scale_log2) {
  using P = Cfg<S, TMAX>;
  constexpr int TP = P::TP, MTILES = P::MTILES, MTS = P::MTS, NTS = P::NTS, STG = P::STG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDX = C + 8;
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);  // [TP][LDX]: x, at the end the output
  bf16* sa = sx + TP * LDX;                      // [TP][LDX]: attention output, all heads
  bf16* su = sa + TP * LDX;                      // weight stages, or the q/k/v staging

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long seq0 = static_cast<long long>(blockIdx.x) * P::NS;
  const int nseq = static_cast<int>(N - seq0 < P::NS ? N - seq0 : P::NS);
  const int tv = nseq * S;  // valid tokens of this block
  const long long tok0 = seq0 * S;
  const int CH = C >> 3;    // 16-byte chunks of a row
  const int H = C / D, nk = C / KC;
  const int n0 = warp * 16;  // this warp's 16 of the 64 columns of a projection chunk

  for (int c = tid; c < TP * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    bf16* dst = sx + r * LDX + col;
    if (r < tv) {
      cp_async16(dst, x + (tok0 + r) * C + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  for (int c = tid; c < (TP - tv) * CH; c += THREADS) {  // rows the attention never writes
    const int r = tv + c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(sa + r * LDX + col) = make_uint4(0u, 0u, 0u, 0u);
  }

  // rows [row0, row0 + 64) and columns [k0, k0 + KC) of a [C, C] weight into dst [64][LDW]
  auto load_w = [&](bf16* dst, const bf16* w, int row0, int k0) {
    for (int c = tid; c < D * (KC / 8); c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      cp_async16(dst + r * LDW + col, w + static_cast<long long>(row0 + r) * C + k0 + col);
    }
  };

  for (int h = 0; h < H; ++h) {
    // ---- q, k, v of head h: [TP, 64] each, fp32 accumulators in registers
    float acc[3][MTILES][2][4];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[m][mt][j][0] = acc[m][mt][j][1] = acc[m][mt][j][2] = acc[m][mt][j][3] = 0.f;
    auto fetch_qkv = [&](int kc, int stage) {
      bf16* st = su + stage * 3 * WCHUNK;
      load_w(st, wq, h * D, kc * KC);
      load_w(st + WCHUNK, wk, h * D, kc * KC);
      load_w(st + 2 * WCHUNK, wv, h * D, kc * KC);
    };
    fetch_qkv(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        fetch_qkv(kc + 1, (kc + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* st = su + (kc & 1) * 3 * WCHUNK;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[MTILES][4];
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
          ldmatrix_x4(a[mt], frag_a_addr(sx, LDX, mt * 16, kc * KC + ks * 16, lane));
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          uint32_t b[4];
          ldmatrix_x4(b, frag_bt_addr(st + m * WCHUNK, LDW, n0, ks * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt) {
            mma_16816(acc[m][mt][0], a[mt], b[0], b[1]);
            mma_16816(acc[m][mt][1], a[mt], b[2], b[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // ---- q, k, v rounded to bf16 into the staging rows, plus 16 zero rows past TP
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bf16* dst = su + m * STG * LDH + (mt * 16 + g) * LDH + n0 + j * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[m][mt][j][0], acc[m][mt][j][1]);
          *reinterpret_cast<uint32_t*>(dst + 8 * LDH) = pack_bf16(acc[m][mt][j][2], acc[m][mt][j][3]);
        }
    for (int c = tid; c < 3 * 16 * (D / 8); c += THREADS) {
      const int m = c / (16 * (D / 8)), r = TP + (c / (D / 8)) % 16, col = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(su + m * STG * LDH + r * LDH + col) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    // ---- attention of head h, one warp per sequence
    const bf16* sq = su;
    const bf16* sk = su + STG * LDH;
    const bf16* sv = su + 2 * STG * LDH;
    for (int p = warp; p < nseq; p += WARPS) {
      const int r0 = p * S;
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) {
        float s[NTS][4];
#pragma unroll
        for (int i = 0; i < NTS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, frag_a_addr(sq, LDH, r0 + mt * 16, ks * 16, lane));
#pragma unroll
          for (int np = 0; np < MTS; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, frag_bt_addr(sk, LDH, r0 + np * 16, ks * 16, lane));
            mma_16816(s[2 * np], a, bk[0], bk[1]);
            mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = nt * 8 + 2 * t + e < S;  // keys of this sequence only
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
        for (int nt = 0; nt < NTS; ++nt) {
          s[nt][0] = exp2f(s[nt][0] - mx0);
          s[nt][1] = exp2f(s[nt][1] - mx0);
          s[nt][2] = exp2f(s[nt][2] - mx1);
          s[nt][3] = exp2f(s[nt][3] - mx1);
          sum0 += s[nt][0] + s[nt][1];
          sum1 += s[nt][2] + s[nt][3];
        }
        sum0 = quad_sum(sum0);
        sum1 = quad_sum(sum1);
        uint32_t pf[NTS][2];
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt) {
          pf[nt][0] = pack_bf16(s[nt][0] / sum0, s[nt][1] / sum0);
          pf[nt][1] = pack_bf16(s[nt][2] / sum1, s[nt][3] / sum1);
        }
        float ao[D / 8][4];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) ao[i][0] = ao[i][1] = ao[i][2] = ao[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MTS; ++kk) {
          const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, frag_a_addr(sv, LDH, r0 + kk * 16, dp * 16, lane));
            mma_16816(ao[2 * dp], a, bv[0], bv[1]);
            mma_16816(ao[2 * dp + 1], a, bv[2], bv[3]);
          }
        }
        const int ra = mt * 16 + g, rb = ra + 8;  // rows of this tile inside the sequence
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const int col = h * D + nt * 8 + 2 * t;
          if (ra < S)
            *reinterpret_cast<uint32_t*>(sa + (r0 + ra) * LDX + col) = pack_bf16(ao[nt][0], ao[nt][1]);
          if (rb < S)
            *reinterpret_cast<uint32_t*>(sa + (r0 + rb) * LDX + col) = pack_bf16(ao[nt][2], ao[nt][3]);
        }
      }
    }
    __syncthreads();  // the staging is consumed before the next head's weights land there
  }

  // ---- out projection: 64 output columns (64 rows of Wo) at a time, into sx
  for (int nc = 0; nc < H; ++nc) {
    float acc[MTILES][2][4];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    load_w(su, wo, nc * D, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load_w(su + ((kc + 1) & 1) * WCHUNK, wo, nc * D, (kc + 1) * KC);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* st = su + (kc & 1) * WCHUNK;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, frag_bt_addr(st, LDW, n0, ks * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, frag_a_addr(sa, LDX, mt * 16, kc * KC + ks * 16, lane));
          mma_16816(acc[mt][0], a, b[0], b[1]);
          mma_16816(acc[mt][1], a, b[2], b[3]);
        }
      }
      __syncthreads();
    }
    // round the projection to bf16, then add the bias in bf16 (the Pallas body's order)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nc * D + n0 + j * 8 + 2 * t;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bo + col));
      auto rounded = [](float f) { return __bfloat162float(__float2bfloat16(f)); };
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        bf16* dst = sx + (mt * 16 + g) * LDX + col;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(rounded(acc[mt][j][0]) + bias.x, rounded(acc[mt][j][1]) + bias.y);
        *reinterpret_cast<uint32_t*>(dst + 8 * LDX) =
            pack_bf16(rounded(acc[mt][j][2]) + bias.x, rounded(acc[mt][j][3]) + bias.y);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < tv * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(o + (tok0 + r) * C + col) =
        *reinterpret_cast<const uint4*>(sx + r * LDX + col);
  }
}

template <int S, int TMAX>
int launch(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
           const void* bo, void* o, long long N, int C, float scale_log2, cudaStream_t stream) {
  using P = Cfg<S, TMAX>;
  const int bytes = P::bytes(C);
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd<S, TMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (N + P::NS - 1) / P::NS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_qkv_fwd<S, TMAX><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<bf16*>(o), N, C, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// 64 tokens a block where the x and attention tiles fit beside the weight stages, else 32.
template <int S>
int launch_s(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
             const void* bo, void* o, long long N, int C, float scale_log2, cudaStream_t st) {
  if (Cfg<S, 64>::bytes(C) <= SMEM_MAX)
    return launch<S, 64>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
  return launch<S, 32>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
}

}  // namespace

extern "C" int moca_fused_qkv_attention(const void* x, const void* wq, const void* wk,
                                        const void* wv, const void* wo, const void* bo, void* o,
                                        long long N, int S, int C, float scale_log2,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C % D != 0 || C > 1280) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 8: return launch_s<8>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
    case 16: return launch_s<16>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
    case 24: return launch_s<24>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
    case 32: return launch_s<32>(x, wq, wk, wv, wo, bo, o, N, C, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
