// K2's span design: tiny-sequence self-attention on packed heads, [N, S, H*d]
// bf16 or fp32, S in {8, 16, 24, 32}, at any head width d. It serves the
// widths K2's head-tile design (packed_attention.cu) cannot copy, and d = 8;
// packed_attention.cu's `plan` picks the design and its entry points call
// `span_launch` below. Compiled beside packed_attention.cu into one library.
//
// Replaces `_packed_tiny_kernel` (moca_tpu/ops/flash_attention.py:320,
// launched at :614) at those widths: per (row, head), softmax(q k^T d^-1/2) v
// with an exact fp32 softmax normalised before PV, fp32 accumulation, output
// in the input's dtype. Bound by bytes at every d (S/2 operations a byte in
// bf16, S/4 in fp32).
//
// The span design (`span_narrow`, `span_wide`, any d): a CTA copies the
// slab-relative 16-byte chunks that cover a span of whole heads of one row
// (the copy plan, below), which are aligned whatever C and d are, and reads
// each head at its true offset inside them: with ldmatrix where the offset is
// a multiple of 8 elements (a zero row standing in for padding), else with
// 32-bit (d even) or 16-bit shared loads straight into the mma fragments.
// Narrow heads (d <= 64): a CTA stages several consecutive heads of a row,
// so its copies are whole contiguous chunks even at d = 8, and a warp takes a
// head. Wide heads (d > 64): one (row, head) a CTA of up to 4 warps, each
// warp a 64-column slice of d; blocks of slices stream through shared memory,
// q and k first, the warps' partial S x S logits summed through shared memory,
// then v, so that no step holds the whole head (at d = 1280 and S = 32 q, k and
// v would take 240 KB). Outputs go back through the staged span: whole
// chunks as 16-byte stores, the two edge chunks a row shares with
// neighbouring heads element by element.
//
// fp32 (`span_narrow_f32`, `span_wide_f32`): the same copy plan and CTAs as
// in bf16, scalar FFMA, L = 32 / S lanes a q row where S divides 32 (one lane
// a row at S = 24), reading float4, float2 or single floats as d's alignment
// allows.
#include <algorithm>

#include "mma.cuh"

using namespace moca;

namespace {

// ---------------------------------------------------------------------------
// The span design: any head width, bf16 and fp32
// ---------------------------------------------------------------------------
//
// Copy plan. A CTA stages the columns [b0, b1) of one row's [S, C] slab of q,
// k or v: for each token row r, the slab-relative 16-byte chunks that cover
// its elements r*C + b0 .. r*C + b1 - 1 (chunk c holds elements c*E ..
// c*E + E - 1, E = 16 / sizeof(T)), chunk c at raw[r * ldr + (c - c0) * E]
// with c0 = (r*C + b0) / E. A slab starts n*S*C elements into its tensor, a
// multiple of E because S * sizeof(T) is a multiple of 16, so every chunk is
// an aligned 16-byte copy inside the tensor whatever C and d are. Element
// (r, b0 + x) of the span then sits at raw[r * ldr + (r*C + b0) % E + x].
// tests/test_torch_packed_widths.py models the plan in Python (`span_ctas`,
// `span_row_chunks`, `span_ldr`, `span_lg`) and holds it to direct slicing.

constexpr int SPAN_SLICE = 64;     // head columns one warp takes at a time
constexpr int SPAN_MAX_WARPS = 4;  // warps a CTA
constexpr int SPAN_NARROW_COLS = 256;  // columns a narrow CTA stages (a head a warp at least)

// Elements of a staged row: the chunks a row of `cols` columns can straddle,
// rounded up to 1 mod 8 chunks, so that consecutive rows start 16 bytes apart
// modulo 128 (ldmatrix's eight row addresses fall in distinct banks).
__host__ __device__ __forceinline__ int span_ldr(int cols, int elems_per_chunk) {
  int rch = (cols + 2 * elems_per_chunk - 2) / elems_per_chunk;
  rch += (9 - rch % 8) % 8;
  return rch * elems_per_chunk;
}

// log2 of the chunks the copy loops visit in a row: the least power of two
// that holds the chunks a row of `cols` columns can straddle (so that a flat
// index splits into row and chunk without a division).
__host__ __device__ __forceinline__ int span_lg(int cols, int elems_per_chunk) {
  const int need = (cols + 2 * elems_per_chunk - 2) / elems_per_chunk;
  int lg = 0;
  while ((1 << lg) < need) ++lg;
  return lg;
}

// Stages the span [b0, b1) of up to three tensors' slabs (d_i <- s_i; a null
// source is skipped); slab-relative offsets fit an int (S * C < 2^31).
template <typename T>
__device__ __forceinline__ void stage_span(int S, int C, int b0, int b1, int ldr, int lg, T* d0,
                                           const T* s0, T* d1 = nullptr,
                                           const T* s1 = nullptr, T* d2 = nullptr,
                                           const T* s2 = nullptr) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < (S << lg); i += blockDim.x) {
    const int r = i >> lg, j = i & ((1 << lg) - 1);
    const int c = static_cast<int>(static_cast<unsigned>(r * C + b0) / E) + j;
    if (c * E >= r * C + b1) continue;
    const int at = r * ldr + j * E, from = c * E;
    cp_async16(d0 + at, s0 + from);
    if (s1) cp_async16(d1 + at, s1 + from);
    if (s2) cp_async16(d2 + at, s2 + from);
  }
}

// The reverse: the staged span back into the slab, whole chunks as 16-byte
// stores, and the edge chunks that the span shares with other heads element by
// element (another CTA or warp owns their other elements).
template <typename T>
__device__ __forceinline__ void write_span(T* slab, const T* raw, int S, int C, int b0, int b1,
                                           int ldr, int lg) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < (S << lg); i += blockDim.x) {
    const int r = i >> lg, j = i & ((1 << lg) - 1);
    const int a = r * C + b0, e = r * C + b1;
    const int lo = (static_cast<int>(static_cast<unsigned>(a) / E) + j) * E;
    if (lo >= e) continue;
    const T* src = raw + r * ldr + j * E;
    if (lo >= a && lo + E <= e) {
      *reinterpret_cast<uint4*>(slab + lo) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int x = 0; x < E; ++x)
        if (lo + x >= a && lo + x < e) slab[lo + x] = src[x];
    }
  }
}

// Where the wide kernels sum the warps' partial logits: over the staged k
// (free by then) where they fit, else behind it.
__host__ __device__ __forceinline__ bool red_behind(int red_bytes, int staged_bytes) {
  return red_bytes > staged_bytes;
}

// A staged span: row r of the columns that start `col` columns into it.
template <typename T>
struct Span {
  T* raw;
  int ldr, cmod, bmod;  // C % E and b0 % E
  __device__ __forceinline__ T* row(int r, int col) const {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    return raw + r * ldr + ((r * cmod + bmod) & (E - 1)) + col;
  }
};

template <int S>
struct Tile {
  static constexpr int MT = (S + 15) / 16;  // m16 tiles of q rows
  static constexpr int NT = MT * 2;         // n8 tiles of keys
};

// How the bf16 span design reads its fragments: a head's rows start at any
// element (odd d), at even elements (d even) or 16-byte aligned (d % 8 == 0,
// where ldmatrix reads them and a zero row stands in for padding).
enum { LD_U16 = 0, LD_U32 = 1, LD_MATRIX = 2 };

__device__ __forceinline__ uint32_t bits16(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// Elements c and c + 1 of a row as one bf16x2 register, each zero at or past
// w (w = 0 for a padding row). Past LD_U16, w and c are even.
template <int LM>
__device__ __forceinline__ uint32_t pair(const bf16* p, int c, int w) {
  if (LM != LD_U16) return c < w ? *reinterpret_cast<const uint32_t*>(p + c) : 0u;
  return (c < w ? bits16(p + c) : 0u) | (c + 1 < w ? bits16(p + c + 1) << 16 : 0u);
}

// s += Q K^T over the w (<= SPAN_SLICE) columns at `col` of the staged q, k.
template <int S, int LM>
__device__ __forceinline__ void span_qk(float (&s)[Tile<S>::MT][Tile<S>::NT][4],
                                        const Span<bf16>& q, const Span<bf16>& k, int col, int w,
                                        const bf16* zero, int lane) {
  constexpr int MT = Tile<S>::MT, NT = Tile<S>::NT;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < SPAN_SLICE / 16; ++ks) {
    if (ks * 16 >= w) break;
    if (LM == LD_MATRIX) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        const int ra = mt * 16 + (lane & 15), ca = ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a, ra < S && ca < w ? q.row(ra, col) + ca : zero);
#pragma unroll
        for (int np = 0; np < MT; ++np) {
          uint32_t b[4];
          const int rb = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int cb = ks * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(b, rb < S && cb < w ? k.row(rb, col) + cb : zero);
          mma_16816(s[mt][2 * np], a, b[0], b[1]);
          mma_16816(s[mt][2 * np + 1], a, b[2], b[3]);
        }
      }
    } else {
      const int c = ks * 16 + 2 * t;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + g, wj = j < S ? w : 0;
        const bf16* p = k.row(j, col);
        b[nt][0] = pair<LM>(p, c, wj);
        b[nt][1] = pair<LM>(p, c + 8, wj);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = mt * 16 + g, r1 = r0 + 8;
        const int w0 = r0 < S ? w : 0, w1 = r1 < S ? w : 0;
        const bf16 *p0 = q.row(r0, col), *p1 = q.row(r1, col);
        const uint32_t a[4] = {pair<LM>(p0, c, w0), pair<LM>(p1, c, w1), pair<LM>(p0, c + 8, w0),
                               pair<LM>(p1, c + 8, w1)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_16816(s[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
}

// One m16 tile's logits -> probabilities as bf16 A fragments: the exact
// softmax in fp32, keys past S masked, normalised before PV (packed_fwd's).
template <int S>
__device__ __forceinline__ void span_softmax(float (&s)[Tile<S>::NT][4],
                                             uint32_t (&pf)[Tile<S>::NT][2], float scale_log2,
                                             int t) {
  constexpr int NT = Tile<S>::NT;
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
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    pf[nt][0] = pack_bf16(s[nt][0] / sum0, s[nt][1] / sum0);
    pf[nt][1] = pack_bf16(s[nt][2] / sum1, s[nt][3] / sum1);
  }
}

// acc = P V for one m16 tile over the w columns at `col` of the staged v.
template <int S, int LM>
__device__ __forceinline__ void span_pv(float (&acc)[SPAN_SLICE / 8][4],
                                        const uint32_t (&pf)[Tile<S>::NT][2], const Span<bf16>& v,
                                        int col, int w, const bf16* zero, int lane) {
  constexpr int MT = Tile<S>::MT;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < SPAN_SLICE / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
    if (LM == LD_MATRIX) {
#pragma unroll
      for (int dp = 0; dp < SPAN_SLICE / 16; ++dp) {
        if (dp * 16 >= w) break;
        uint32_t b[4];
        const int r = kk * 16 + (lane & 15), c = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, r < S && c < w ? v.row(r, col) + c : zero);
        mma_16816(acc[2 * dp], a, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    } else {
      // B fragment: keys 2t, 2t + 1 (and + 8) of one column, two rows a register
      const int r = kk * 16 + 2 * t;
      const bf16* p[4] = {v.row(r, col), v.row(r + 1, col), v.row(r + 8, col),
                          v.row(r + 9, col)};
      const int wr[4] = {r < S ? w : 0, r + 1 < S ? w : 0, r + 8 < S ? w : 0,
                         r + 9 < S ? w : 0};
#pragma unroll
      for (int nt = 0; nt < SPAN_SLICE / 8; ++nt) {
        if (nt * 8 >= w) break;
        const int c = nt * 8 + g;
        const uint32_t b0 = (c < wr[0] ? bits16(p[0] + c) : 0u) |
                            (c < wr[1] ? bits16(p[1] + c) : 0u) << 16;
        const uint32_t b1 = (c < wr[2] ? bits16(p[2] + c) : 0u) |
                            (c < wr[3] ? bits16(p[3] + c) : 0u) << 16;
        mma_16816(acc[nt], a, b0, b1);
      }
    }
  }
}

// m16 tile mt of the output, rounded to bf16, into the staged span at `col`.
template <int S, int LM>
__device__ __forceinline__ void span_store(const float (&acc)[SPAN_SLICE / 8][4],
                                           const Span<bf16>& o, int mt, int col, int w,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = mt * 16 + g + 8 * half;
    if (r >= S) continue;
    bf16* p = o.row(r, col);
#pragma unroll
    for (int nt = 0; nt < SPAN_SLICE / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float x = acc[nt][2 * half], y = acc[nt][2 * half + 1];
      if (LM != LD_U16) {
        if (c < w) *reinterpret_cast<uint32_t*>(p + c) = pack_bf16(x, y);
      } else {
        if (c < w) p[c] = __float2bfloat16_rn(x);
        if (c + 1 < w) p[c + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// d <= SPAN_SLICE: a CTA stages `group` consecutive heads of one row (q, k
// and v at once) and each warp takes whole heads, writing its output over the
// head's staged q; then the CTA writes the span out.
template <int S, int LM>
__global__ void __launch_bounds__(SPAN_MAX_WARPS * 32)
    span_narrow(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H, int d, int group,
                float scale_log2) {
  using P = Tile<S>;
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (H + group - 1) / group;
  const long long n = blockIdx.x / groups;
  const int h0 = static_cast<int>(blockIdx.x % groups) * group, h1 = min(h0 + group, H);
  const int C = H * d, b0 = h0 * d, b1 = h1 * d;
  const long long slab = n * S * C;
  const int ldr = span_ldr(group * d, 8), lg = span_lg(group * d, 8);
  bf16* zero = reinterpret_cast<bf16*>(span_smem);
  bf16* sq = zero + 8;
  bf16* sk = sq + S * ldr;
  bf16* sv = sk + S * ldr;
  if (threadIdx.x < 8) zero[threadIdx.x] = __ushort_as_bfloat16(0);
  stage_span(S, C, b0, b1, ldr, lg, sq, q + slab, sk, k + slab, sv, v + slab);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cmod = C & 7, bmod = b0 & 7;
  const Span<bf16> qs{sq, ldr, cmod, bmod}, ks{sk, ldr, cmod, bmod}, vs{sv, ldr, cmod, bmod};
  for (int h = h0 + warp; h < h1; h += warps) {
    const int col = (h - h0) * d;
    float s[P::MT][P::NT][4] = {};
    span_qk<S, LM>(s, qs, ks, col, d, zero, lane);
    __syncwarp();  // every lane has read the head's q: its output may go there
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt) {
      uint32_t pf[P::NT][2];
      span_softmax<S>(s[mt], pf, scale_log2, lane & 3);
      float acc[SPAN_SLICE / 8][4];
      span_pv<S, LM>(acc, pf, vs, col, d, zero, lane);
      span_store<S, LM>(acc, qs, mt, col, d, lane);
    }
  }
  __syncthreads();
  write_span(o + slab, sq, S, C, b0, b1, ldr, lg);
}

// d > SPAN_SLICE: a CTA of `warps` warps owns one (row, head); warp w takes
// the head's SPAN_SLICE-column slices w, w + warps, ... Blocks of
// warps * SPAN_SLICE columns stream through shared memory, q and k first: each
// warp sums its slices' part of the logits in registers, the parts are summed
// through shared memory, every warp takes the softmax, and then v streams
// through the same buffers, each warp writing P V for its slice.
template <int S, int LM>
__global__ void __launch_bounds__(SPAN_MAX_WARPS * 32)
    span_wide(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, int H, int d, float scale_log2) {
  using P = Tile<S>;
  constexpr int NR = P::MT * P::NT * 4;  // logits a lane holds
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = blockIdx.x / H;
  const int h = static_cast<int>(blockIdx.x % H), C = H * d;
  const long long slab = n * S * C;
  const int bw = warps * SPAN_SLICE, nb = (d + bw - 1) / bw;
  const int ldr = span_ldr(bw, 8), lg = span_lg(bw, 8);
  bf16* zero = reinterpret_cast<bf16*>(span_smem);
  bf16* sa = zero + 8;
  bf16* sb = sa + S * ldr;
  float* red = reinterpret_cast<float*>(  // [warps][NR][32]
      red_behind(warps * NR * 32 * 4, S * ldr * 2) ? sb + S * ldr : sb);
  if (threadIdx.x < 8) zero[threadIdx.x] = __ushort_as_bfloat16(0);
  const int cmod = C & 7, col = warp * SPAN_SLICE;

  float s[P::MT][P::NT][4] = {};
  for (int b = 0; b < nb; ++b) {
    const int c0 = h * d + b * bw, c1 = h * d + min((b + 1) * bw, d);
    stage_span(S, C, c0, c1, ldr, lg, sa, q + slab, sb, k + slab);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int w = min(SPAN_SLICE, c1 - c0 - col);
    if (w > 0)
      span_qk<S, LM>(s, Span<bf16>{sa, ldr, cmod, c0 & 7}, Span<bf16>{sb, ldr, cmod, c0 & 7},
                     col, w, zero, lane);
    __syncthreads();
  }
  // v's first block is on its way while the logits' parts are summed
  stage_span(S, C, h * d, h * d + min(bw, d), ldr, lg, sa, v + slab);
  cp_async_commit();
  if (warps > 1) {
    float* mine = red + warp * NR * 32;
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((mt * P::NT + nt) * 4 + e) * 32 + lane] = s[mt][nt][e];
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
          for (int w2 = 0; w2 < warps; ++w2) x += red[(w2 * NR + (mt * P::NT + nt) * 4 + e) * 32 + lane];
          s[mt][nt][e] = x;
        }
  }
  uint32_t pf[P::MT][P::NT][2];
#pragma unroll
  for (int mt = 0; mt < P::MT; ++mt) span_softmax<S>(s[mt], pf[mt], scale_log2, lane & 3);

  for (int b = 0; b < nb; ++b) {
    const int c0 = h * d + b * bw, c1 = h * d + min((b + 1) * bw, d);
    if (b > 0) {
      stage_span(S, C, c0, c1, ldr, lg, sa, v + slab);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int w = min(SPAN_SLICE, c1 - c0 - col);
    if (w > 0) {
      const Span<bf16> vs{sa, ldr, cmod, c0 & 7}, os{sb, ldr, cmod, c0 & 7};
#pragma unroll
      for (int mt = 0; mt < P::MT; ++mt) {
        float acc[SPAN_SLICE / 8][4];
        span_pv<S, LM>(acc, pf[mt], vs, col, w, zero, lane);
        span_store<S, LM>(acc, os, mt, col, w, lane);
      }
    }
    __syncthreads();
    write_span(o + slab, sb, S, C, c0, c1, ldr, lg);
  }
}

// The fp32 span design: the same copy plan and CTAs, scalar FFMA as
// packed_fwd_f32 (L = 32 / S lanes share a q row, lane `part` taking every
// L-th V-vector of it; V = 4, 2 or 1 floats as d's alignment allows).
template <int S>
struct Lanes {
  static constexpr int L = 32 % S == 0 ? 32 / S : 1;
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// s[j] += this lane's share of q[row] . k[j] over the w columns at `col`.
template <int S, int V>
__device__ __forceinline__ void span_qk_f32(float (&s)[S], const Span<float>& q,
                                            const Span<float>& k, int col, int w, int row,
                                            int part) {
  constexpr int L = Lanes<S>::L;
  const float* qr = q.row(row, col);
  int ko[S];
#pragma unroll
  for (int j = 0; j < S; ++j) ko[j] = static_cast<int>(k.row(j, col) - k.raw);
  for (int c = part * V; c < w; c += L * V) {
    float x[V];
    load_vec<V>(qr + c, x);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float y[V];
      load_vec<V>(k.raw + ko[j] + c, y);
#pragma unroll
      for (int e = 0; e < V; ++e) s[j] = fmaf(x[e], y[e], s[j]);
    }
  }
}

// o[row] = p . v over this lane's share of the w columns at `col`.
template <int S, int V>
__device__ __forceinline__ void span_pv_f32(const float (&p)[S], const Span<float>& v,
                                            const Span<float>& o, int col, int w, int row,
                                            int part) {
  constexpr int L = Lanes<S>::L;
  float* orow = o.row(row, col);
  int vo[S];
#pragma unroll
  for (int j = 0; j < S; ++j) vo[j] = static_cast<int>(v.row(j, col) - v.raw);
  for (int c = part * V; c < w; c += L * V) {
    float acc[V] = {};
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float y[V];
      load_vec<V>(v.raw + vo[j] + c, y);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(p[j], y[e], acc[e]);
    }
    store_vec<V>(orow + c, acc);
  }
}

// The L lanes of a row sum their shares; then the exact softmax, normalised.
template <int S>
__device__ __forceinline__ void sum_parts(float (&s)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int off = 1; off < Lanes<S>::L; off <<= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
}

template <int S>
__device__ __forceinline__ void softmax_f32(float (&s)[S], float scale_log2) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < S; ++j) {
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
}

template <int S, int V>
__global__ void __launch_bounds__(SPAN_MAX_WARPS * 32)
    span_narrow_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int H, int d, int group,
                    float scale_log2) {
  constexpr int L = Lanes<S>::L;
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (H + group - 1) / group;
  const long long n = blockIdx.x / groups;
  const int h0 = static_cast<int>(blockIdx.x % groups) * group, h1 = min(h0 + group, H);
  const int C = H * d, b0 = h0 * d, b1 = h1 * d;
  const long long slab = n * S * C;
  const int ldr = span_ldr(group * d, 4), lg = span_lg(group * d, 4);
  float* sq = reinterpret_cast<float*>(span_smem);
  float* sk = sq + S * ldr;
  float* sv = sk + S * ldr;
  stage_span(S, C, b0, b1, ldr, lg, sq, q + slab, sk, k + slab, sv, v + slab);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cmod = C & 3, bmod = b0 & 3;
  const Span<float> qs{sq, ldr, cmod, bmod}, ks{sk, ldr, cmod, bmod}, vs{sv, ldr, cmod, bmod};
  const int row = min(lane / L, S - 1), part = lane % L;  // lanes past S * L repeat row S - 1
  for (int h = h0 + warp; h < h1; h += warps) {
    const int col = (h - h0) * d;
    float s[S] = {};
    span_qk_f32<S, V>(s, qs, ks, col, d, row, part);
    sum_parts<S>(s);
    softmax_f32<S>(s, scale_log2);
    // the output over this lane's own q columns, which only it reads
    if (lane < S * L) span_pv_f32<S, V>(s, vs, qs, col, d, row, part);
  }
  __syncthreads();
  write_span(o + slab, sq, S, C, b0, b1, ldr, lg);
}

template <int S, int V>
__global__ void __launch_bounds__(SPAN_MAX_WARPS * 32)
    span_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H, int d,
                  float scale_log2) {
  constexpr int L = Lanes<S>::L;
  extern __shared__ __align__(16) unsigned char span_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = blockIdx.x / H;
  const int h = static_cast<int>(blockIdx.x % H), C = H * d;
  const long long slab = n * S * C;
  const int bw = warps * SPAN_SLICE, nb = (d + bw - 1) / bw;
  const int ldr = span_ldr(bw, 4), lg = span_lg(bw, 4);
  float* sa = reinterpret_cast<float*>(span_smem);
  float* sb = sa + S * ldr;
  float* red = red_behind(warps * S * (S + 1) * 4, S * ldr * 4) ? sb + S * ldr : sb;  // [warps][S][S + 1]
  const int cmod = C & 3, col = warp * SPAN_SLICE;
  const int row = min(lane / L, S - 1), part = lane % L;

  float s[S] = {};
  for (int b = 0; b < nb; ++b) {
    const int c0 = h * d + b * bw, c1 = h * d + min((b + 1) * bw, d);
    stage_span(S, C, c0, c1, ldr, lg, sa, q + slab, sb, k + slab);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int w = min(SPAN_SLICE, c1 - c0 - col);
    if (w > 0)
      span_qk_f32<S, V>(s, Span<float>{sa, ldr, cmod, c0 & 3}, Span<float>{sb, ldr, cmod, c0 & 3},
                        col, w, row, part);
    __syncthreads();
  }
  stage_span(S, C, h * d, h * d + min(bw, d), ldr, lg, sa, v + slab);
  cp_async_commit();
  sum_parts<S>(s);
  if (warps > 1) {
    if (part == 0 && lane < S * L)
#pragma unroll
      for (int j = 0; j < S; ++j) red[(warp * S + row) * (S + 1) + j] = s[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float x = 0.f;
      for (int w2 = 0; w2 < warps; ++w2) x += red[(w2 * S + row) * (S + 1) + j];
      s[j] = x;
    }
  }
  softmax_f32<S>(s, scale_log2);

  for (int b = 0; b < nb; ++b) {
    const int c0 = h * d + b * bw, c1 = h * d + min((b + 1) * bw, d);
    if (b > 0) {
      stage_span(S, C, c0, c1, ldr, lg, sa, v + slab);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int w = min(SPAN_SLICE, c1 - c0 - col);
    if (w > 0 && lane < S * L)
      span_pv_f32<S, V>(s, Span<float>{sa, ldr, cmod, c0 & 3}, Span<float>{sb, ldr, cmod, c0 & 3},
                        col, w, row, part);
    __syncthreads();
    write_span(o + slab, sb, S, C, c0, c1, ldr, lg);
  }
}

template <typename... KArgs, typename... Args>
int launch_dyn(void (*kernel)(KArgs...), long long blocks, int warps, int bytes,
               cudaStream_t stream, Args... args) {
  if (blocks == 0) return 0;
  if (blocks < 0 || blocks > 0x7fffffffLL || bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The span design at [N, S, H * d]: `group` heads a CTA at d <= SPAN_SLICE
// (one warp a head, up to SPAN_MAX_WARPS), one head a CTA above (a warp a
// slice, up to SPAN_MAX_WARPS).
template <int S, int LM>
int launch_span(const void* q, const void* k, const void* v, void* o, long long N, int H, int d,
                int group, float scale_log2, cudaStream_t st) {
  using P = Tile<S>;
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  if (d <= SPAN_SLICE) {
    const int bytes = 16 + 3 * S * span_ldr(group * d, 8) * 2;
    return launch_dyn(span_narrow<S, LM>, N * ((H + group - 1) / group),
                      std::min(SPAN_MAX_WARPS, group), bytes, st, qq, kk, vv, oo, H, d, group,
                      scale_log2);
  }
  const int warps = std::min(SPAN_MAX_WARPS, (d + SPAN_SLICE - 1) / SPAN_SLICE);
  const int staged = S * span_ldr(warps * SPAN_SLICE, 8) * 2;
  const int red = warps * P::MT * P::NT * 4 * 32 * 4;
  const int bytes = 16 + 2 * staged + (red_behind(red, staged) ? red : 0);
  return launch_dyn(span_wide<S, LM>, N * H, warps, bytes, st, qq, kk, vv, oo, H, d, scale_log2);
}

template <int S, int V>
int launch_span_f32(const void* q, const void* k, const void* v, void* o, long long N, int H,
                    int d, int group, float scale_log2, cudaStream_t st) {
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  if (d <= SPAN_SLICE) {
    const int bytes = 3 * S * span_ldr(group * d, 4) * 4;
    return launch_dyn(span_narrow_f32<S, V>, N * ((H + group - 1) / group),
                      std::min(SPAN_MAX_WARPS, group), bytes, st, qq, kk, vv, oo, H, d, group,
                      scale_log2);
  }
  const int warps = std::min(SPAN_MAX_WARPS, (d + SPAN_SLICE - 1) / SPAN_SLICE);
  const int staged = S * span_ldr(warps * SPAN_SLICE, 4) * 4, red = warps * S * (S + 1) * 4;
  const int bytes = 2 * staged + (red_behind(red, staged) ? red : 0);
  return launch_dyn(span_wide_f32<S, V>, N * H, warps, bytes, st, qq, kk, vv, oo, H, d,
                    scale_log2);
}

template <int S>
int launch_span_d(const void* q, const void* k, const void* v, void* o, long long N, int H, int d,
                  int group, float scale_log2, cudaStream_t st) {
  if (d % 8 == 0) return launch_span<S, LD_MATRIX>(q, k, v, o, N, H, d, group, scale_log2, st);
  if (d % 2 == 0) return launch_span<S, LD_U32>(q, k, v, o, N, H, d, group, scale_log2, st);
  return launch_span<S, LD_U16>(q, k, v, o, N, H, d, group, scale_log2, st);
}

template <int S>
int launch_span_f32_d(const void* q, const void* k, const void* v, void* o, long long N, int H,
                      int d, int group, float scale_log2, cudaStream_t st) {
  if (d % 4 == 0) return launch_span_f32<S, 4>(q, k, v, o, N, H, d, group, scale_log2, st);
  if (d % 2 == 0) return launch_span_f32<S, 2>(q, k, v, o, N, H, d, group, scale_log2, st);
  return launch_span_f32<S, 1>(q, k, v, o, N, H, d, group, scale_log2, st);
}

// Heads a CTA of the span design stages: at d <= SPAN_SLICE a warp a head, up
// to SPAN_MAX_WARPS warps each taking as many heads as keep the CTA's span
// within SPAN_NARROW_COLS columns (at least one), the row's heads spread
// evenly over its CTAs; one head above, whose slices the warps split.
int span_group(int H, int d) {
  if (d > SPAN_SLICE) return 1;
  const int most = SPAN_MAX_WARPS * std::max(1, SPAN_NARROW_COLS / (SPAN_MAX_WARPS * d));
  const int ctas = (H + most - 1) / most;
  return (H + ctas - 1) / ctas;
}

}  // namespace

namespace moca {

int span_launch(const void* q, const void* k, const void* v, void* o, long long N, int S, int H,
                int d, float scale_log2, bool f32, cudaStream_t st) {
  const int g = span_group(H, d);
  switch (S) {
    case 8: return f32 ? launch_span_f32_d<8>(q, k, v, o, N, H, d, g, scale_log2, st)
                       : launch_span_d<8>(q, k, v, o, N, H, d, g, scale_log2, st);
    case 16: return f32 ? launch_span_f32_d<16>(q, k, v, o, N, H, d, g, scale_log2, st)
                        : launch_span_d<16>(q, k, v, o, N, H, d, g, scale_log2, st);
    case 24: return f32 ? launch_span_f32_d<24>(q, k, v, o, N, H, d, g, scale_log2, st)
                        : launch_span_d<24>(q, k, v, o, N, H, d, g, scale_log2, st);
    case 32: return f32 ? launch_span_f32_d<32>(q, k, v, o, N, H, d, g, scale_log2, st)
                        : launch_span_d<32>(q, k, v, o, N, H, d, g, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace moca
