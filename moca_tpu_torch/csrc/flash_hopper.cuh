// The Hopper attention body shared by K1 (flash_attention.cu) and K4
// (flash_onepass.cu): q [B, Sq, H, D] over k, v [B, Sk, H, D], bf16, D in
// {64, 128}, fp32 softmax statistics and accumulator, the output rounded once.
//
// What bounds it on an H100 at d = 64: each logit costs 4*D = 256 tensor-core
// operations (QK^T and PV) and one exp2. Dense bf16 wgmma does ~4096
// operations a clock on an SM and the SFU 16 exp2, so the exponentials take as
// long as the products; a kernel that runs them one after the other cannot
// pass half the tensor-core peak. At short rows (kv = 154, S = 160) bytes
// bound it.
//
// Design (FlashAttention-3's): persistent CTAs of three warpgroups, one a
// SM, each walking work tiles of 128 q rows of one (batch, head), the grid's
// stride apart (tiles of a (batch, head) are neighbours, so CTAs that run
// together share its K and V in L2). Persistence hides each tile's q load
// and output stores behind the previous tile's products; at kv = 154 it is
// what makes the design faster than the mma.sync kernel.
//   * Warpgroup 2 is the producer. It gives up registers (setmaxnreg 24)
//     and one thread loads by TMA, through 3D tensor maps over [B, S, H*D] with
//     boxes of 64 values x rows x 1 batch (rows past S come in as zeros, never
//     the next batch's): each consumer's 64-row q tile into a ring of two
//     (the next work tile's loads while this one is computed), then K and V
//     tiles of BN rows into two rings of stages, all with full/empty
//     mbarriers.
//   * Warpgroups 0 and 1 are consumers (setmaxnreg 240), 64 q rows each.
//     S = Q K^T on wgmma m64nBNk16 with Q and K K-major from shared memory;
//     O += P V on wgmma with P as register A fragments (the QK^T accumulators
//     rounded to bf16 pairs, no trip through shared memory) and V as the
//     MN-major B operand.
//   * The softmax runs under the tensor cores twice over. Within a
//     warpgroup, the QK^T of tile j and the PV of tile j - 1 are issued
//     together and the softmax of tile j runs while PV j - 1 is in flight
//     (its accumulators are rescaled once it lands). Across warpgroups, two
//     named barriers pass a turn back and forth (ping-pong): a warpgroup
//     issues its products only in its turn and hands the turn over right
//     after, so one warpgroup's exponentials run under the other's wgmma.
//   * Ragged kv tiles are masked with -inf (TMA's zero fill would give
//     logits of 0). The output is normalised, staged in the warpgroup's
//     (consumed) q tile in the same swizzle and written as 16-byte chunks of
//     whole rows; rows past Sq are not written. A warpgroup whose 64 rows
//     all lie past Sq (the second half of the last tile at Sq = 160) loads
//     the tile's first rows instead and writes nothing: skipping its products
//     would put wgmma under a branch on the thread index, which ptxas
//     answers by serialising every wgmma of the kernel.
// ONEPASS (K4) runs two sweeps on the same pipeline: sweep 1 streams K only
// and keeps each row's max of the logits (no exponent, no PV); sweep 2 is the
// main loop with that final max fixed, so nothing is rescaled. Its q tile is
// scaled by scale*log2(e) in fp32 and rounded to bf16 in shared memory first,
// as the Pallas body does.
#pragma once

#include "hopper.cuh"
#include "mma.cuh"

namespace moca {
namespace flash {

using namespace moca::hopper;

constexpr int BM = 64;                        // q rows a consumer warpgroup
constexpr int CONSUMERS = 2;                  // consumer warpgroups a CTA
// Consumers and a producer warpgroup: setmaxnreg.inc takes registers only
// from those its CTA gives back, and 128 * (168 - 24) = 2 * 128 * (240 - 168).
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int ROWS = CONSUMERS * BM;          // q rows a CTA
constexpr int CHUNK_ROW = 128;                // bytes of a 64-value row of a box
constexpr int kSched = 1;                     // named barriers kSched + wg: the turn
constexpr int kWg = kSched + CONSUMERS;       // named barriers kWg + wg: one warpgroup

struct Maps {
  CUtensorMap q, k, v;
};

constexpr int QSTAGES = 2;  // q tiles a consumer's ring holds

template <int D, int BN>
struct Layout {
  static constexpr int CH = D / 64;                     // 64-value column chunks
  static constexpr int Q_BYTES = BM * D * 2;            // one consumer's q tile
  static constexpr int KV_BYTES = BN * D * 2;           // one K or V stage
  static constexpr int STAGES = 4;                       // of the K ring and of the V ring
  static constexpr int K_OFF = CONSUMERS * QSTAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 256;  // 1024: alignment of the swizzled tiles
};

// The mbarriers: q_full/q_empty [consumer][q stage], then the K and V rings.
template <int STAGES>
struct Bars {
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* k_full;
  uint64_t* k_empty;
  uint64_t* v_full;
  uint64_t* v_empty;
  __device__ __forceinline__ explicit Bars(uint64_t* b)
      : q_full(b),
        q_empty(b + CONSUMERS * QSTAGES),
        k_full(b + 2 * CONSUMERS * QSTAGES),
        k_empty(k_full + STAGES),
        v_full(k_empty + STAGES),
        v_empty(v_full + STAGES) {}
};

// Work tile u (of B * H * ceil(Sq / ROWS)): its first q row, head and batch.
struct Tile {
  int q0, h, b;
  __device__ __forceinline__ Tile(int u, int Sq, int H) {
    const int per = (Sq + ROWS - 1) / ROWS;
    const int bh = u / per;
    q0 = (u - bh * per) * ROWS;
    h = bh % H;
    b = bh / H;
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The warpgroups' turn to issue products: warpgroup wg waits on barrier
// kSched + wg, which completes once the other warpgroup has arrived on it.
// Warpgroup 1 lets warpgroup 0 go first; each takes `turns` turns, and the
// last turn of warpgroup 1 passes nothing on (no turn of warpgroup 0 is left
// to take it), so every barrier phase completes.
struct PingPong {
  int wg, turns;
  __device__ __forceinline__ void start() {
    if (wg == 1) named_arrive(kSched, 2 * 128);
  }
  __device__ __forceinline__ void take() { named_sync(kSched + wg, 2 * 128); }
  __device__ __forceinline__ void pass() {
    if (--turns > 0 || wg == 0) named_arrive(kSched + (wg ^ 1), 2 * 128);
  }
};

// S = Q K^T for one consumer: q [64, D] and k [BN, D], each CH boxes of 64
// columns (q boxes 64 rows apart, k boxes BN rows apart).
template <int D, int BN>
__device__ __forceinline__ void issue_qk(float* s, const unsigned char* q,
                                         const unsigned char* k) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / 4, kk = ks % 4;
    wgmma_ss<BN>(s, desc_kmajor(q + c * BM * CHUNK_ROW) + 2 * kk,
                 desc_kmajor(k + c * BN * CHUNK_ROW) + 2 * kk, ks > 0);
  }
  wgmma_commit();
}

// O += P V: P [64, BN] from registers (4 bf16 pairs a k16 step), v [BN, D]
// MN-major, its column chunks BN rows apart.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p, const unsigned char* v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D, 1>(o, p + 4 * kk, desc_mnmajor(v, BN * CHUNK_ROW) + kk * (2048 >> 4), 1);
  wgmma_commit();
}

// Logits at keys >= Sk to -inf (a thread holds columns 8j + 2t + e).
template <int BN>
__device__ __forceinline__ void mask_tail(float* s, int kv0, int Sk, int t) {
  if (kv0 + BN <= Sk) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (kv0 + 8 * j + 2 * t + e >= Sk) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
}

// This thread's max of the logits of its rows g (r = 0) and g + 8 (r = 1).
template <int BN>
__device__ __forceinline__ void row_max(const float* s, float& mx0, float& mx1) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
}

// s <- exp2(s * scale - m) in place (scale = 1 for K4's pre-scaled q); the
// rows' sums of this thread's values.
template <int BN>
__device__ __forceinline__ void exponentiate(float* s, float scale, float m0, float m1,
                                             float& sum0, float& sum1) {
  sum0 = sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale, -m0));
      s[4 * j + 2 + e] = fast_exp2(fmaf(s[4 * j + 2 + e], scale, -m1));
      sum0 += s[4 * j + e];
      sum1 += s[4 * j + 2 + e];
    }
  }
}

template <int BN>
__device__ __forceinline__ void pack_p(uint32_t* p, const float* s) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float* o, float a0, float a1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

// One consumer warpgroup: its 64 rows of each of this CTA's work tiles, its
// q tiles in `sq_ring` (QSTAGES tiles of CH boxes).
template <int D, int BN, bool ONEPASS>
__device__ __forceinline__ void consume(unsigned char* sq_ring, const unsigned char* sk,
                                        const unsigned char* sv, const Bars<Layout<D, BN>::STAGES>& bar,
                                        bf16* o, int B, int Sq, int Sk, int H,
                                        float scale_log2, int wg) {
  using L = Layout<D, BN>;
  const int wtid = threadIdx.x & 127, wwarp = wtid >> 5, lane = wtid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (Sk + BN - 1) / BN;
  const int total = B * H * ((Sq + ROWS - 1) / ROWS);
  const int mine = (total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  RingPos qp{0, 0u}, kp{0, 0u}, vp{0, 0u};
  auto acquire = [&](uint64_t* full, RingPos& pos, int stages) {
    const int st = pos.stage;
    mbar_wait(&full[st], pos.parity);
    pos.advance(stages);
    return st;
  };
  auto release = [&](uint64_t* empty, int st) {
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  PingPong pp{wg, mine * (ONEPASS ? 2 * ntiles + 1 : ntiles + 1)};
  pp.start();
  // K1 takes logits in natural units and scales in the exponent; K4's are
  // base-2 already.
  const float sc = ONEPASS ? 1.f : scale_log2;
  const long long rs = static_cast<long long>(H) * D;

  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const Tile tile(u, Sq, H);
    const int q_row0 = tile.q0 + wg * BM;
    const int qs = acquire(bar.q_full + wg * QSTAGES, qp, QSTAGES);
    unsigned char* sq = sq_ring + qs * L::Q_BYTES;

    float s[BN / 2];     // logits, then their exponentials
    uint32_t p[BN / 4];  // the previous kv tile's probabilities, bf16 pairs
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    if constexpr (ONEPASS) {  // q * scale*log2(e) in fp32, rounded to bf16, in place
      for (int c = wtid; c < L::Q_BYTES / 16; c += 128) {
        uint4* ptr = reinterpret_cast<uint4*>(sq + 16 * c);
        uint4 x = *ptr;
        uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          w[i] = pack_bf16(f.x * scale_log2, f.y * scale_log2);
        }
        *ptr = x;
      }
      fence_async_shared();
      named_sync(kWg + wg, 128);
    }

    if constexpr (ONEPASS) {  // sweep 1: the row max over the whole row
      for (int j = 0; j < ntiles; ++j) {
        const int ks = acquire(bar.k_full, kp, L::STAGES);
        pp.take();
        issue_qk<D, BN>(s, sq, sk + ks * L::KV_BYTES);
        pp.pass();
        wgmma_wait<0>();
        fence_regs<BN / 2>(s);
        release(bar.k_empty, ks);
        mask_tail<BN>(s, j * BN, Sk, t);
        row_max<BN>(s, m0, m1);
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    }

    {  // kv tile 0: its logits and probabilities
      const int ks = acquire(bar.k_full, kp, L::STAGES);
      pp.take();
      issue_qk<D, BN>(s, sq, sk + ks * L::KV_BYTES);
      pp.pass();
      wgmma_wait<0>();
      fence_regs<BN / 2>(s);
      release(bar.k_empty, ks);
      mask_tail<BN>(s, 0, Sk, t);
      if constexpr (!ONEPASS) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
        row_max<BN>(s, mx0, mx1);
        m0 = quad_max(mx0) * scale_log2;
        m1 = quad_max(mx1) * scale_log2;
      }
      exponentiate<BN>(s, sc, m0, m1, l0, l1);
      pack_p<BN>(p, s);
    }
    // kv tile j's QK^T and tile j - 1's PV in flight together; tile j's
    // softmax under the PV.
    for (int j = 1; j < ntiles; ++j) {
      const int ks = acquire(bar.k_full, kp, L::STAGES);
      const int vs = acquire(bar.v_full, vp, L::STAGES);
      pp.take();
      issue_qk<D, BN>(s, sq, sk + ks * L::KV_BYTES);
      issue_pv<D, BN>(acc, p, sv + vs * L::KV_BYTES);
      pp.pass();
      wgmma_wait<1>();
      fence_regs<BN / 2>(s);
      release(bar.k_empty, ks);
      mask_tail<BN>(s, j * BN, Sk, t);
      float a0 = 1.f, a1 = 1.f, sum0, sum1;
      if constexpr (!ONEPASS) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
        row_max<BN>(s, mx0, mx1);
        const float n0 = fmaxf(m0, quad_max(mx0) * scale_log2);
        const float n1 = fmaxf(m1, quad_max(mx1) * scale_log2);
        a0 = fast_exp2(m0 - n0);
        a1 = fast_exp2(m1 - n1);
        m0 = n0;
        m1 = n1;
      }
      exponentiate<BN>(s, sc, m0, m1, sum0, sum1);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      release(bar.v_empty, vs);
      if constexpr (!ONEPASS) rescale<D>(acc, a0, a1);
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      pack_p<BN>(p, s);
    }
    {  // the last kv tile's PV
      const int vs = acquire(bar.v_full, vp, L::STAGES);
      pp.take();
      issue_pv<D, BN>(acc, p, sv + vs * L::KV_BYTES);
      pp.pass();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      release(bar.v_empty, vs);
    }

    {
      // Epilogue: normalise, stage the bf16 rows in this q tile (same
      // swizzle: 16-byte chunk c of row r at chunk c ^ (r & 7)), write whole
      // rows.
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      named_sync(kWg + wg, 128);  // every warp's QK^T is done with the q tile
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        unsigned char* chunk = sq + (j / 8) * BM * CHUNK_ROW;
        const int r = 16 * wwarp + g;  // r & 7 == g, and the same for r + 8
        const int off = (((j % 8) ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(chunk + r * CHUNK_ROW + off) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(chunk + (r + 8) * CHUNK_ROW + off) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
      named_sync(kWg + wg, 128);
      bf16* oh = o + static_cast<long long>(tile.b) * Sq * rs + static_cast<long long>(tile.h) * D;
      constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
      for (int i = 0; i < BM * CPR / 128; ++i) {
        const int c = wtid + 128 * i;
        const int r = c / CPR, cc = c % CPR;
        const int row = q_row0 + r;
        if (row < Sq)
          *reinterpret_cast<uint4*>(oh + static_cast<long long>(row) * rs + 8 * cc) =
              *reinterpret_cast<const uint4*>(sq + (cc / 8) * BM * CHUNK_ROW + r * CHUNK_ROW +
                                              (((cc % 8) ^ (r & 7)) << 4));
      }
      fence_async_shared();  // the next TMA load into this tile follows these accesses
    }
    __syncwarp();
    release(bar.q_empty + wg * QSTAGES, qs);
  }
}

// The kernel body: CTA i takes work tiles i, i + grid, ... A __global__
// wrapper in each source gives K1 and K4 kernels names of their own.
template <int D, int BN, bool ONEPASS>
__device__ __forceinline__ void attention_fwd(const Maps& maps, bf16* __restrict__ o, int B,
                                              int Sq, int Sk, int H, float scale_log2) {
  using L = Layout<D, BN>;
  extern __shared__ unsigned char flash_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(flash_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sk = base + L::K_OFF;
  unsigned char* sv = base + L::V_OFF;
  const Bars<L::STAGES> bar(reinterpret_cast<uint64_t*>(base + L::BAR_OFF));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < CONSUMERS * QSTAGES; ++i) {
      mbar_init(&bar.q_full[i], 1);
      mbar_init(&bar.q_empty[i], 4);  // the consumer's warps
    }
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&bar.k_full[s], 1);
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.k_empty[s], CONSUMERS * 4);  // every consumer warp
      mbar_init(&bar.v_empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // ------------------------------------------------------------ producer
    reg_dealloc<24>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      prefetch_tma_map(&maps.q);
      prefetch_tma_map(&maps.k);
      prefetch_tma_map(&maps.v);
      const int ntiles = (Sk + BN - 1) / BN;
      const int total = B * H * ((Sq + ROWS - 1) / ROWS);
      RingPos qp{0, 1u}, kp{0, 1u}, vp{0, 1u};
      auto load = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full,
                      uint64_t* empty, RingPos& pos, int j, const Tile& tile) {
        const int st = pos.stage;
        mbar_wait(&empty[st], pos.parity);
        mbar_arrive_expect_tx(&full[st], L::KV_BYTES);  // rows past Sk come in as zeros
        for (int c = 0; c < L::CH; ++c)
          tma_load_3d(ring + st * L::KV_BYTES + c * BN * CHUNK_ROW, map, &full[st],
                      tile.h * D + 64 * c, j * BN, tile.b);
        pos.advance(L::STAGES);
      };
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        const Tile tile(u, Sq, H);
        for (int w = 0; w < CONSUMERS; ++w) {
          const int i = w * QSTAGES + qp.stage;
          mbar_wait(&bar.q_empty[i], qp.parity);
          // a tile wholly past Sq loads the work tile's first rows instead
          const int row = tile.q0 + w * BM < Sq ? tile.q0 + w * BM : tile.q0;
          mbar_arrive_expect_tx(&bar.q_full[i], L::Q_BYTES);
          for (int c = 0; c < L::CH; ++c)
            tma_load_3d(base + i * L::Q_BYTES + c * BM * CHUNK_ROW, &maps.q, &bar.q_full[i],
                        tile.h * D + 64 * c, row, tile.b);
        }
        qp.advance(QSTAGES);
        if (ONEPASS)
          for (int j = 0; j < ntiles; ++j)
            load(&maps.k, sk, bar.k_full, bar.k_empty, kp, j, tile);
        for (int j = 0; j < ntiles; ++j) {
          load(&maps.k, sk, bar.k_full, bar.k_empty, kp, j, tile);
          load(&maps.v, sv, bar.v_full, bar.v_empty, vp, j, tile);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    reg_alloc<240>();
    const int wg = warp >> 2;
    consume<D, BN, ONEPASS>(base + wg * QSTAGES * L::Q_BYTES, sk, sv, bar, o, B, Sq, Sk, H,
                            scale_log2, wg);
  }
}

// Tensor maps over q [B, Sq, H*D] and k, v [B, Sk, H*D]: boxes of 64 values x
// BM (q) or BN (k, v) rows x 1 batch.
inline int encode_maps(Maps* maps, const void* q, const void* k, const void* v, int B, int Sq,
                       int Sk, int H, int D, int BN) {
  const uint64_t rs = static_cast<uint64_t>(H) * D;
  const uint64_t qd[3] = {rs, static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t kd[3] = {rs, static_cast<uint64_t>(Sk), static_cast<uint64_t>(B)};
  const uint64_t qs[2] = {rs * 2, rs * 2 * static_cast<uint64_t>(Sq)};
  const uint64_t ks[2] = {rs * 2, rs * 2 * static_cast<uint64_t>(Sk)};
  const uint32_t qb[3] = {64, BM, 1};
  const uint32_t kb[3] = {64, static_cast<uint32_t>(BN), 1};
  int err = make_tma_map(&maps->q, q, 3, qd, qs, qb);
  if (!err) err = make_tma_map(&maps->k, k, 3, kd, ks, kb);
  if (!err) err = make_tma_map(&maps->v, v, 3, kd, ks, kb);
  return err;
}

using Kernel = void (*)(Maps, bf16*, int, int, int, int, float);

// Launch `kernel` (a wrapper of attention_fwd<D, BN, .>) on q [B, Sq, H, D]:
// one CTA a SM, or one a work tile where there are fewer.
template <int D, int BN>
int launch(Kernel kernel, const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, float scale_log2, cudaStream_t stream) {
  using L = Layout<D, BN>;
  const long long total = static_cast<long long>(B) * H * ((Sq + ROWS - 1) / ROWS);
  if (total <= 0 || total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t cerr = cudaGetDevice(&dev);
    if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  Maps maps;
  const int err = encode_maps(&maps, q, k, v, B, Sq, Sk, H, D, BN);
  if (err) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = static_cast<int>(total < sms ? total : sms);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(maps, static_cast<bf16*>(o), B, Sq, Sk, H,
                                              scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace moca
