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
// against 2*N*S*C*2 + 4*C^2*2 + C*2 bytes, ~C/2 operations per byte, so on
// paper the operations (~0.55 ms at the main path's FIFO widths, ~1.4 ms at
// the init attention's C = 512, N = 40960). In practice the weights: a CTA
// holds a token tile and must take every weight byte of all heads into its
// shared memory, 8*C^2 bytes per tile, 8.4 GB at C = 320, N = 40960 for
// 64-token tiles. The first design (mma.sync, 4 warps, a 2-stage cp.async
// ring) streamed them at 5-10x its bound. With the math left out, the
// streaming alone took two thirds or more of this design's time at every
// main-path width on an H100: the weight bytes delivered into the SMs bound
// it. Sharing an L2 read among a cluster's CTAs by TMA multicast made the
// kernel no faster at any main-path width, since each SM still takes in every
// byte (PERF.md section 6). More tokens per delivered weight byte is what
// helps.
//
// Design. A CTA owns NWG tiles of 64 token rows; a tile is floor(64 / S)
// whole sequences, T tokens (64 at S = 8, 16, 32; 48 at S = 24, whose last
// 16 rows are the next tile's and are computed but not stored). Warp 4 * NWG
// is the producer: one thread loads the x tiles once by TMA ([64, 64] boxes,
// 128-byte swizzle; rows past N*S come in as zeros, so a ragged last tile
// reads nothing past N) and streams the weights through a ring of stages. A
// stage is W 64-row blocks of a 64-column chunk: with W = 3 the Wq, Wk and Wv
// rows of one head (three boxes, one from each weight, which together form
// the [192, 64] B operand), or three blocks of Wo (one box); with W = 1 one
// block. `plan` takes the most tiles a CTA (up to 3, 2 at S > 16) that keep
// three waves of CTAs and leave room for a ring of 3 stages of W = 3
// (C <= 640), else 6 of W = 1 (3 at one tile): on the FIFO path 3 tiles at
// C = 320, 2 at C = 512 and 640 (W = 1 at 640), 1 at C = 1280, whose x tile
// alone takes 160 KB.
// Each consumer warpgroup (128 threads, its own x tile) takes every stage:
// `wgmma` m64n192k16 (m64n64k16 with W = 1) with its x tile as the K-major A
// operand and the weight rows, nn.Linear's [out, in] layout as it is, as the
// K-major B operand; q, k and v of a head accumulate in 96 fp32 registers a
// thread. Stages are released one wgmma group behind through full/empty
// mbarriers. The S x S attention of each sequence runs on mma.sync (2.5 % of
// the work at C = 320), keys past S masked with -inf. At S <= 16 a warp's 16
// accumulator rows hold whole sequences, and the attention runs from those
// registers (`attend_from_registers`); at S = 24, 32 q, k and v are rounded
// into a staging tile in shared memory, one warp a sequence. Each head's
// rounded output goes to a bf16 scratch [N*S, C] in device memory (allocated
// by the wrapper), which TMA brings back into the x region once every head is
// done, as the out projection's A operand: a second [64, C] tile a warpgroup
// would not fit beside the ring. That adds 2*N*S*C*2 bytes, 0.21 GB at
// C = 1280, N = 2560 (~0.06 ms at the memory rate); q, k, v and the logits
// never leave the chip.
//
// Head split (the wrapper's `fused_qkv_head_split`, C = 1280): where the
// tiles leave most SMs idle (the middle block, 20 tiles), a cluster of 2 or 4
// CTAs shares one tile, each CTA projecting and attending its share of the
// heads and computing its share of the out projection's blocks, the attention
// tile exchanged through the scratch (each CTA signals every CTA of the
// cluster once its heads are written).
//
// The fp32 path (`moca_fused_qkv_attention_f32`, `f32::fused_qkv_fwd` below)
// takes fp32 x, weights and bias and returns fp32, as the Pallas body does
// on fp32 refs (every rounding point above is then exact). Simple first: a
// CTA of 256 threads owns one tile of T tokens and, head by head, projects
// q, k and v of the head ([64, 64] each) with scalar FFMAs, 4 x 4 outputs a
// thread from [16, 64] chunks of x and of the three weights' rows staged
// transposed in shared memory; runs the S x S attention of each sequence
// from shared memory (four threads a row, 16 dimensions each, the logits
// summed by shuffles, the softmax exact in fp32); and writes the head's
// output into an fp32 scratch [N*S, C] in device memory. Once every head is
// done, the out projection reads the tile's rows back from the scratch in
// the same chunks, 64 output columns at a time, and adds bo. No head split:
// the wrapper passes 1. Plain TF32 products (a 2^-11 unit) would miss the
// fp32 limit, so none are used.
#include "hopper.cuh"
#include "mma.cuh"

using namespace moca;
using namespace moca::hopper;

namespace {

constexpr int D = 64;              // head width
constexpr int TILE = 64;           // token rows a CTA
constexpr int CHUNK = TILE * 128;  // bytes of a [64, 64] bf16 tile
constexpr int LDH = D + 8;         // padded q/k/v staging row (conflict-free ldmatrix)
constexpr int STG = TILE + 8;      // staging rows: at S = 8 the last m16 tile reads 8 past
constexpr int STAGING = 3 * STG * LDH * 2;
constexpr int BARS = 320;          // bytes for the mbarriers
constexpr int MAX_STAGES = 16;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use (sm_90)

struct Plan {
  int width, groups, stages, bytes;
};

// Consumer warpgroups (64-token tiles a CTA, each with its own x tile, and
// q/k/v staging at S > 16) and 64-row weight blocks a ring stage (width) for
// `tiles` tiles on `sms` SMs: the most tiles a CTA, up to 3 (2 at S > 16),
// that keep the grid at 3 waves or more (one CTA an SM) and leave room for a
// ring of 3 stages of three blocks (Wq, Wk and Wv of a head, one m64n192k16
// product a k16 step; C <= 640), else of 6 stages of one block (3 at one
// tile). Every tile a CTA takes in every weight byte, so more tiles mean
// fewer weight bytes delivered a token.
Plan plan(int C, int S, long long tiles, int sms) {
  const int per_group = (C / D) * CHUNK + (S <= 16 ? 0 : STAGING);
  for (int g = S <= 16 ? 3 : 2; g >= 1; --g)
    for (int w = 3; w >= 1; w -= 2) {
      if (g > 1 && (tiles + g - 1) / g < 3LL * sms) break;
      if (w == 3 && C > 640) continue;  // the head split takes Wo a block at a time
      const int fixed = 1024 + BARS + g * per_group;  // 1024: alignment of the swizzled tiles
      const int fit = (SMEM_MAX - fixed) / (w * CHUNK);
      const int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
      if (stages >= (w == 3 || g == 1 ? 3 : 6)) return {w, g, stages, fixed + stages * w * CHUNK};
    }
  return {1, 1, 0, 0};
}

// The attention of head h from the projection's registers, at S <= 16: warp
// w of the warpgroup holds rows 16w..16w+15 of q, k and v (one sequence at
// S = 16, two at S = 8) in wgmma's accumulator layout, which is mma.sync's C
// layout per n8 tile. Rounded to bf16, q's registers are the A fragments of
// QK^T and k's the B fragments as they stand (B[d][key] = k[key][d]); v's
// become the B fragments of PV through movmatrix transposes. The head's
// rounded output rows go to the scratch.
template <int S>
__device__ __forceinline__ void attend_from_registers(const float* acc, float scale_log2,
                                                      bf16* scratch, int row0, int ntok, int C,
                                                      int h, int g, int t) {
  const float* aq = acc;
  const float* ak = acc + 32;
  const float* av = acc + 64;
  float sc[2][4] = {};  // logits: keys 0..7, keys 8..15 of the warp's rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const float* q8 = aq + 8 * kk;
    const float* k8 = ak + 8 * kk;
    const uint32_t a[4] = {pack_bf16(q8[0], q8[1]), pack_bf16(q8[2], q8[3]),
                           pack_bf16(q8[4], q8[5]), pack_bf16(q8[6], q8[7])};
    mma_16816(sc[0], a, pack_bf16(k8[0], k8[1]), pack_bf16(k8[4], k8[5]));  // k rows g
    mma_16816(sc[1], a, pack_bf16(k8[2], k8[3]), pack_bf16(k8[6], k8[7]));  // k rows g + 8
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;  // rows g and g + 8
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // at S = 8 rows g see keys 0..7 and rows g + 8 keys 8..15 (their sequences)
      const bool ok0 = S == 16 || nt == 0, ok1 = S == 16 || nt == 1;
      sc[nt][e] = ok0 ? sc[nt][e] * scale_log2 : -INFINITY;
      sc[nt][2 + e] = ok1 ? sc[nt][2 + e] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, sc[nt][e]);
      mx1 = fmaxf(mx1, sc[nt][2 + e]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    sc[nt][0] = exp2f(sc[nt][0] - mx0);
    sc[nt][1] = exp2f(sc[nt][1] - mx0);
    sc[nt][2] = exp2f(sc[nt][2] - mx1);
    sc[nt][3] = exp2f(sc[nt][3] - mx1);
    sum0 += sc[nt][0] + sc[nt][1];
    sum1 += sc[nt][2] + sc[nt][3];
  }
  sum0 = quad_sum(sum0);
  sum1 = quad_sum(sum1);
  const uint32_t p[4] = {pack_bf16(sc[0][0] / sum0, sc[0][1] / sum0),
                         pack_bf16(sc[0][2] / sum1, sc[0][3] / sum1),
                         pack_bf16(sc[1][0] / sum0, sc[1][1] / sum0),
                         pack_bf16(sc[1][2] / sum1, sc[1][3] / sum1)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float* v4 = av + 4 * j;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma_16816(o, p, movmatrix_trans(pack_bf16(v4[0], v4[1])),   // v rows 0..7, columns 8j..
              movmatrix_trans(pack_bf16(v4[2], v4[3])));        // v rows 8..15
    const int col = h * D + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < ntok)
        *reinterpret_cast<uint32_t*>(scratch + static_cast<long long>(row) * C + col) =
            pack_bf16(o[2 * half], o[2 * half + 1]);
    }
  }
}

// Tensor maps: qkv[m] are Wq, Wk, Wv with 64-row boxes; o is Wo with boxes of
// W blocks (its W blocks of a stage are consecutive rows).
struct Maps {
  CUtensorMap x, scratch, qkv[3], o;
};

// The consumer side of the weight ring. Stages are acquired in order and
// released in order, one wgmma group behind: a stage is released (one
// arrival from each consumer warp on its empty barrier) once the group issued
// after it is in flight and its own group has completed (wait_group 1).
struct ConsumerRing {
  RingPos pos;
  int pending, stages;
  uint64_t* full;
  uint64_t* empty;
  int lane;

  __device__ __forceinline__ int acquire() {
    const int s = pos.stage;
    mbar_wait(&full[s], pos.parity);
    pos.advance(stages);
    return s;
  }
  __device__ __forceinline__ void release(int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  __device__ __forceinline__ void issued(int s) {  // after the commit of stage s's group
    if (pending >= 0) {
      wgmma_wait<1>();
      release(pending);
    }
    pending = s;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    release(pending);
    pending = -1;
  }
};

// d (+)= A B with B of nb <= W 64-row blocks (N = 64 * nb).
template <int W>
__device__ __forceinline__ void wgmma_blocks(int nb, float* d, uint64_t da, uint64_t db,
                                             int scale) {
  if constexpr (W == 3) {
    if (nb == 3) {
      wgmma_ss<192>(d, da, db, scale);
      return;
    }
    if (nb == 2) {
      wgmma_ss<128>(d, da, db, scale);
      return;
    }
  }
  wgmma_ss<64>(d, da, db, scale);
}

template <int S, int W, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    fused_qkv_fwd(const __grid_constant__ Maps maps, const bf16* __restrict__ bo,
                  bf16* __restrict__ o, bf16* __restrict__ scratch, int ntok, int C,
                  int stages, int hsplit, float scale_log2) {
  constexpr int NS = TILE / S;          // whole sequences a tile
  constexpr int T = NS * S;             // tokens a tile
  constexpr int MTS = (S + 15) / 16;    // m16 tiles of one sequence
  constexpr int NTS = MTS * 2;          // n8 tiles of one sequence's logits
  constexpr int SB = W * CHUNK;         // bytes of a ring stage
  constexpr int CONSUMERS = NWG * 128;
  constexpr bool kRegAttn = S <= 16;  // a warp's 16 rows hold whole sequences
  constexpr int kStaging = kRegAttn ? 0 : STAGING;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = C / D, nk = C / D;
  const int ngroups = (H + W - 1) / W;  // groups of W 64-column blocks of the out projection
  const int xb = H * CHUNK;
  // per warpgroup w: x tile at xs_all + w * xb, later its attention tile
  unsigned char* xs_all = base;
  unsigned char* ring = xs_all + NWG * xb;
  unsigned char* stg_all = ring + stages * SB;    // per warpgroup at S > 16: q, k, v [STG][LDH]
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + NWG * kStaging);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* xfull = bars + 2 * MAX_STAGES;
  uint64_t* afull = xfull + 1;
  uint64_t* attn_ready = xfull + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // hsplit > 1: the cluster's hsplit CTAs share one tile and split its heads
  // (and the out projection's blocks, W = 1), exchanging the attention tile
  // through the scratch; else a cluster is one CTA.
  const uint32_t rank = cluster_ctarank();
  // first token of this CTA's NWG tiles (of T tokens each)
  const int cta_tok0 = blockIdx.x / hsplit * NWG * T;
  const int hper = H / hsplit, h_lo = static_cast<int>(rank) * hper;
  const int gper = hsplit > 1 ? hper : ngroups, g_lo = hsplit > 1 ? h_lo : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // every consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(afull, 1);
    mbar_init(attn_ready, hsplit);  // one arrival from each CTA that shares the tile
    fence_barrier_init();
  }
  cluster_sync();

  // Work items, in the ring's order: for each NWG heads, for each 64-column
  // chunk kc of C, one item for each head (warpgroup w takes head p + w);
  // then for each NWG groups of Wo blocks, for each kc, one item a group.
  // With W = 1 an item of the first kind is three stages (Wq, Wk, Wv).
  if (warp == NWG * 4) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int m = 0; m < 3; ++m) prefetch_tma_map(&maps.qkv[m]);
      prefetch_tma_map(&maps.o);
      RingPos pos{0, 1u};
      auto next_stage = [&]() {  // a free stage, its full barrier armed for SB bytes
        const int st = pos.stage;
        mbar_wait(&empty[st], pos.parity);
        mbar_arrive_expect_tx(&full[st], SB);  // rows past the tensor come in as zeros
        pos.advance(stages);
        return st;
      };
      prefetch_tma_map(&maps.x);
      mbar_arrive_expect_tx(xfull, NWG * xb);
      for (int w = 0; w < NWG; ++w)
        for (int kc = 0; kc < nk; ++kc)
          tma_load_2d(xs_all + w * xb + kc * CHUNK, &maps.x, xfull, kc * D, cta_tok0 + w * T);
      for (int h = h_lo; h < h_lo + hper; ++h)
        for (int kc = 0; kc < nk; ++kc) {
          if (W == 3) {  // Wq, Wk, Wv rows of the head: one [192, 64] stage
            const int st = next_stage();
            for (int m = 0; m < 3; ++m)
              tma_load_2d(ring + st * SB + m * CHUNK, &maps.qkv[m], &full[st], kc * D, h * D);
          } else {
            for (int m = 0; m < 3; ++m) {
              const int st = next_stage();
              tma_load_2d(ring + st * SB, &maps.qkv[m], &full[st], kc * D, h * D);
            }
          }
        }
      // every head's output is in the scratch: bring the tiles back
      mbar_wait_cluster(attn_ready, 0);
      mbar_arrive_expect_tx(afull, NWG * xb);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < nk; ++c)
          tma_load_2d(xs_all + w * xb + c * CHUNK, &maps.scratch, afull, c * D, cta_tok0 + w * T);
      for (int gi = g_lo; gi < g_lo + gper; ++gi)
        for (int kc = 0; kc < nk; ++kc) {  // Wo blocks of gi
          const int st = next_stage();
          tma_load_2d(ring + st * SB, &maps.o, &full[st], kc * D, gi * W * D);
        }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------------ consumers
    const int wg = warp >> 2, wwarp = warp & 3;  // this warpgroup, and this warp in it
    const int g = lane >> 2, t = lane & 3;
    // Stages are acquired and released in order, one wgmma group behind (see
    // ConsumerRing); every warpgroup takes every stage, each for its own tile.
    ConsumerRing ring_c{{0, 0u}, -1, stages, full, empty, lane};
    const int tok0 = cta_tok0 + wg * T;  // this warpgroup's tile
    unsigned char* xs = xs_all + wg * xb;
    bf16* stg = reinterpret_cast<bf16*>(stg_all + wg * kStaging);
    bf16* sq = stg;
    bf16* sk = stg + STG * LDH;
    bf16* sv = stg + 2 * STG * LDH;
    constexpr int PAD = STG - TILE;
    for (int c = tid & 127; c < (kRegAttn ? 0 : 3 * PAD * (D / 8)); c += 128) {  // past the tile
      const int m = c / (PAD * (D / 8)), r = TILE + (c / (D / 8)) % PAD, col = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(stg + m * STG * LDH + r * LDH + col) = make_uint4(0u, 0u, 0u, 0u);
    }
    mbar_wait(xfull, 0);

    float acc[96];  // q, k, v of a head (columns 64m.. of m64n192), or W blocks of the output
    for (int h = h_lo; h < h_lo + hper; ++h) {
      for (int kc = 0; kc < nk; ++kc) {
        const uint64_t da = desc_kmajor(xs + kc * CHUNK);
        if (W == 3) {
          const int s = ring_c.acquire();
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss<192>(acc, da + 2 * ks, desc_kmajor(ring + s * SB) + 2 * ks, kc > 0 || ks > 0);
          wgmma_commit();
          ring_c.issued(s);
        } else {  // Wq, Wk, Wv chunks in three stages, written out: static offsets
          auto chunk = [&](float* d) {
            const int s = ring_c.acquire();
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_ss<64>(d, da + 2 * ks, desc_kmajor(ring + s * SB) + 2 * ks, kc > 0 || ks > 0);
            wgmma_commit();
            ring_c.issued(s);
          };
          chunk(acc);
          chunk(acc + 32);
          chunk(acc + 64);
        }
      }
      ring_c.drain();
      if constexpr (kRegAttn) {
        attend_from_registers<S>(acc, scale_log2, scratch, tok0 + wwarp * 16, ntok, C, h, g, t);
        continue;
      }
      // S > 16: q, k, v rounded to bf16 into this warpgroup's staging rows,
      // once its previous head's attention is done with them
      named_sync(1 + wg, 128);
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bf16* dst = stg + m * STG * LDH + (wwarp * 16 + g) * LDH + j * 8 + 2 * t;
          const float* a = acc + 32 * m + 4 * j;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a[0], a[1]);
          *reinterpret_cast<uint32_t*>(dst + 8 * LDH) = pack_bf16(a[2], a[3]);
        }
      named_sync(1 + wg, 128);

      // attention of head h, one warp a sequence
      for (int seq = wwarp; seq < NS; seq += 4) {
        const int r0 = seq * S;
#pragma unroll
        for (int mt = 0; mt < MTS; ++mt) {
          float sc[NTS][4];
#pragma unroll
          for (int i = 0; i < NTS; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, frag_a_addr(sq, LDH, r0 + mt * 16, ks * 16, lane));
#pragma unroll
            for (int np = 0; np < MTS; ++np) {
              uint32_t bk[4];
              ldmatrix_x4(bk, frag_bt_addr(sk, LDH, r0 + np * 16, ks * 16, lane));
              mma_16816(sc[2 * np], a, bk[0], bk[1]);
              mma_16816(sc[2 * np + 1], a, bk[2], bk[3]);
            }
          }
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = nt * 8 + 2 * t + e < S;  // keys of this sequence only
              sc[nt][e] = ok ? sc[nt][e] * scale_log2 : -INFINITY;
              sc[nt][2 + e] = ok ? sc[nt][2 + e] * scale_log2 : -INFINITY;
              mx0 = fmaxf(mx0, sc[nt][e]);
              mx1 = fmaxf(mx1, sc[nt][2 + e]);
            }
          }
          mx0 = quad_max(mx0);
          mx1 = quad_max(mx1);
          float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < NTS; ++nt) {
            sc[nt][0] = exp2f(sc[nt][0] - mx0);
            sc[nt][1] = exp2f(sc[nt][1] - mx0);
            sc[nt][2] = exp2f(sc[nt][2] - mx1);
            sc[nt][3] = exp2f(sc[nt][3] - mx1);
            sum0 += sc[nt][0] + sc[nt][1];
            sum1 += sc[nt][2] + sc[nt][3];
          }
          sum0 = quad_sum(sum0);
          sum1 = quad_sum(sum1);
          uint32_t pf[NTS][2];
#pragma unroll
          for (int nt = 0; nt < NTS; ++nt) {
            pf[nt][0] = pack_bf16(sc[nt][0] / sum0, sc[nt][1] / sum0);
            pf[nt][1] = pack_bf16(sc[nt][2] / sum1, sc[nt][3] / sum1);
          }
          float ao[D / 8][4];
#pragma unroll
          for (int i = 0; i < D / 8; ++i) ao[i][0] = ao[i][1] = ao[i][2] = ao[i][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < MTS; ++kk) {
            const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                                   pf[2 * kk + 1][1]};
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, frag_a_addr(sv, LDH, r0 + kk * 16, dp * 16, lane));
              mma_16816(ao[2 * dp], a, bv[0], bv[1]);
              mma_16816(ao[2 * dp + 1], a, bv[2], bv[3]);
            }
          }
          // the head's rounded output: rows of this sequence only
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rs = mt * 16 + g + 8 * half;  // row inside the sequence
            if (rs >= S) continue;
            const int row = r0 + rs;
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt) {
              const uint32_t v = pack_bf16(ao[nt][2 * half], ao[nt][2 * half + 1]);
              const int col = nt * 8 + 2 * t;
              if (tok0 + row < ntok) {
                *reinterpret_cast<uint32_t*>(scratch + static_cast<long long>(tok0 + row) * C +
                                             h * D + col) = v;
              }
            }
          }
        }
      }
    }

    // out projection: groups of W 64-column blocks (64 rows of Wo each)
    // the out projection reads all heads' outputs back from the scratch
    fence_async_global();  // written by hand, read back by TMA
    named_sync(1 + NWG, CONSUMERS);
    if (tid == 0) {
      fence_gpu();
      if (hsplit > 1) {
        for (int r = 0; r < hsplit; ++r) mbar_arrive_remote(attn_ready, r);
      } else {
        mbar_arrive(attn_ready);
      }
    }
    mbar_wait(afull, 0);
    auto rounded = [](float f) { return __bfloat162float(__float2bfloat16(f)); };
    for (int gi = g_lo; gi < g_lo + gper; ++gi) {
      const int nb = H - gi * W < W ? H - gi * W : W;
      for (int kc = 0; kc < nk; ++kc) {
        const int s = ring_c.acquire();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_blocks<W>(nb, acc, desc_kmajor(xs + kc * CHUNK) + 2 * ks,
                          desc_kmajor(ring + s * SB) + 2 * ks, kc > 0 || ks > 0);
        wgmma_commit();
        ring_c.issued(s);
      }
      ring_c.drain();
      // round the projection to bf16, then add the bias in bf16 (the Pallas body's order)
#pragma unroll
      for (int b = 0; b < W; ++b) {
        if (b >= nb) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (gi * W + b) * D + j * 8 + 2 * t;
          const float2 bias =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bo + col));
          const float* a = acc + 32 * b + 4 * j;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wwarp * 16 + g + 8 * half;
            if (row < T && tok0 + row < ntok)
              *reinterpret_cast<uint32_t*>(o + static_cast<long long>(tok0 + row) * C + col) =
                  pack_bf16(rounded(a[2 * half]) + bias.x, rounded(a[2 * half + 1]) + bias.y);
          }
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while another may still arrive on or write into it
}

int encode_maps(Maps* maps, const void* x, const void* wq, const void* wk, const void* wv,
                const void* wo, const void* scratch, long long ntok, int C, int width) {
  const uint64_t xdims[2] = {static_cast<uint64_t>(C), static_cast<uint64_t>(ntok)};
  const uint64_t stride[1] = {static_cast<uint64_t>(C) * 2};
  const uint32_t box[2] = {D, TILE};
  int err = make_tma_map(&maps->x, x, 2, xdims, stride, box);
  if (!err) err = make_tma_map(&maps->scratch, scratch, 2, xdims, stride, box);
  const uint64_t wdims[2] = {static_cast<uint64_t>(C), static_cast<uint64_t>(C)};
  const void* w[3] = {wq, wk, wv};
  for (int m = 0; m < 3 && !err; ++m) err = make_tma_map(&maps->qkv[m], w[m], 2, wdims, stride, box);
  const uint32_t obox[2] = {D, static_cast<uint32_t>(width * TILE)};
  if (!err) err = make_tma_map(&maps->o, wo, 2, wdims, stride, obox);
  return err;
}

using Kernel = void (*)(Maps, const bf16*, bf16*, bf16*, int, int, int, int, float);

template <int S>
Kernel pick(const Plan& p) {
  if (p.width == 1) return p.groups == 2 ? fused_qkv_fwd<S, 1, 2> : fused_qkv_fwd<S, 1, 1>;
  if constexpr (S <= 16) {
    if (p.groups == 3) return fused_qkv_fwd<S, 3, 3>;
  }
  return p.groups == 2 ? fused_qkv_fwd<S, 3, 2> : fused_qkv_fwd<S, 3, 1>;
}

template <int S>
int launch(const Plan& p, const Maps& maps, const void* bo, void* o, void* scratch,
           long long ntok, int C, int hsplit, float scale_log2, cudaStream_t stream) {
  if (p.stages < 3) return static_cast<int>(cudaErrorInvalidValue);
  if (hsplit > 1 && (p.width != 1 || (C / D) % hsplit)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int T = (TILE / S) * S;
  const long long tiles = (ntok + T - 1) / T;
  const long long ctas = (tiles + p.groups - 1) / p.groups;  // NWG tiles a CTA
  const long long grid = ctas * hsplit;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(pick<S>(p),
                        dim3(static_cast<unsigned>(grid)), dim3(p.groups * 128 + 32), p.bytes,
                        hsplit, stream,
                        maps, static_cast<const bf16*>(bo), static_cast<bf16*>(o),
                        static_cast<bf16*>(scratch), static_cast<int>(ntok), C, p.stages,
                        hsplit, scale_log2);
}

// ---------------------------------------------------------------------------
// The fp32 path
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int THREADS = 256;
constexpr int KC = 16;  // depth of a staged GEMM chunk

struct Smem {
  float a[KC][TILE];         // the A operand's chunk (x or the heads' outputs), transposed
  float b[3][KC][TILE];      // up to three weights' 64-row blocks, transposed
  float qkv[3][TILE][D + 1];  // q, k, v of one head (padded rows)
};

// Columns [k0, k0 + KC) of rows [0, 64) of `a` (token rows, `arows` of them
// valid, zero past them) and of `nb` weight blocks (64 rows each) into the
// staging chunks, transposed; one float4 a thread and operand.
__device__ __forceinline__ void stage_chunk(Smem& sm, const float* a, int arows,
                                            const float* const* b, int nb, long long C, int k0,
                                            int tid) {
  const int r = tid / 4, cc = (tid % 4) * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 av = r < arows ? *reinterpret_cast<const float4*>(a + r * C + k0 + cc) : zero;
  float4 bv[3];
  for (int m = 0; m < nb; ++m) bv[m] = *reinterpret_cast<const float4*>(b[m] + r * C + k0 + cc);
  __syncthreads();  // the previous chunk is consumed
  sm.a[cc][r] = av.x;
  sm.a[cc + 1][r] = av.y;
  sm.a[cc + 2][r] = av.z;
  sm.a[cc + 3][r] = av.w;
  for (int m = 0; m < nb; ++m) {
    sm.b[m][cc][r] = bv[m].x;
    sm.b[m][cc + 1][r] = bv[m].y;
    sm.b[m][cc + 2][r] = bv[m].z;
    sm.b[m][cc + 3][r] = bv[m].w;
  }
  __syncthreads();
}

// acc[m] += the chunk's A rows 4ty.. times weight block m's rows 4tx.. .
template <int NB>
__device__ __forceinline__ void chunk_product(const Smem& sm, float (&acc)[NB][4][4], int ty,
                                              int tx) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&sm.a[kk][4 * ty]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[m][kk][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][i][j] = fmaf(av[i], bv[j], acc[m][i][j]);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    fused_qkv_fwd(const float* __restrict__ x, const float* __restrict__ wq,
                  const float* __restrict__ wk, const float* __restrict__ wv,
                  const float* __restrict__ wo, const float* __restrict__ bo,
                  float* __restrict__ o, float* scratch, long long ntok, int C,
                  float scale_log2) {
  constexpr int T = (TILE / S) * S;  // tokens a tile: whole sequences
  extern __shared__ __align__(16) unsigned char smem_raw_f32[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw_f32);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long tok0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T), ntok - tok0));
  const long long CC = C;
  const float* xt = x + tok0 * CC;
  float* st = scratch + tok0 * CC;

  // the attention's threads: four a token row, 16 dimensions each; rows past
  // T (S = 24) compute on row 0 and store nothing
  const int ar = tid / 4, part = tid % 4;
  const int row = ar < T ? ar : 0, seq0 = (row / S) * S;

  for (int h = 0; h < C / D; ++h) {
    float acc[3][4][4] = {};
    const float* w[3] = {wq + h * D * CC, wk + h * D * CC, wv + h * D * CC};
    for (int k0 = 0; k0 < C; k0 += KC) {
      stage_chunk(sm, xt, rows, w, 3, CC, k0, tid);
      chunk_product<3>(sm, acc, ty, tx);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.qkv[m][4 * ty + i][4 * tx + j] = acc[m][i][j];
    __syncthreads();

    float s[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dot = fmaf(sm.qkv[0][row][16 * part + i], sm.qkv[1][seq0 + j][16 * part + i], dot);
      s[j] = dot;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
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
    if (ar < rows) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float out = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) out = fmaf(s[j] * inv, sm.qkv[2][seq0 + j][16 * part + i], out);
        st[ar * CC + h * D + 16 * part + i] = out;
      }
    }
    __syncthreads();  // q, k, v consumed before the next head's overwrite them
  }

  // the out projection over the heads' outputs, read back from the scratch
  for (int cb = 0; cb < C / D; ++cb) {
    float acc[1][4][4] = {};
    const float* w[1] = {wo + cb * D * CC};
    for (int k0 = 0; k0 < C; k0 += KC) {
      stage_chunk(sm, st, rows, w, 1, CC, k0, tid);
      chunk_product<1>(sm, acc, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= rows) continue;
      const int col = cb * D + 4 * tx;
      *reinterpret_cast<float4*>(o + (tok0 + r) * CC + col) =
          make_float4(acc[0][i][0] + bo[col], acc[0][i][1] + bo[col + 1],
                      acc[0][i][2] + bo[col + 2], acc[0][i][3] + bo[col + 3]);
    }
  }
}

template <int S>
int launch(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
           const void* bo, void* o, void* scratch, long long ntok, int C, float scale_log2,
           cudaStream_t stream) {
  constexpr int T = (TILE / S) * S;
  constexpr int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (ntok + T - 1) / T;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_qkv_fwd<S><<<static_cast<unsigned>(grid), THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wq), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(o), static_cast<float*>(scratch), ntok, C, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// The fp32 path: fp32 x, weights, bias, o and scratch; no head split
// (hsplit must be 1).
extern "C" int moca_fused_qkv_attention_f32(const void* x, const void* wq, const void* wk,
                                            const void* wv, const void* wo, const void* bo,
                                            void* o, void* scratch, long long N, int S, int C,
                                            int hsplit, float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntok = N * S;
  if (!scratch || C <= 0 || C % D != 0 || C > 1280 || ntok <= 0 || hsplit != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 8: return f32::launch<8>(x, wq, wk, wv, wo, bo, o, scratch, ntok, C, scale_log2, st);
    case 16: return f32::launch<16>(x, wq, wk, wv, wo, bo, o, scratch, ntok, C, scale_log2, st);
    case 24: return f32::launch<24>(x, wq, wk, wv, wo, bo, o, scratch, ntok, C, scale_log2, st);
    case 32: return f32::launch<32>(x, wq, wk, wv, wo, bo, o, scratch, ntok, C, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// hsplit: CTAs of a cluster that split one tile's heads (1, 2, 4 or 8; the
// wrapper's `fused_qkv_head_split`).
extern "C" int moca_fused_qkv_attention(const void* x, const void* wq, const void* wk,
                                        const void* wv, const void* wo, const void* bo, void* o,
                                        void* scratch, long long N, int S, int C, int hsplit,
                                        float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntok = N * S;
  if (!scratch || C <= 0 || C % D != 0 || C > 1280 || ntok <= 0 || ntok > 0x7fffffffLL ||
      (S != 8 && S != 16 && S != 24 && S != 32) ||
      (hsplit != 1 && hsplit != 2 && hsplit != 4 && hsplit != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int T = (TILE / S) * S;
  const Plan p = plan(C, S, (ntok + T - 1) / T, sms);
  Maps maps;
  const int err = encode_maps(&maps, x, wq, wk, wv, wo, scratch, ntok, C, p.width);
  if (err) return err;
  switch (S) {
    case 8: return launch<8>(p, maps, bo, o, scratch, ntok, C, hsplit, scale_log2, st);
    case 16: return launch<16>(p, maps, bo, o, scratch, ntok, C, hsplit, scale_log2, st);
    case 24: return launch<24>(p, maps, bo, o, scratch, ntok, C, hsplit, scale_log2, st);
    case 32: return launch<32>(p, maps, bo, o, scratch, ntok, C, hsplit, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
