// Warp-level building blocks shared by the attention kernels (sm_90a).
//
// bf16 tensor-core products through `mma.sync.m16n8k16` with fp32
// accumulation, `ldmatrix` fragment loads from shared memory and 16-byte
// `cp.async` copies from device memory. Fragment layouts follow the PTX ISA
// ("Matrix Fragments for mma.m16n8k16"): with g = lane / 4 and t = lane % 4,
//   A (16x16, row major): reg0 = (g, 2t..2t+1), reg1 = (g+8, 2t..),
//                         reg2 = (g, 2t+8..),    reg3 = (g+8, 2t+8..)
//   B (16x8, col major):  reg0 = (k 2t..2t+1, n g), reg1 = (k 2t+8.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
//
// And fp32 products in 3xTF32 through `mma.sync.m16n8k8.tf32` (the fp32 paths
// of K1, K3 and K4): each operand split as x = hi + lo with hi a tf32 value,
// hi*hi + hi*lo + lo*hi summed in fp32 accumulators, within ~2^-21 of an
// fp32 product. Fragments of m16n8k8.tf32: A a0 (g, k t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C as above.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace moca {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy device memory -> shared memory (L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on a 16x8x16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8x8 b16 matrix held across the warp, each lane (g, t)
// holding elements (g, 2t..2t+1): afterwards it holds (2t, g) and (2t+1, g).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// Two floats -> packed bf16x2 (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row-wise reductions over the four lanes (t = 0..3) that share a C row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Address (for this lane) of the x4 ldmatrix that yields the A fragment of
// the 16x16 tile at (row0, col0) of a row-major [rows][ld] bf16 array. The
// same address pattern with .trans yields the B fragments of two adjacent
// n8 tiles of a row-major [k][n] operand (P.V with V stored [kv][d]).
__device__ __forceinline__ const bf16* frag_a_addr(const bf16* base, int ld, int row0, int col0,
                                                   int lane) {
  return base + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// Address of the x4 ldmatrix that yields the B fragments of two adjacent n8
// tiles (n0, n0+8) for one k16 step when B[k][n] = M[n][k] (Q.K^T with K
// stored [kv][d]): regs 0,1 -> tile n0, regs 2,3 -> tile n0+8.
__device__ __forceinline__ const bf16* frag_bt_addr(const bf16* base, int ld, int n0, int k0,
                                                    int lane) {
  return base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

// x = hi + lo exactly: hi is x rounded to the nearest tf32 value on its bit
// pattern (half a tf32 unit added to the magnitude, the low 13 bits cleared:
// two integer instructions), 11 significant bits the products read exactly;
// lo = x - hi (exact) has at most 12, of which the products read the top 11
// (a 2^-22 x truncation). Veltkamp's split (x * 8193, three subtractions, the
// same hi but at ties) takes four FP32 instructions, and K3's fp32 path ran
// slower with it on an H100; cvt.rna.tf32.f32 for hi and lo made K1's slower.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a * b on a 16x8x8 tile, tf32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment split into its hi and lo parts.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.hi[i], f.lo[i]);
  return f;
}

// c += a * b in 3xTF32: the small products first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

}  // namespace moca
