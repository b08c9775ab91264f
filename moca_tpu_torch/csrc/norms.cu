// The port's norms: GroupNorm (with SiLU where asked) over channels-last
// [N, M, C] and LayerNorm over the last axis [R, C]; bf16, fp16 or fp32 in and
// out, fp32 statistics, the affine map and SiLU in fp32, one rounding to the
// input's type at the end.
//
// Replaces no Pallas kernel. It stands beside `GroupNorm32`
// (moca_tpu/ops/norms.py:74-135) and the U-Net's `_LayerNorm32`
// (moca_tpu/models/unet3d.py:439-449), which are plain JAX: on the TPU, XLA
// fuses the normalise and SiLU into the next convolution's input, and a Pallas
// GroupNorm lost there (moca_tpu/ops/norms.py:104-111). The port runs eagerly
// and nothing fuses, so the plain chain (fp32 copy, var_mean, subtract, rsqrt,
// scale, affine, SiLU, cast) ran as a dozen kernels, each reading or writing a
// whole fp32 copy of the activation: ~56 bytes an element, half of every U-Net
// call.
//
// What bounds it on an H100: bytes. A norm does a few operations an element,
// far below the ~295 operations a byte at which the card's arithmetic would be
// the limit. The least traffic for a GroupNorm is one read for the statistics,
// then one read and one write to apply them (6 bytes an element in bf16): the
// statistics of a group cover a whole frame (or a whole row of 16 frames) that
// no block can hold. A LayerNorm's row fits in one warp's registers: one read
// and one write (4 bytes an element in bf16).
//
// GroupNorm, three launches from one C call (`moca_group_norm`):
//   1. `group_norm_stats`: a block takes one chunk of rows of one n. Each
//      thread owns one 16-byte vector of channels (8 bf16) and walks the chunk's
//      rows with a stride of the block's thread rows, keeping a Welford mean and
//      M2 a channel in fp32. The block writes those to shared memory and each
//      warp combines a group's (thread row, channel) entries into one (mean,
//      M2) partial for (n, chunk, group): their weighted mean, then M2 about
//      it (sum of M2_e + count_e * (mean_e - mean)^2), two passes over the
//      entries and no division per entry.
//   2. `group_norm_finalize`: a warp a (n, group) combines the chunks' partials
//      the same way into mean and rstd = rsqrt(M2 / count + eps).
//   3. `group_norm_apply`: a block takes one chunk of rows of one n; each thread
//      first forms, for its channels, a = w * rstd and b' = bias - mean * a (the
//      affine read in its stored type and widened), then streams y = x * a + b',
//      SiLU where asked (y / (1 + exp(-y)) on the fast exponent and division),
//      rounded once to the input's type.
//   The wrapper (ops/norms.py `group_norm_plan`) chooses the chunks from N, M
//   and C so that the launch fills the card both for per-frame slabs (N = B*T,
//   M = H*W) and for whole rows (N = B, M = T*H*W), and passes a float scratch
//   for the partials and the statistics. Counts come from the shapes, so no
//   partial stores one.
//
// LayerNorm, one launch (`moca_layer_norm`): a warp a row. Where the row is
// whole 16-byte vectors and at most 8 (bf16, fp16) or 16 (fp32) of them a lane
// (C <= 2048), `layer_norm_rows` loads it into registers once, takes the mean
// and then the variance from the registers (two passes over registers, no
// E[x^2] - E[x]^2), and writes ((x - mean) * rstd) * w + b. Any other row
// (`layer_norm_rows_any`: C not a multiple of a vector, an unaligned pointer,
// or C > 2048) is read three times, the last two from the cache.
//
// Inputs are contiguous (the wrapper makes them so); the affine is in the
// input's type or fp32 (`W`), as the wrapper passes it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// N values of T loaded or stored as one access (two where they span 32 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of a chunk: chunk k of `rpc` rows, the last one ragged.
__device__ __forceinline__ int chunk_rows(long long M, long long rpc, int k) {
  const long long r0 = k * rpc, r1 = r0 + rpc < M ? r0 + rpc : M;
  return static_cast<int>(r1 > r0 ? r1 - r0 : 0);
}

constexpr int kUnroll = 4;       // rows a thread has in flight: statistics
constexpr int kUnrollApply = 8;  // and the map

// ---------------------------------------------------------------------------
// GroupNorm
// ---------------------------------------------------------------------------

// grid N * chunks, block (C / VEC, R) with at least one whole warp; dynamic
// shared memory 2 * R * C floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(1024)
group_norm_stats(const T* __restrict__ x, float2* __restrict__ part, long long M, int C, int G,
                 int chunks, long long rpc) {
  extern __shared__ float smem[];
  const int n = blockIdx.x / chunks, k = blockIdx.x % chunks;
  const int tx = threadIdx.x, ty = threadIdx.y, R = blockDim.y;
  const int len = chunk_rows(M, rpc, k);
  const T* base = x + (static_cast<size_t>(n) * M + static_cast<size_t>(k) * rpc) * C + tx * VEC;

  float mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  int cnt = 0;
  auto update = [&](const Pack<T, VEC>& p) {
    const float inv = 1.f / static_cast<float>(++cnt);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f(p.v[i]), d = v - mean[i];
      mean[i] = fmaf(d, inv, mean[i]);
      m2[i] = fmaf(d, v - mean[i], m2[i]);
    }
  };
  int r = ty;
  for (; r + (kUnroll - 1) * R < len; r += kUnroll * R) {
    Pack<T, VEC> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = load<T, VEC>(base + static_cast<size_t>(r + u * R) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) update(p[u]);
  }
  for (; r < len; r += R) update(load<T, VEC>(base + static_cast<size_t>(r) * C));

  float* s_mean = smem;
  float* s_m2 = smem + R * C;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[ty * C + tx * VEC + i] = mean[i];
    s_m2[ty * C + tx * VEC + i] = m2[i];
  }
  __syncthreads();

  // a whole warp a group (the block's last warp may be partial and takes
  // none): the weighted mean of the group's (thread row, channel) entries,
  // then their M2 about it, M2_e + count_e * (mean_e - mean)^2
  const int tid = ty * blockDim.x + tx, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x * R / 32, gs = C / G;
  if (warp >= warps) return;
  const int each = len / R, extra = len % R;  // thread row rr walked each + (rr < extra) rows
  const float total = static_cast<float>(len) * gs;
  for (int g = warp; g < G; g += warps) {
    float s = 0.f;
    for (int c = g * gs + lane; c < (g + 1) * gs; c += 32)
      for (int rr = 0; rr < R; ++rr) s = fmaf(static_cast<float>(each + (rr < extra)), s_mean[rr * C + c], s);
    const float mu = warp_sum(s) / total;
    float q = 0.f;
    for (int c = g * gs + lane; c < (g + 1) * gs; c += 32)
      for (int rr = 0; rr < R; ++rr) {
        const float d = s_mean[rr * C + c] - mu;
        q += fmaf(static_cast<float>(each + (rr < extra)) * d, d, s_m2[rr * C + c]);
      }
    q = warp_sum(q);
    if (lane == 0) part[(static_cast<size_t>(n) * chunks + k) * G + g] = make_float2(mu, q);
  }
}

// a warp a (n, group): the chunks' partials, combined as the block's entries
// are (the weighted mean, then M2 about it), -> (mean, rstd)
__global__ void __launch_bounds__(256)
group_norm_finalize(const float2* __restrict__ part, float2* __restrict__ stats, int NG, long long M,
                    int G, int gs, int chunks, long long rpc, float eps) {
  const int idx = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (idx >= NG) return;
  const int n = idx / G, g = idx % G;
  const float2* p = part + static_cast<size_t>(n) * chunks * G + g;
  const float total = static_cast<float>(M) * gs;
  float s = 0.f;
  for (int k = lane; k < chunks; k += 32)
    s = fmaf(static_cast<float>(chunk_rows(M, rpc, k)) * gs, p[static_cast<size_t>(k) * G].x, s);
  const float mu = warp_sum(s) / total;
  float q = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    const float2 e = p[static_cast<size_t>(k) * G];
    const float d = e.x - mu;
    q += fmaf(static_cast<float>(chunk_rows(M, rpc, k)) * gs * d, d, e.y);
  }
  q = warp_sum(q);
  if (lane == 0) stats[idx] = make_float2(mu, rsqrtf(q / total + eps));
}

template <typename T, typename W, int VEC, bool SILU>
__global__ void __launch_bounds__(1024)
group_norm_apply(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                 const float2* __restrict__ stats, T* __restrict__ y, long long M, int C, int G,
                 int chunks, long long rpc) {
  const int n = blockIdx.x / chunks, k = blockIdx.x % chunks;
  const int tx = threadIdx.x, ty = threadIdx.y, R = blockDim.y;
  const int len = chunk_rows(M, rpc, k), gs = C / G;
  const size_t off = (static_cast<size_t>(n) * M + static_cast<size_t>(k) * rpc) * C + tx * VEC;
  const T* xb = x + off;
  T* yb = y + off;

  float sc[VEC], sh[VEC];  // y = x * (w * rstd) + (bias - mean * w * rstd)
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = tx * VEC + i;
    const float2 st = stats[static_cast<size_t>(n) * G + c / gs];
    sc[i] = to_f(w[c]) * st.y;
    sh[i] = fmaf(-st.x, sc[i], to_f(b[c]));
  }
  auto apply = [&](const Pack<T, VEC>& p) {
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = fmaf(to_f(p.v[i]), sc[i], sh[i]);
      if (SILU) v = __fdividef(v, 1.f + __expf(-v));  // 0 where exp(-v) passes 2^126
      o.v[i] = from_f<T>(v);
    }
    return o;
  };
  int r = ty;
  for (; r + (kUnrollApply - 1) * R < len; r += kUnrollApply * R) {
    Pack<T, VEC> p[kUnrollApply];
#pragma unroll
    for (int u = 0; u < kUnrollApply; ++u) p[u] = load<T, VEC>(xb + static_cast<size_t>(r + u * R) * C);
#pragma unroll
    for (int u = 0; u < kUnrollApply; ++u) store<T, VEC>(yb + static_cast<size_t>(r + u * R) * C, apply(p[u]));
  }
  for (; r < len; r += R)
    store<T, VEC>(yb + static_cast<size_t>(r) * C, apply(load<T, VEC>(xb + static_cast<size_t>(r) * C)));
}

template <typename T, typename W, int VEC>
int group_norm_launch(const T* x, const W* w, const W* b, T* y, float* scratch, long long N,
                      long long M, int C, int G, int rows, int chunks, long long rpc, float eps,
                      bool silu, cudaStream_t stream) {
  float2* part = reinterpret_cast<float2*>(scratch);
  float2* stats = part + static_cast<size_t>(N) * chunks * G;
  const dim3 block(C / VEC, rows);
  const unsigned grid = static_cast<unsigned>(N * chunks);
  const size_t smem = 2 * sizeof(float) * rows * C;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(group_norm_stats<T, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  group_norm_stats<T, VEC><<<grid, block, smem, stream>>>(x, part, M, C, G, chunks, rpc);
  const int NG = static_cast<int>(N * G);
  group_norm_finalize<<<(NG + 7) / 8, 256, 0, stream>>>(part, stats, NG, M, G, C / G, chunks, rpc,
                                                          eps);
  if (silu)
    group_norm_apply<T, W, VEC, true><<<grid, block, 0, stream>>>(x, w, b, stats, y, M, C, G, chunks, rpc);
  else
    group_norm_apply<T, W, VEC, false><<<grid, block, 0, stream>>>(x, w, b, stats, y, M, C, G, chunks, rpc);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 8;  // warps a block, a row each

// A row of C = V * VEC values in registers, NV vectors a lane.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_rows(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                T* __restrict__ y, long long R, int C, float eps) {
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31, V = C / VEC;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[NV][VEC];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lane + 32 * j;
    if (vi < V) {
      const Pack<T, VEC> p = load<T, VEC>(xr + vi * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[j][i] = to_f(p.v[i]);
        s += v[j][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = 0.f;
    }
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < V) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[j][i] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lane + 32 * j;
    if (vi < V) {
      const Pack<W, VEC> pw = load<W, VEC>(w + vi * VEC), pb = load<W, VEC>(b + vi * VEC);
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o.v[i] = from_f<T>(fmaf((v[j][i] - mean) * rstd, to_f(pw.v[i]), to_f(pb.v[i])));
      store<T, VEC>(yr + vi * VEC, o);
    }
  }
}

// Any row: read three times, value by value (the last two reads from the cache).
template <typename T, typename W>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_rows_any(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                    T* __restrict__ y, long long R, int C, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<T>(fmaf((to_f(xr[c]) - mean) * rstd, to_f(w[c]), to_f(b[c])));
}

template <typename T, typename W>
int layer_norm_launch(const T* x, const W* w, const W* b, T* y, long long R, int C, int nv,
                      float eps, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  const unsigned block = 32 * kRowsPerBlock;
#define MOCA_LN(NV)                                                                 \
  case NV:                                                                          \
    layer_norm_rows<T, W, NV><<<grid, block, 0, stream>>>(x, w, b, y, R, C, eps); \
    break;
  switch (nv) {
    MOCA_LN(1) MOCA_LN(2) MOCA_LN(3) MOCA_LN(4) MOCA_LN(5) MOCA_LN(6) MOCA_LN(8)
    case 10: case 12: case 16:
      // fp32 rows only (4 values a vector): more than 8 vectors a lane
      if constexpr (sizeof(T) == 4) {
        if (nv == 10) layer_norm_rows<T, W, 10><<<grid, block, 0, stream>>>(x, w, b, y, R, C, eps);
        else if (nv == 12) layer_norm_rows<T, W, 12><<<grid, block, 0, stream>>>(x, w, b, y, R, C, eps);
        else layer_norm_rows<T, W, 16><<<grid, block, 0, stream>>>(x, w, b, y, R, C, eps);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    case 0:
      layer_norm_rows_any<T, W><<<grid, block, 0, stream>>>(x, w, b, y, R, C, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MOCA_LN
  return static_cast<int>(cudaGetLastError());
}

// dtype codes, as the wrapper passes them: 0 fp32, 1 bf16, 2 fp16
template <template <typename, typename> class F, typename... Args>
int by_dtype(int dtype, int w_f32, Args... args) {
  switch (dtype) {
    case 0: return F<float, float>::run(args...);
    case 1: return w_f32 ? F<bf16, float>::run(args...) : F<bf16, bf16>::run(args...);
    case 2: return w_f32 ? F<__half, float>::run(args...) : F<__half, __half>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename W>
struct GroupNormCall {
  static int run(const void* x, const void* w, const void* b, void* y, void* scratch, long long N,
                 long long M, int C, int G, int vec, int rows, int chunks, long long rpc, float eps,
                 int silu, cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    const W* wt = static_cast<const W*>(w);
    const W* bt = static_cast<const W*>(b);
    T* yt = static_cast<T*>(y);
    float* s = static_cast<float*>(scratch);
    if (vec == 16 / static_cast<int>(sizeof(T)))
      return group_norm_launch<T, W, static_cast<int>(16 / sizeof(T))>(xt, wt, bt, yt, s, N, M, C, G, rows, chunks,
                                                     rpc, eps, silu, stream);
    if (vec == 1)
      return group_norm_launch<T, W, 1>(xt, wt, bt, yt, s, N, M, C, G, rows, chunks, rpc, eps,
                                        silu, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

template <typename T, typename W>
struct LayerNormCall {
  static int run(const void* x, const void* w, const void* b, void* y, long long R, int C, int nv,
                 float eps, cudaStream_t stream) {
    return layer_norm_launch<T, W>(static_cast<const T*>(x), static_cast<const W*>(w),
                                   static_cast<const W*>(b), static_cast<T*>(y), R, C, nv, eps,
                                   stream);
  }
};

}  // namespace

// GroupNorm of x [N, M, C] (contiguous) over G groups of C / G channels into y.
// `vec`: values a thread loads at once (16 bytes' worth, or 1 where C is not
// whole vectors or x is unaligned); `rows`: thread rows a block, with
// C / vec * rows <= 1024; chunks of `rpc` rows each (the last ragged), `chunks`
// of them an n. `scratch`: N * G * (chunks + 1) float2. 0 or a CUDA error.
extern "C" int moca_group_norm(const void* x, const void* w, const void* b, void* y, void* scratch,
                               int dtype, int w_f32, long long N, long long M, int C, int G,
                               int vec, int rows, int chunks, long long rpc, float eps, int silu,
                               void* stream) {
  return by_dtype<GroupNormCall>(dtype, w_f32, x, w, b, y, scratch, N, M, C, G, vec, rows, chunks,
                                 rpc, eps, silu, static_cast<cudaStream_t>(stream));
}

// LayerNorm of x [R, C] (contiguous) over its last axis into y; `nv`: 16-byte
// vectors a lane holds (0: the any-row kernel). 0 or a CUDA error.
extern "C" int moca_layer_norm(const void* x, const void* w, const void* b, void* y, int dtype,
                               int w_f32, long long R, int C, int nv, float eps, void* stream) {
  return by_dtype<LayerNormCall>(dtype, w_f32, x, w, b, y, R, C, nv, eps,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
