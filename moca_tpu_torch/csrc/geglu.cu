// The U-Net feed-forward's GEGLU: y[r, j] = x * gelu_tanh(gate) with
// x = h[r, j] and gate = h[r, F + j], on the projection's output h [R, 2F]
// (contiguous) into y [R, F]; bf16, fp16 or fp32 in and out, the gelu and the
// product in fp32, one rounding to the input's type at the end.
//
// Replaces no Pallas kernel: the JAX package leaves GEGLU to XLA
// (moca_tpu/models/unet3d.py:410-420), which fuses the split, the gelu and the
// product into one pass over the projection's output. The port runs eagerly:
// `chunk` made two views with a row stride of 2F, and `F.gelu` and the product
// each ran PyTorch's strided elementwise kernel (read the gate, write the
// gelu; read x and the gelu, write y): 10 bytes an output element in bf16.
//
// What bounds it on an H100: bytes. One read of h and one write of y, 3
// elements an output column (6 bytes in bf16, 12 in fp32), at 3.35 TB/s; the
// gelu's dozen operations and one tanhf an element are far below the rate at
// which the card's arithmetic would be the limit.
//
// Design: a thread takes VEC consecutive output columns of a row (one 16-byte
// vector: 8 bf16 or fp16, 4 fp32): two 16-byte loads, x at h[r, j:j+VEC] and
// the gate at h[r, F+j:F+j+VEC], and one 16-byte store, with streaming cache
// hints (`__ldcs`, `__stcs`): nothing is read twice, and the stream's largest
// projection (3.4 GB) passes through the 50 MB L2 many times over. The grid is
// sized to the card (the wrapper's `geglu_plan`); each thread walks the
// vectors with a grid stride, two vectors in flight. Where F is not whole
// vectors or a pointer is not 16-byte aligned, VEC is 1: the same loop, a
// value at a time, plain loads. Offsets are 32-bit where R * 2F fits.
//
// The gelu is PyTorch's tanh form as its GeluCUDAKernelImpl computes it in
// fp32: 0.5 g (1 + tanhf(sqrt(2/pi) (g + 0.044715 g^3))), with the accurate
// tanhf (no tanh.approx.f32).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;  // a block's threads, at most (the wrapper's GEGLU_THREADS)

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// a 16-byte vector with the streaming hints, or one value
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> out;
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(&out) = __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.v[i] = p[i];
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  if constexpr (sizeof(T) * VEC == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v.v[i];
  }
}

__device__ __forceinline__ float gelu_tanh(float g) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float cube = g * g * g;
  const float inner = kBeta * (g + kKappa * cube);
  return 0.5f * g * (1.f + tanhf(inner));
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> geglu_pack(const Pack<T, VEC>& x, const Pack<T, VEC>& g) {
  Pack<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f<T>(to_f(x.v[i]) * gelu_tanh(to_f(g.v[i])));
  return o;
}

// nvec = R * fv vectors of y, fv = F / VEC a row; vector v of y is row
// r = v / fv, column (v - r * fv) * VEC, and its x lies at (v + r * fv) * VEC
// in h (rows of 2 fv vectors), its gate F values further.
template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kMaxThreads)
geglu_rows(const T* __restrict__ h, T* __restrict__ y, I nvec, I fv) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I half = fv * VEC;
  I v = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; v + stride < nvec; v += 2 * stride) {
    const I v1 = v + stride;
    const I o0 = (v + v / fv * fv) * VEC, o1 = (v1 + v1 / fv * fv) * VEC;
    const Pack<T, VEC> x0 = load<T, VEC>(h + o0), g0 = load<T, VEC>(h + o0 + half);
    const Pack<T, VEC> x1 = load<T, VEC>(h + o1), g1 = load<T, VEC>(h + o1 + half);
    store<T, VEC>(y + v * VEC, geglu_pack(x0, g0));
    store<T, VEC>(y + v1 * VEC, geglu_pack(x1, g1));
  }
  if (v < nvec) {
    const I o = (v + v / fv * fv) * VEC;
    store<T, VEC>(y + v * VEC, geglu_pack(load<T, VEC>(h + o), load<T, VEC>(h + o + half)));
  }
}

template <typename T, int VEC>
int geglu_run(const void* h, void* y, long long R, long long F, int blocks, int threads,
              cudaStream_t stream) {
  const unsigned long long fv = F / VEC, nvec = static_cast<unsigned long long>(R) * fv;
  const T* ht = static_cast<const T*>(h);
  T* yt = static_cast<T*>(y);
  if (static_cast<unsigned long long>(R) * 2 * F < (1ull << 32))
    geglu_rows<T, VEC, unsigned><<<blocks, threads, 0, stream>>>(
        ht, yt, static_cast<unsigned>(nvec), static_cast<unsigned>(fv));
  else
    geglu_rows<T, VEC, unsigned long long><<<blocks, threads, 0, stream>>>(ht, yt, nvec, fv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int geglu_launch(const void* h, void* y, long long R, long long F, int vec, int blocks,
                 int threads, cudaStream_t stream) {
  constexpr int V = static_cast<int>(16 / sizeof(T));
  if (R <= 0 || F <= 0 || blocks <= 0 || threads <= 0 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == V && F % V == 0) return geglu_run<T, V>(h, y, R, F, blocks, threads, stream);
  if (vec == 1) return geglu_run<T, 1>(h, y, R, F, blocks, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// GEGLU of h [R, 2F] (contiguous) into y [R, F]: dtype 0 fp32, 1 bf16, 2 fp16;
// `vec`: values a thread loads at once (16 bytes' worth, or 1 where F is not
// whole vectors or a pointer is unaligned); `blocks` x `threads` (at most 256)
// walk the vectors with a grid stride. 0 or a CUDA error.
extern "C" int moca_geglu(const void* h, void* y, int dtype, long long R, long long F, int vec,
                          int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return geglu_launch<float>(h, y, R, F, vec, blocks, threads, s);
    case 1: return geglu_launch<bf16>(h, y, R, F, vec, blocks, threads, s);
    case 2: return geglu_launch<__half>(h, y, R, F, vec, blocks, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
