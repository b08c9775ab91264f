// MoCA's window step over every FIFO window in one launch: for each window r
// and batch row b, the diagonal DDIM step of its f frames with momentum
// correction (and, with `inject_into_queue`, concept injection), written
// straight into the new queue and, where asked, into the queue-aligned
// pre-injection pred_x0. fp32 in and out.
//
// Replaces no Pallas kernel: the JAX package runs `moca_window_step`
// (moca_tpu/sampling/moca.py:63-168) as a `lax.scan` that XLA fuses. The port
// ran it eagerly (sampling/moca.py `moca_window_step`, still the path of CPU
// tensors): a Python loop over R windows x f frames of ~30
// small PyTorch ops each, then a concatenation into the queue, ~3,800 launches
// an iteration on [1, 40, 64, 4] frames. The card ran each in ~1-2 us and
// waited ~10-15 us for the host to issue the next.
//
// What bounds it on an H100: launches, then bytes. One read of each queue
// slot (the windows overlap; a slot's second read comes from L2), of eps and
// of the step noise, one write of each slot of the new queue (and of
// pred_x0): ~16 MB an iteration at the stream's shape, a ~5 us floor at
// 3.35 TB/s.
//
// Design: a thread takes one vector of VEC consecutive fp32 values (4, one
// 16-byte load, where a frame is whole vectors and every pointer aligned;
// else 1) of one frame slot, for one (r, b), and walks the window's frames
// j = 0..f-1 in order, carrying the previous frame's pred_x0 and the momentum
// in registers. Per (r, j), the frame table (`table`, TABLE_COLUMNS of
// ops/moca_scan.py, built once on the host) gives the step's scalars, and the
// slot table (`slots`: source slot, destination slot or -1, and whether the
// destination keeps the old value) says where the frame is read and written:
// with lookahead, window 0's frames [0, f/2) copy the queue's immutable
// prefix and every window commits its frames [f/2, f), the tiling of
// `_scatter_windows`; pred_x0 lands at the same destinations (window 0's
// first half included, as `scatter_pred_x0` tiles it).
//
// The arithmetic is `moca_window_step`'s, op for op, in its order, each
// rounded to fp32 (the _rn intrinsics keep nvcc from contracting a product
// and a sum into one FMA, which PyTorch's separate kernels do not do), so the
// kernel reproduces the eager loop on the card to the bit.
//
// The mask gate (`sum(masks[:, slot]) > 0`, over every batch row and pixel of
// a queue slot) only matters where injection reaches the queue: with
// `inject_into_queue` off, injection changes only the blended pred_x0 that
// FIFO discards. Where masks are passed, `mask_gate` reduces each of the Q
// slots first (a block a slot), on the same stream.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // a block's threads, at most
constexpr int kGateThreads = 256;

// the frame table's columns (ops/moca_scan.py TABLE_COLUMNS)
enum Col {
  kSqrtOneMinusAlpha,
  kSqrtAlpha,
  kDirCoef,
  kSqrtAlphaPrev,
  kSigma,
  kStrength,
  kMomentum,
  kFactor,
  kInject,
  kCols
};
// the slot table's columns (ops/moca_scan.py SLOT_COLUMNS)
enum Slot { kSrc, kDst, kKeep, kSlotCols };

__global__ void __launch_bounds__(kGateThreads)
mask_gate(const float* __restrict__ masks, int* __restrict__ gate, int rows, int Q,
          long long hw) {
  const int q = blockIdx.x;
  float s = 0.f;
  for (int b = 0; b < rows; ++b) {
    const float* m = masks + (static_cast<long long>(b) * Q + q) * hw;
    for (long long p = threadIdx.x; p < hw; p += blockDim.x) s += m[p];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ float part[kGateThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kGateThreads / 32; ++w) t += part[w];
    gate[q] = t > 0.f;
  }
}

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> out;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = t.x, out.v[1] = t.y, out.v[2] = t.z, out.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.v[i] = __ldg(p + i);
  }
  return out;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x.v[i];
  }
}

// Thread t takes vector v = t % nv of window r's batch row b, (r, b) = (t / nv)
// as r * B + b; nv = frame / VEC vectors a frame slot. Queue and outputs
// [B, Q, frame], eps [R, B, f, frame], noise [R, f, frame] (shared by the B
// rows), masks [mask_rows, Q, frame / C] (a row of 1 broadcasts over B), cond
// [cond_rows, frame] or null (zeros).
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
moca_scan_rows(const float* __restrict__ queue, const float* __restrict__ eps,
               const float* __restrict__ noise, const float* __restrict__ masks,
               const float* __restrict__ cond, const int* __restrict__ gate,
               const float* __restrict__ table, const int* __restrict__ slots,
               float* __restrict__ out, float* __restrict__ pred, int R, int B, int f, int Q,
               long long frame, int C, long long mask_row, long long cond_row, float beta,
               float one_minus_beta, float dir_weight) {
  const long long nv = frame / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(R) * B * nv) return;
  const long long rb = t / nv;
  const long long e = (t - rb * nv) * VEC;
  const int b = static_cast<int>(rb % B), r = static_cast<int>(rb / B);
  const float* q_b = queue + static_cast<long long>(b) * Q * frame + e;
  const float* eps_rb = eps + rb * f * frame + e;
  const float* noise_r = noise + static_cast<long long>(r) * f * frame + e;
  float* out_b = out + static_cast<long long>(b) * Q * frame + e;
  float* pred_b = pred ? pred + static_cast<long long>(b) * Q * frame + e : nullptr;
  const float* mask_b = masks ? masks + b * mask_row : nullptr;
  const float* cond_b = cond ? cond + b * cond_row + e : nullptr;

  Vec<VEC> prev, mom;
#pragma unroll
  for (int i = 0; i < VEC; ++i) prev.v[i] = 0.f, mom.v[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < f; ++j) {
    const float* s = table + (r * f + j) * kCols;
    const int* sl = slots + (r * f + j) * kSlotCols;
    const int src = sl[kSrc], dst = sl[kDst];
    const Vec<VEC> x = load<VEC>(q_b + src * frame);
    const Vec<VEC> ep = load<VEC>(eps_rb + j * frame);
    const Vec<VEC> nz = load<VEC>(noise_r + j * frame);
    const float sqrt_1ma = s[kSqrtOneMinusAlpha], sqrt_a = s[kSqrtAlpha], c_dir = s[kDirCoef];
    const float sqrt_ap = s[kSqrtAlphaPrev], sigma = s[kSigma], strength = s[kStrength];
    const bool momentum = s[kMomentum] != 0.f;
    const bool inject = mask_b && s[kInject] != 0.f && gate[src];
    Vec<VEC> p, xp;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // pred_x0 = (x - sqrt(1 - a) eps) / sqrt(a); dir_xt = sqrt(1 - a_prev - sigma^2) eps
      float p0 = __fdiv_rn(__fsub_rn(x.v[i], __fmul_rn(sqrt_1ma, ep.v[i])), sqrt_a);
      const float dir = __fmul_rn(c_dir, ep.v[i]);
      if (momentum) {
        const float grad = __fadd_rn(__fsub_rn(p0, prev.v[i]), __fmul_rn(dir_weight, dir));
        mom.v[i] = __fadd_rn(__fmul_rn(beta, mom.v[i]), __fmul_rn(one_minus_beta, grad));
        p0 = __fadd_rn(p0, __fmul_rn(strength, mom.v[i]));
      }
      prev.v[i] = p0;
      p.v[i] = p0;
      const float noise_i = __fmul_rn(sigma, nz.v[i]);
      xp.v[i] = __fadd_rn(__fadd_rn(__fmul_rn(sqrt_ap, p0), dir), noise_i);
      if (inject && mask_b[src * (frame / C) + (e + i) / C] > 0.5f) {
        const float injected = __fmul_rn(cond_b ? __ldg(cond_b + i) : 0.f, s[kFactor]);
        xp.v[i] = __fadd_rn(__fadd_rn(__fmul_rn(sqrt_ap, injected), dir), noise_i);
      }
    }
    if (dst >= 0) {
      store<VEC>(out_b + dst * frame, sl[kKeep] ? x : xp);
      if (pred_b) store<VEC>(pred_b + dst * frame, p);
    }
  }
}

}  // namespace

// MoCA's window step over R windows of f frames: queue [B, Q, frame] (frame =
// h * w * C values), eps [R, B, f, frame], noise [R, f, frame], table
// [R, f, 9] and slots [R, f, 3] (ops/moca_scan.py); masks [mask_rows, Q,
// frame / C] or null (no injection), cond [cond_rows, frame] or null (zeros),
// gate: an int scratch of Q where masks are given; into out [B, Q, frame] and,
// unless null, pred [B, Q, frame]. `vec` values a thread (4 or 1), `blocks` x
// `threads` (at most 256, a multiple of 32) cover R * B * frame / vec
// threads. 0 or a CUDA error.
extern "C" int moca_scan(const void* queue, const void* eps, const void* noise,
                         const void* masks, const void* cond, const void* table,
                         const void* slots, void* gate, void* out, void* pred, int R, int B,
                         int f, int Q, long long frame, int C, int mask_rows, int cond_rows,
                         float beta, float one_minus_beta, float dir_weight, int vec,
                         int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || B <= 0 || f <= 0 || Q <= 0 || frame <= 0 || C <= 0 || frame % C ||
      blocks <= 0 || threads <= 0 || threads > kMaxThreads || threads % 32 ||
      (vec != 4 && vec != 1) || frame % vec ||
      static_cast<long long>(blocks) * threads < static_cast<long long>(R) * B * (frame / vec) ||
      (masks && (!gate || (mask_rows != 1 && mask_rows != B))) ||
      (cond && cond_rows != 1 && cond_rows != B))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* m = static_cast<const float*>(masks);
  if (m) {
    mask_gate<<<Q, kGateThreads, 0, s>>>(m, static_cast<int*>(gate), mask_rows, Q, frame / C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long mask_row = mask_rows == 1 ? 0 : static_cast<long long>(Q) * (frame / C);
  const long long cond_row = cond_rows == 1 ? 0 : frame;
  const auto* q = static_cast<const float*>(queue);
  const auto* e = static_cast<const float*>(eps);
  const auto* n = static_cast<const float*>(noise);
  const auto* c = static_cast<const float*>(cond);
  const auto* g = static_cast<const int*>(gate);
  const auto* tb = static_cast<const float*>(table);
  const auto* sl = static_cast<const int*>(slots);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<float*>(pred);
  if (vec == 4)
    moca_scan_rows<4><<<blocks, threads, 0, s>>>(q, e, n, m, c, g, tb, sl, o, p, R, B, f, Q,
                                                 frame, C, mask_row, cond_row, beta,
                                                 one_minus_beta, dir_weight);
  else
    moca_scan_rows<1><<<blocks, threads, 0, s>>>(q, e, n, m, c, g, tb, sl, o, p, R, B, f, Q,
                                                 frame, C, mask_row, cond_row, beta,
                                                 one_minus_beta, dir_weight);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
