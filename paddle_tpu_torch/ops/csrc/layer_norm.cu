// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused_norm.py, `_ln_kernel` (:43, launched by
// `_ln_pallas` :128): over the last dim of (rows, D), mu = mean(x),
// var = mean((x - mu)^2), y = (x - mu) * rsqrt(var + eps) * w + b, math in
// fp32, output in x's dtype; w, b (D,). The TPU kernel's refusal of a row
// count its row tile does not divide (:125-126) is a TPU tiling limit and is
// not kept: any row count runs.
//
// Bound: bytes. Each row of D elements is read once and written once, with
// w and b read once per block (L1/L2 hits after the first); ~8 flops per
// element, far below the ~295 flops per byte at which the H100's bf16 rate
// would be the limit. On the ERNIE-3.0 base finetune path the rows are
// B x S = 4096 (S = 128) or 16384 (S = 512) at D = 768, bf16.
//
// Design: one warp per row, 8 rows per 256-thread block (the default
// schedule; NormGeometry.rows sets the rows a block, each still reduced by
// one warp, so any value is bit-exact), so that a block of
// short rows still keeps all its warps busy (one block per row, as
// rms_norm.cu does, would leave 7 of 8 warps idle at D = 768). Lanes read
// the row in 16-byte vectors (8 bf16 or 4 fp32; neighbouring lanes on
// neighbouring addresses) and keep up to kCache vectors each in registers
// (D <= 2048 bf16, 1024 fp32: ERNIE's 768 fits); a longer row's remaining
// vectors are read again in each pass, from L1/L2. The mean and then the
// sum of (x - mu)^2 are reduced with warp shuffles: the two-pass variance of
// `_ln_kernel`, never E[x^2] - mu^2 (which cancels badly for rows with a
// large mean, and with ERNIE's eps of 1e-12 nothing would mask it). D must
// be a multiple of the vector (8 bf16, 4 fp32); the wrapper raises
// otherwise rather than running a scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCache = 8;  // 16-byte vectors a lane keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ float vec_sum(const uint4& u) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) s += to_f(e[j]);
  return s;
}

template <typename T>
__device__ __forceinline__ float vec_sq_dev(const uint4& u, float mu) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float d = to_f(e[j]) - mu;
    s += d * d;
  }
  return s;
}

template <typename T>
__device__ __forceinline__ uint4 vec_norm(const uint4& u, const uint4& wv,
                                          const uint4& bv, float mu,
                                          float inv) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  const T* we = reinterpret_cast<const T*>(&wv);
  const T* be = reinterpret_cast<const T*>(&bv);
  uint4 o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    oe[j] = from_f<T>((to_f(e[j]) - mu) * inv * to_f(we[j]) + to_f(be[j]));
  return o;
}

// one row, by one warp: the mean, then the sum of (x - mu)^2, then the
// output
template <typename T>
__device__ __forceinline__ void ln_row(const T* __restrict__ x,
                                       const T* __restrict__ w,
                                       const T* __restrict__ b,
                                       T* __restrict__ y, int row, int dim,
                                       float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvec = dim / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(row) * dim);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const uint4* br = reinterpret_cast<const uint4*>(b);
  uint4* yr = reinterpret_cast<uint4*>(y + size_t(row) * dim);

  uint4 cache[kCache];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const int i = lane + 32 * c;
    cache[c] = i < nvec ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
    if (i < nvec) s += vec_sum<T>(cache[c]);
  }
  for (int i = lane + 32 * kCache; i < nvec; i += 32) s += vec_sum<T>(xr[i]);
  const float mu = warp_sum(s) / static_cast<float>(dim);

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kCache; ++c)
    if (lane + 32 * c < nvec) ss += vec_sq_dev<T>(cache[c], mu);
  for (int i = lane + 32 * kCache; i < nvec; i += 32)
    ss += vec_sq_dev<T>(xr[i], mu);
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(dim) + eps);

#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const int i = lane + 32 * c;
    if (i < nvec) yr[i] = vec_norm<T>(cache[c], wr[i], br[i], mu, inv);
  }
  for (int i = lane + 32 * kCache; i < nvec; i += 32)
    yr[i] = vec_norm<T>(xr[i], wr[i], br[i], mu, inv);
}

// kWalk false (the default launch): a warp a row, kWarps rows a block.
// kWalk true (the autotuner's NormGeometry.rows): rows [blockIdx.x * rpb,
// + rpb) of the block, warp by warp (row r0 + warp, then + the block's
// warps). Each row is reduced by its warp alone either way: the same sums
// whatever rpb.
template <typename T, bool kWalk>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y, int rows,
                  int dim, float eps, int rpb) {
  if constexpr (!kWalk) {
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;  // whole warps leave together
    ln_row<T>(x, w, b, y, row, dim, eps);
  } else {
    const int r0 = blockIdx.x * rpb;
    const int r1 = r0 + rpb < rows ? r0 + rpb : rows;
    for (int row = r0 + (threadIdx.x >> 5); row < r1;
         row += blockDim.x >> 5)
      ln_row<T>(x, w, b, y, row, dim, eps);
  }
}

// rpb: rows a block; 0 keeps kWarps (a warp a row, today's launch), else
// min(rpb, kWarps) warps walk the block's rpb rows
template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int dim, float eps, int rpb, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (rows <= 0 || dim <= 0 || dim % kVec != 0 || rpb < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rpb == 0) {
    layer_norm_kernel<T, false><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                  s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), rows, dim, eps, kWarps);
    return (int)cudaGetLastError();
  }
  const int warps = rpb < kWarps ? rpb : kWarps;
  layer_norm_kernel<T, true><<<(rows + rpb - 1) / rpb, 32 * warps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), rows, dim, eps, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, dim) contiguous, 16-byte aligned; w, b: (dim,), the same
// dtype as x. dtype 0 = bfloat16 (dim % 8 == 0), 1 = float32 (dim % 4 ==
// 0); rpb: rows a block (0: today's eight). Returns cudaGetLastError()
// after launch.
extern "C" int pt_layer_norm(const void* x, const void* w, const void* b,
                             void* y, int rows, int dim, int dtype, float eps,
                             int rpb, void* stream) {
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, w, b, y, rows, dim, eps, rpb, stream);
  if (dtype == 1)
    return launch<float>(x, w, b, y, rows, dim, eps, rpb, stream);
  return (int)cudaErrorInvalidValue;
}
