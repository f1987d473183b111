// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused_norm.py, `_rms_kernel` (launched by
// `_rms_pallas`): y = x * rsqrt(mean(x^2) + eps) * w over the last dim, math
// in fp32, output in x's dtype.
//
// Bound: bytes. Per row of D elements it reads x and w once and writes y
// once and does ~4 flops per element, far below the ~295 flops per byte at
// which the H100's bf16 rate would be the limit. On the serving path the
// rows are the decode batch (8) or a prefill chunk (128) at D = 4096.
//
// Design: one thread block per row; 16-byte vector loads (8 bf16 per load,
// neighbouring threads on neighbouring addresses); the sum of
// squares is reduced with warp shuffles, then across the block's warps
// through shared memory; a second pass re-reads the row (an L1/L2 hit) and
// writes the scaled output. At decode's 8 rows the launch covers only 8 of
// the 132 SMs: the kernel is then latency-bound, and fusing the norm into
// the neighbouring matmul is the remedy, for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int dim, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = dim / kVec;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * dim);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + row * dim);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 u = xr[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_f(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float warp_sum[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sum[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float inv = rsqrtf(total / static_cast<float>(dim) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 u = xr[i];
    uint4 wv = wr[i];
    uint4 o;
    const T* e = reinterpret_cast<const T*>(&u);
    const T* we = reinterpret_cast<const T*>(&wv);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) oe[j] = from_f<T>(to_f(e[j]) * inv * to_f(we[j]));
    yr[i] = o;
  }
}

}  // namespace

// bfloat16 only (the served model's type; others are instantiated when a
// slice needs them). x, y: (rows, dim) contiguous, 16-byte aligned; w:
// (dim,); dim % 8 == 0. Returns cudaGetLastError() after launch.
extern "C" int pt_rms_norm(const void* x, const void* w, void* y, int rows,
                           int dim, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || dim <= 0 || dim % 8 != 0) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), dim, eps);
  return (int)cudaGetLastError();
}
