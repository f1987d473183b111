// Weight-only int8 matrix product for decode shapes, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/int8.py, `_w8_kernel` as launched by
// `_w8_matmul_pallas` (:80). Semantics, kept: out (M, N) = x (M, K) @ w_q
// (K, N), the int8 codes exact in the product, accumulated in fp32, times the
// per-column fp32 scale, rounded to bf16 once (`acc * s` then cast, :58).
//
// Bound: bytes. At M <= 16 every weight byte is read once and used M times:
// K*N bytes of codes against 2*M*K*N flops, under 32 flops per byte where the
// card balances at ~295 (bf16 tensor cores) and ~20 (fp32 FMA). E.g.
// gate_proj (4096 x 14336) reads 58.7 MB: 17.5 us at the H100 SXM's
// 3.35 TB/s (data sheet).
//
// Design. The TPU kernel keeps all of x (M, K) and a (K, 512) weight column
// block in VMEM and walks the columns on a sequential grid. On Hopper:
//   * a block of 4 warps owns 256 columns; each lane owns 8 consecutive
//     columns and reads them as one 8-byte load per weight row, so a warp
//     reads 256 contiguous bytes of a row. The 4 warps interleave the rows of
//     the block's K range (warp w takes rows w, w + 4, ...) in groups of 8;
//     the next group's loads are issued before the current group's
//     arithmetic (register double buffering). The warps sum their fp32
//     partials in shared memory at the end, in a fixed order.
//   * x is staged in shared memory in chunks of 512 rows of K, as fp32 and
//     transposed (k, m), so the lanes of a warp read the same k (broadcast):
//     at K = 14336 and M = 16 all of x would be 459 KB, over the 227 KB a
//     block has.
//   * the q/k/v/o projections give only 4-16 column tiles for 132 SMs, so
//     the wrapper splits K over blocks (about 4 blocks per SM); each slice
//     writes its fp32 partial sums to a workspace and a second kernel adds
//     the slices in order and applies the scale once to the full sum: the
//     result does not depend on the order blocks run in (no atomics). The
//     lm-head (501 column tiles) runs with one slice and writes directly.
//   * int8 -> fp32 is exact and costs one byte permute and one add per code
//     (the code's byte placed into the mantissa of 2^23, minus 2^23 + 128
//     after a bias flip), then M fp32 FMAs.
// Left for later: mma.sync/wgmma with M padded to 16 (at M = 16 the FMA issue
// rate, not the bytes, bounds this version), cp.async prefetching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;                    // columns per lane
constexpr int kBlockN = 32 * kCols;         // columns per block
constexpr int kChunk = 512;                 // rows of K staged at a time
constexpr int kUnroll = 8;                  // weight rows in flight per warp

// four int8 codes (one 32-bit word) to exact fp32 values
__device__ __forceinline__ void codes_to_f(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;       // code + 128, as unsigned bytes
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
           8388736.f;                       // 2^23 + 128
}

// shared bytes of one block for MT rows of x: the x chunk during the loop,
// the three other warps' partial sums at the end (the same memory)
template <int MT>
constexpr size_t smem_bytes() {
  const size_t xs = size_t(kChunk) * MT * sizeof(float);
  const size_t red = size_t(kWarps - 1) * MT * kBlockN * sizeof(float);
  return xs > red ? xs : red;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int M, int K, int N, int KS) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kBlockN + lane * kCols;
  const bool live = col0 < N;               // N % 8 == 0: all 8 or none
  const int kb = blockIdx.y * KS;
  const int ke = min(K, kb + KS);

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int kc = kb; kc < ke; kc += kChunk) {
    const int rows = min(kChunk, ke - kc);  // a multiple of 128
    __syncthreads();                        // the previous chunk is read
    for (int i = tid; i < MT * rows; i += kThreads) {
      const int m = i / rows, kl = i % rows;
      smem[kl * MT + m] =
          m < M ? __bfloat162float(x[size_t(m) * K + kc + kl]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int8_t* wp = w + size_t(kc) * N + col0;
    // rows warp, warp + 4, ... of the chunk in groups of kUnroll; rows / 4
    // is a multiple of 32. The next group's loads are issued before this
    // group's arithmetic, so they are in flight while it runs.
    uint2 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      wv[u] = *reinterpret_cast<const uint2*>(wp + size_t(warp + u * kWarps) * N);
#pragma unroll 1
    for (int r0 = warp; r0 < rows; r0 += kWarps * kUnroll) {
      const int rn = r0 + kWarps * kUnroll;
      uint2 nx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        nx[u] = make_uint2(0u, 0u);
        if (rn < rows)
          nx[u] = *reinterpret_cast<const uint2*>(
              wp + size_t(rn + u * kWarps) * N);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float wf[kCols];
        codes_to_f(wv[u].x, wf);
        codes_to_f(wv[u].y, wf + 4);
        const float* xr = smem + (r0 + u * kWarps) * MT;
        float xv[MT];
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MT; m += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(xr + m);
            xv[m] = v4.x;
            xv[m + 1] = v4.y;
            xv[m + 2] = v4.z;
            xv[m + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) xv[m] = xr[m];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[u] = nx[u];
    }
  }

  // sum the 4 warps' partials in order: warp 0 + 1 + 2 + 3
  __syncthreads();
  float* red = smem;                        // (3, MT, kBlockN)
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        red[((warp - 1) * MT + m) * kBlockN + lane * kCols + j] = acc[m][j];
  }
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    float v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float s = acc[m][j];
#pragma unroll
      for (int o = 0; o < kWarps - 1; ++o)
        s += red[(o * MT + m) * kBlockN + lane * kCols + j];
      v[j] = s;
    }
    if (part == nullptr) {
      __nv_bfloat16* op = out + size_t(m) * N + col0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        op[j] = __float2bfloat16(v[j] * scale[col0 + j]);
    } else {
      float* pp = part + (size_t(blockIdx.y) * M + m) * N + col0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) pp[j] = v[j];
    }
  }
}

// out = bf16(scale * sum of the S slices, in slice order)
__global__ void __launch_bounds__(256)
w8_combine_kernel(const float* __restrict__ part,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int S) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = static_cast<long long>(M) * N;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[k * total + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

template <int MT>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* part, int M, int K, int N, int S, int KS, cudaStream_t s) {
  constexpr size_t kSmem = smem_bytes<MT>();
  static_assert(kSmem <= 48 * 1024, "dynamic shared memory over 48 KB");
  const dim3 grid((N + kBlockN - 1) / kBlockN, S);
  w8_matmul_kernel<MT><<<grid, kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      S > 1 ? static_cast<float*>(part) : nullptr, M, K, N, KS);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long total = static_cast<long long>(M) * N;
  w8_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, w (K, N) int8, scale (N,) f32, out (M, N) bf16, all
// contiguous; x and w 16-byte aligned; 1 <= M <= 16, K and N multiples of
// 128. K splits into S slices of KS rows (KS a multiple of 128, S * KS >= K
// > (S - 1) * KS); with S > 1, part is an fp32 (S, M, N) workspace. Returns
// cudaGetLastError() after the launches.
extern "C" int pt_w8_matmul(const void* x, const void* w, const void* scale,
                            void* out, void* part, int M, int K, int N, int S,
                            int KS, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || M > 16 || K <= 0 || N <= 0 || K % 128 || N % 128 || S < 1 ||
      KS <= 0 || KS % 128 || static_cast<long long>(S) * KS < K ||
      static_cast<long long>(S - 1) * KS >= K || S > 65535 ||
      (S > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M <= 1) return launch<1>(x, w, scale, out, part, M, K, N, S, KS, s);
  if (M <= 2) return launch<2>(x, w, scale, out, part, M, K, N, S, KS, s);
  if (M <= 4) return launch<4>(x, w, scale, out, part, M, K, N, S, KS, s);
  if (M <= 8) return launch<8>(x, w, scale, out, part, M, K, N, S, KS, s);
  return launch<16>(x, w, scale, out, part, M, K, N, S, KS, s);
}
