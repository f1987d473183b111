// Base projection + per-row LoRA delta (multi-tenant serving), for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/paged_attention_pallas.py, `_lora_kernel` as
// launched by `fused_lora_matmul` (:343). Semantics, kept: for every row r of
// x (rows, in) (rows = batch entries x S tokens, entry e = r / S):
//   out[r] = bf16( x[r] @ W  +  ((x32[r] @ A_e) @ B_e) * s_e )
// with the base product in bf16 x bf16 -> fp32, the delta in fp32 and the
// combine in fp32, rounded once (:312). A_e, B_e, s_e are the factors of the
// adapter page aidx[e]; page 0 is the null adapter (zero factors, s = 0), so
// a null row comes out exactly as with every s = 0.
//
// Bound: bytes, at the serving shapes. Decode (8 rows) reads every weight
// once for 16 flops per 2-byte weight; a 128-token prefill chunk does 128
// flops per weight byte, still under the card's ~295. The adapter factors
// (in + out) x R x 4 bytes per distinct page are small beside W.
//
// Design. The TPU grid is (batch,): every program re-reads all of W for its
// row, and its factors arrive as per-row copies gathered from the adapter
// pool (~84 MB a row per decode tick at Llama-3-8B, rank 8). Here:
//   * the rows of every batch entry are the M of ONE product, so each W tile
//     is read once for all rows: a block of 4 warps owns 128 columns and
//     16*MT rows (MT m16 tiles, every warp the same rows, its own 32
//     columns) and walks a K range in steps of 32 with warp-level mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate); x and W tiles are staged in
//     padded shared memory (16-byte loads, conflict-free fragment reads),
//     the next step's tiles loaded into registers while this step's
//     products run.
//   * a decode batch gives few column tiles for 132 SMs, so the wrapper
//     splits K over blocks; every block writes fp32 partial sums, and the
//     epilogue kernel adds the slices in order (deterministic, no atomics).
//   * the factors are read in place from the adapter pool's pages through
//     aidx (a page stride and a layer offset): a small kernel computes
//     xa = x32 @ A (rows x R, fp32) first, and the epilogue adds
//     (xa @ B) * s to the summed base product and rounds once.
// Left for later: cp.async/TMA pipelines deeper than one step, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 128;            // columns per block (32 per warp)
constexpr int kBK = 32;             // K step
constexpr int kSX = kBK + 8;        // padded x tile row, in bf16
constexpr int kSW = kBN + 8;        // padded W tile row, in bf16
constexpr int kMaxRank = 64;

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(const bf16* lo, const bf16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// xa[r, j] = sum_i float(x[r, i]) * A_page[i, j], in a fixed order: each
// thread sums its i's (stride kThreads), then the block adds the threads'
// sums in thread order. One block per row.
__global__ void __launch_bounds__(kThreads)
lora_xa_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
               const int* __restrict__ aidx, float* __restrict__ xa, int K,
               int R, int rows_per_entry, long long a_page_stride) {
  __shared__ float red[kThreads * 8];
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* ap = a + aidx[r / rows_per_entry] * a_page_stride;
  const bf16* xr = x + size_t(r) * K;
  for (int j0 = 0; j0 < R; j0 += 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int i = tid; i < K; i += kThreads) {
      const float xv = __bfloat162float(xr[i]);
      const float* arow = ap + size_t(i) * R + j0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j0 + j < R) acc[j] = fmaf(xv, arow[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[j * kThreads + tid] = acc[j];
    __syncthreads();
    if (tid < 8 && j0 + tid < R) {
      float s = 0.f;
      for (int t = 0; t < kThreads; ++t) s += red[tid * kThreads + t];
      xa[size_t(r) * R + j0 + tid] = s;
    }
    __syncthreads();
  }
}

// part[split, r, n] = sum over the split's K range of x[r, k] * W[k, n]
template <int MT>
__global__ void __launch_bounds__(kThreads)
lora_base_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 float* __restrict__ part, int M, int K, int N, int KS) {
  constexpr int kBM = 16 * MT;
  __shared__ __align__(16) bf16 sx[kBM * kSX];
  __shared__ __align__(16) bf16 sw[kBK * kSW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * KS, ke = min(K, kb + KS);

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // the next step's tiles are loaded into registers while this step's
  // products run: x tile kBM rows x 32 columns (4 16-byte vectors a row),
  // W tile 32 rows x 128 columns (16 vectors a row)
  constexpr int kXV = (kBM * 4 + kThreads - 1) / kThreads;
  constexpr int kWV = kBK * 16 / kThreads;
  uint4 xr[kXV], wr[kWV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXV; ++i) {
      const int v = tid + i * kThreads, r = v >> 2, c = (v & 3) * 8;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kBM * 4 && m0 + r < M)
        xr[i] = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * K + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < kWV; ++i) {
      const int v = tid + i * kThreads, r = v >> 4, c = (v & 15) * 8;
      wr[i] = *reinterpret_cast<const uint4*>(w + size_t(k0 + r) * N + n0 + c);
    }
  };
  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    __syncthreads();                  // the previous tiles are read
#pragma unroll
    for (int i = 0; i < kXV; ++i) {
      const int v = tid + i * kThreads;
      if (v < kBM * 4)
        *reinterpret_cast<uint4*>(sx + (v >> 2) * kSX + (v & 3) * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWV; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(sw + (v >> 4) * kSW + (v & 15) * 8) = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < ke) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* p = sw + (kk + 2 * t) * kSW + warp * 32 + nt * 8 + g;
        b[nt][0] = pair(p, p + kSW);
        b[nt][1] = pair(p + 8 * kSW, p + 9 * kSW);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* p = sx + (mt * 16 + g) * kSX + kk + 2 * t;
        uint32_t a[4];
        a[0] = ld32(p);
        a[1] = ld32(p + 8 * kSX);
        a[2] = ld32(p + 8);
        a[3] = ld32(p + 8 * kSX + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a, b[nt]);
      }
    }
  }

  float* pp = part + size_t(blockIdx.z) * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + mt * 16 + g + 8 * half;
      if (r >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + warp * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(pp + size_t(r) * N + c) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// out[r, n] = bf16( sum_s part[s, r, n] + (sum_j xa[r, j] * B_page[j, n]) *
// s_page ), every sum in a fixed order
__global__ void __launch_bounds__(256)
lora_epilogue_kernel(const float* __restrict__ part,
                     const float* __restrict__ xa,
                     const float* __restrict__ bpool,
                     const float* __restrict__ scale,
                     const int* __restrict__ aidx, bf16* __restrict__ out,
                     int M, int N, int R, int splits, int rows_per_entry,
                     long long b_page_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = static_cast<long long>(M) * N;
  if (i >= total) return;
  const int r = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const int page = aidx[r / rows_per_entry];
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[s * total + i];
  const float* bp = bpool + page * b_page_stride + n;
  const float* xr = xa + size_t(r) * R;
  float d = 0.f;
  for (int j = 0; j < R; ++j) d = fmaf(xr[j], bp[size_t(j) * N], d);
  out[i] = __float2bfloat16(y + d * scale[page]);
}

template <int MT>
int launch_base(const void* x, const void* w, float* part, int M, int K,
                int N, int splits, int KS, cudaStream_t s) {
  const dim3 grid(N / kBN, (M + 16 * MT - 1) / (16 * MT), splits);
  lora_base_kernel<MT><<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), part, M, K,
      N, KS);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 and w (K, N) bf16, contiguous and 16-byte aligned, K % 32
// == 0, N % 128 == 0; rows r use adapter page aidx[r / rows_per_entry];
// a: the A pool at this layer, element (page, i, j) at page * a_page_stride
// + i * R + j; b: the B pool at this layer, (page, j, n) at page *
// b_page_stride + j * N + n; scale (pages,) f32; 1 <= R <= 64. Workspaces:
// xa (M, R) f32 and part (splits, M, N) f32; K splits into `splits` ranges
// of KS rows (KS % 32 == 0). mt: m16 tiles a block covers (1, 2, 4 or 8).
// out (M, N) bf16. Returns cudaGetLastError() after the launches.
extern "C" int pt_fused_lora(const void* x, const void* w, const void* a,
                             const void* b, const void* scale,
                             const void* aidx, void* out, void* xa,
                             void* part, int M, int K, int N, int R,
                             int rows_per_entry, long long a_page_stride,
                             long long b_page_stride, int splits, int KS,
                             int mt, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK || N % kBN || R < 1 ||
      R > kMaxRank || rows_per_entry <= 0 || splits < 1 || splits > 65535 ||
      KS <= 0 || KS % kBK || static_cast<long long>(splits) * KS < K ||
      static_cast<long long>(splits - 1) * KS >= K ||
      (mt != 1 && mt != 2 && mt != 4 && mt != 8) ||
      (M + 16 * mt - 1) / (16 * mt) > 65535)
    return (int)cudaErrorInvalidValue;
  lora_xa_kernel<<<M, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const int*>(aidx), static_cast<float*>(xa), K, R,
      rows_per_entry, a_page_stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int err;
  float* pf = static_cast<float*>(part);
  if (mt == 1) err = launch_base<1>(x, w, pf, M, K, N, splits, KS, s);
  else if (mt == 2) err = launch_base<2>(x, w, pf, M, K, N, splits, KS, s);
  else if (mt == 4) err = launch_base<4>(x, w, pf, M, K, N, splits, KS, s);
  else err = launch_base<8>(x, w, pf, M, K, N, splits, KS, s);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(M) * N;
  lora_epilogue_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                         s>>>(
      pf, static_cast<const float*>(xa), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const int*>(aidx),
      static_cast<bf16*>(out), M, N, R, splits, rows_per_entry,
      b_page_stride);
  return (int)cudaGetLastError();
}
