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
// Design: two launches, the second allowed to start while the first runs
// (programmatic dependent launch).
//   1. xa partials: part[slice, r, :R] = x32[r, slice] @ A_e[slice, :R] in
//      fp32 FMA (the reference's arithmetic; tf32 is not), over a grid of
//      (K slices, entries, R in chunks of 8) (stream_tiles::lora_slices:
//      fixed by K and R): each entry's page of A is read once a pass. A
//      block stages 64 rows of K of its rows of x and of A at a time in
//      shared memory; each row's sum is split over up to 32 neighbouring
//      threads and added by a fixed shuffle tree: 32, for every entry of a
//      decode tick or a verify window (up to 16 rows), so a row's xa does
//      not depend on the rows beside it.
//   2. the weight-streaming main loop of stream_gemm.cuh over bf16 W (TMA
//      ring, wgmma with x's rows as the N, K splits reduced through the
//      cluster's shared memory in rank order). It streams W while launch 1
//      runs; its epilogue waits for launch 1 (griddepcontrol.wait), sums
//      each of its rows' xa over the slices in order, and adds
//      (xa @ B_page[:, cols]) * s_page to the reduced base sum in fp32
//      before the one rounding.
// The TPU grid is (batch,): every program re-reads all of W for its row;
// here each W tile is read once for all rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_gemm.cuh"
#include "stream_tiles.cuh"

namespace {

namespace sg = stream_gemm;
namespace st = stream_tiles;
typedef __nv_bfloat16 bf16;

constexpr int kXaThreads = 256;
constexpr int kChunk = st::kLoraChunk;    // K rows staged at a time
constexpr int kRowsMax = 128;             // rows of an entry staged at a time
// an entry of at most this many rows (a decode token, a verify window) is
// taken 8 rows a pass, a row by one warp (G = 32 lanes): its rows' sums
// run the same shuffle tree whatever the entry's row count; a longer one
// (a prefill chunk) up to 128 rows a pass
constexpr int kWindowRows = 16;
constexpr int kXStride = kChunk + 1;      // padded fp32 row of the x chunk

// part[slice, r, jc*8 .. jc*8 + 7] (j < R) = sum over the slice's K rows i
// of float(x[r, i]) * A_page[i, j] for the rows r of entry blockIdx.y,
// slice blockIdx.x, R chunk blockIdx.z. Thread t takes row t / G of a row
// block and every G-th i of each chunk from t % G; the G partial sums of a
// row are added by a shuffle tree of fixed shape (G = 32 for every entry
// of at most kWindowRows rows).
__global__ void __launch_bounds__(kXaThreads)
lora_xa_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
               const int* __restrict__ aidx, float* __restrict__ part, int M,
               int K, int R, int S, long long a_page_stride, int slice_rows) {
  // the second launch may start now: it waits for this one before reading
  // part
  hopper::griddep_launch_dependents();
  __shared__ float sx[kRowsMax * kXStride];
  __shared__ __align__(16) float sa[kChunk * 8];
  const int slice = blockIdx.x, e = blockIdx.y, j0 = blockIdx.z * 8;
  const int k0 = slice * slice_rows, k1 = min(K, k0 + slice_rows);
  const float* ap = a + aidx[e] * a_page_stride;
  const int tid = threadIdx.x;
  // a thread's share of one chunk's loads: x (up to 128 rows x 64 bf16 in
  // 16-byte vectors) and A (64 x 8 floats)
  constexpr int kXV = kRowsMax * (kChunk / 8) / kXaThreads;
  constexpr int kAV = kChunk * 8 / kXaThreads;
  const int pass = S <= kWindowRows ? kXaThreads / 32 : kRowsMax;
  for (int rb = 0; rb < S; rb += pass) {
    const int T = min(pass, S - rb);
    int G = 32;
    while (G > 1 && G * T > kXaThreads) G >>= 1;
    const int row = tid / G, q = tid % G;
    const bool live = row < T;
    const bf16* xr = x + size_t(e * S + rb) * K;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    // the next chunk's loads are issued before this chunk's products
    uint4 xv[kXV];
    float av[kAV];
    auto fetch = [&](int c0) {
#pragma unroll
      for (int i = 0; i < kXV; ++i) {
        const int v = tid + i * kXaThreads, r = v / (kChunk / 8);
        const int c = (v % (kChunk / 8)) * 8;
        xv[i] = make_uint4(0u, 0u, 0u, 0u);
        if (r < T && c0 + c < k1)            // K % 32 == 0: 8 or none
          xv[i] = *reinterpret_cast<const uint4*>(xr + size_t(r) * K + c0 +
                                                  c);
      }
#pragma unroll
      for (int i = 0; i < kAV; ++i) {
        const int v = tid + i * kXaThreads, ii = v / 8, j = v % 8;
        av[i] = (c0 + ii < k1 && j0 + j < R)
                    ? ap[size_t(c0 + ii) * R + j0 + j] : 0.f;
      }
    };
    fetch(k0);
    for (int c0 = k0; c0 < k1; c0 += kChunk) {
      __syncthreads();                       // the last chunk is read
#pragma unroll
      for (int i = 0; i < kXV; ++i) {
        const int v = tid + i * kXaThreads, r = v / (kChunk / 8);
        const int c = (v % (kChunk / 8)) * 8;
        const bf16* h = reinterpret_cast<const bf16*>(&xv[i]);
        if (r < T) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            sx[r * kXStride + c + u] = __bfloat162float(h[u]);
        }
      }
#pragma unroll
      for (int i = 0; i < kAV; ++i) sa[tid + i * kXaThreads] = av[i];
      __syncthreads();
      if (c0 + kChunk < k1) fetch(c0 + kChunk);
      if (live) {
        for (int i = q; i < kChunk; i += G) {
          const float xs = sx[row * kXStride + i];
          const float4 lo = *reinterpret_cast<const float4*>(sa + i * 8);
          const float4 hi = *reinterpret_cast<const float4*>(sa + i * 8 + 4);
          acc[0] = fmaf(xs, lo.x, acc[0]);
          acc[1] = fmaf(xs, lo.y, acc[1]);
          acc[2] = fmaf(xs, lo.z, acc[2]);
          acc[3] = fmaf(xs, lo.w, acc[3]);
          acc[4] = fmaf(xs, hi.x, acc[4]);
          acc[5] = fmaf(xs, hi.y, acc[5]);
          acc[6] = fmaf(xs, hi.z, acc[6]);
          acc[7] = fmaf(xs, hi.w, acc[7]);
        }
      }
    }
    // the G threads of a row are neighbouring lanes (G <= 32)
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    if (live && q == 0) {
      float* pp = part + (size_t(slice) * M + e * S + rb + row) * R + j0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j0 + j < R) pp[j] = acc[j];
    }
  }
}

// the second launch's epilogue: xa of the block's rows summed over the
// slices in order, then out = bf16(v + (xa @ B_page[:, cols]) * s_page)
struct LoraEpi {
  bf16* out;
  const float* part;    // (slices, M, R)
  const float* b;       // the B pool at this layer
  const float* scale;
  const int* aidx;
  int M, N, R, S, slices;
  long long b_page_stride;
  __device__ __forceinline__ void prepare(float* xa, int m0, int r0, int r1,
                                          int tid, int nthreads) const {
    hopper::griddep_wait();
    for (int v = tid; v < (r1 - r0) * R; v += nthreads) {
      const int row = m0 + r0 + v / R, j = v % R;
      float s = 0.f;
      for (int sl = 0; sl < slices; ++sl)
        s += part[(size_t(sl) * M + row) * R + j];
      xa[v] = s;
    }
  }
  __device__ __forceinline__ void store(int row, int col, float4 v, int r,
                                        const float* xa) const {
    const int page = aidx[row / S];
    const float* bp = b + page * b_page_stride + col;
    const float* xr = xa + r * R;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int j = 0; j < R; ++j) {
      const float xv = xr[j];
      const float4 bv = *reinterpret_cast<const float4*>(bp + size_t(j) * N);
      d0 = fmaf(xv, bv.x, d0);
      d1 = fmaf(xv, bv.y, d1);
      d2 = fmaf(xv, bv.z, d2);
      d3 = fmaf(xv, bv.w, d3);
    }
    const float sc = scale[page];
    uint2 o;
    o.x = hopper::pack_bf16(v.x + d0 * sc, v.y + d1 * sc);
    o.y = hopper::pack_bf16(v.z + d2 * sc, v.w + d3 * sc);
    *reinterpret_cast<uint2*>(out + size_t(row) * N + col) = o;
  }
};

}  // namespace

// x (M, K) bf16 and w (K, N) bf16, contiguous and 16-byte aligned, K % 32
// == 0, N % 128 == 0; rows r use adapter page aidx[r / rows_per_entry]
// (M a multiple of rows_per_entry); a: the A pool at this layer, element
// (page, i, j) at page * a_page_stride + i * R + j; b: the B pool at this
// layer, (page, j, n) at page * b_page_stride + j * N + n (16-byte
// aligned); scale (pages,) f32; 1 <= R <= 64. part: an fp32 workspace of
// stream_tiles::kMaxSlices * M * R. out (M, N) bf16. Two launches; returns
// cudaGetLastError() after them (cudaErrorInvalidValue, launching nothing,
// for a shape it refuses).
extern "C" int pt_fused_lora(const void* x, const void* w, const void* a,
                             const void* b, const void* scale,
                             const void* aidx, void* out, void* part, int M,
                             int K, int N, int R, int rows_per_entry,
                             long long a_page_stride, long long b_page_stride,
                             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % 128 || R < 1 ||
      R > st::kMaxRank || rows_per_entry <= 0 || M % rows_per_entry ||
      M / rows_per_entry > st::kMaxGrid)
    return (int)cudaErrorInvalidValue;
  const int sms = sg::sm_count();
  const int E = M / rows_per_entry;
  const int slices = st::lora_slices(K, R);
  const st::Plan p = st::plan(M, K, N, sms);
  CUtensorMap tw;
  if (st::bad_plan(p) || !sg::weight_map(&tw, w, K, N, false))
    return (int)cudaErrorInvalidValue;
  lora_xa_kernel<<<dim3(slices, E, st::cdiv(R, 8)), kXaThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const int*>(aidx), static_cast<float*>(part), M, K, R,
      rows_per_entry, a_page_stride, st::lora_slice_rows(K, slices));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const LoraEpi epi{static_cast<bf16*>(out), static_cast<const float*>(part),
                    static_cast<const float*>(b),
                    static_cast<const float*>(scale),
                    static_cast<const int*>(aidx), M, N, R, rows_per_entry,
                    slices, b_page_stride};
  e = sg::launch<false, false>(tw, x, p, M, K, N, epi, true, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The second launch's shape for token tile X (8-128) and WG 64-column
// blocks of W a block (1, 2) into out[8] (stream_gemm::describe).
extern "C" int pt_fused_lora_config(int X, int WG, int* out) {
  return sg::describe<false, LoraEpi>(X, WG, out);
}
