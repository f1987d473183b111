// Batch-invariant bf16 product for the decode and verify paths, for Hopper
// (sm_90a): out (M, N) = bf16(x (M, K) @ W), W (K, N) bf16, or W^T for a
// tied lm-head's embedding W (N, K), at any M (past 128 rows in several
// token tiles).
//
// Not a port of a TPU kernel: the JAX package leaves these products to
// XLA. The port's decode ticks (M = B rows) and speculative verify windows
// (M = B (k + 1) rows) ran them on cuBLAS, which picks another kernel and
// another K split at 40 rows than at 8, so a row's logits depended on the
// rows beside it and greedy speculative output drifted from the plain
// server's. Here row r of out depends only on row r of x and on W.
//
// Bound: bytes. At decode a weight is read once for 2 M flops (16 per
// 2-byte weight at M = 8; 80 at a 40-row verify window), under the ~295
// flops a byte where the card turns compute-bound.
//
// Design: one launch of the weight-streaming main loop of stream_gemm.cuh
// with bf16 W (the fused LoRA kernel's base product, without its delta):
// swap-AB wgmma with x's rows as the N (8 to 128), W streamed once
// through a TMA ring, the K split fixed by (K, N, SM count)
// (stream_tiles::plan) and summed over the cluster in rank order; the
// epilogue rounds the fp32 sum to bf16 once. A tied head's W (N, K) is
// read through a K-major tensor map of 64 x 64 boxes and multiplied
// K-major (no transpose of the embedding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_gemm.cuh"
#include "stream_tiles.cuh"

namespace {

namespace sg = stream_gemm;
namespace st = stream_tiles;
typedef __nv_bfloat16 bf16;

// out[row, col .. col + 3] = bf16(v)
struct PlainEpi {
  bf16* out;
  int N;
  __device__ __forceinline__ void prepare(float*, int, int, int, int,
                                          int) const {}
  __device__ __forceinline__ void store(int row, int col, float4 v, int,
                                        const float*) const {
    uint2 o;
    o.x = hopper::pack_bf16(v.x, v.y);
    o.y = hopper::pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(out + size_t(row) * N + col) = o;
  }
};

}  // namespace

// x (M, K) bf16, contiguous; w bf16, contiguous: (K, N), or (N, K) when
// w_kmajor (out = x @ w^T); out (M, N) bf16; all 16-byte aligned, K and N
// multiples of 8, M >= 1. One launch. Returns its
// cudaGetLastError() (cudaErrorInvalidValue, launching nothing, for a
// shape it refuses or a tensor map that cannot be encoded).
extern "C" int pt_stream_matmul(const void* x, const void* w, void* out,
                                int M, int K, int N, int w_kmajor,
                                void* stream) {
  if (M < 1 || K <= 0 || N <= 0 || K % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  const st::Plan p = st::plan(M, K, N, sg::sm_count());
  CUtensorMap tw;
  if (st::bad_plan(p) || !sg::weight_map(&tw, w, K, N, false, w_kmajor != 0))
    return (int)cudaErrorInvalidValue;
  const PlainEpi epi{static_cast<bf16*>(out), N};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = w_kmajor
      ? sg::launch<false, true>(tw, x, p, M, K, N, epi, false, s)
      : sg::launch<false, false>(tw, x, p, M, K, N, epi, false, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel's launch shape for token tile X (8-128) and WG 64-column
// blocks of W a block (1, 2), W (K, N) (w_kmajor 0) or (N, K) (1), into
// out[8] (stream_gemm::describe).
extern "C" int pt_stream_matmul_config(int X, int WG, int w_kmajor,
                                       int* out) {
  return w_kmajor ? sg::describe<false, PlainEpi, true>(X, WG, out)
                  : sg::describe<false, PlainEpi, false>(X, WG, out);
}
