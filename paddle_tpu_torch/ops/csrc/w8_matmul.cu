// Weight-only int8 matrix product for few rows, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/int8.py, `_w8_kernel` as launched by
// `_w8_matmul_pallas` (:80). Semantics, kept: out (M, N) = x (M, K) @ w_q
// (K, N), the int8 codes exact in the product (`w_ref[...].astype(x.dtype)`,
// :54), accumulated in fp32, times the per-column fp32 scale, rounded to
// bf16 once (`acc * s` then cast, :58).
//
// Bound: bytes. At decode (M <= 16) every weight byte is read once and used
// M times: K*N bytes of codes against 2*M*K*N flops, e.g. gate_proj (4096 x
// 14336) reads 58.7 MB: 17.5 us at the H100 SXM's 3.35 TB/s (data sheet).
//
// Design: one launch of the weight-streaming main loop of stream_gemm.cuh
// with int8 W: the TMA ring carries the codes (half the bytes of bf16),
// each consumer warpgroup converts its 64 x 64 codes of a stage to bf16 in
// shared memory (exact) and runs m64nXk16 wgmma on them with x's rows as
// the N (8 to 128); the K splits of an output tile (fixed by K, N and
// the SM count: a row's sum does not depend on M) reduce through the
// cluster's shared memory in rank order, and the epilogue applies the scale
// once to the fully reduced fp32 sum (the TPU kernel's `acc * s`) and
// rounds to bf16. The TPU kernel's grid walks (K, 512) column blocks of W in
// order on one core; here the plan (stream_tiles.cuh) spreads column tiles
// and K splits over the SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_gemm.cuh"
#include "stream_tiles.cuh"

namespace {

namespace sg = stream_gemm;
namespace st = stream_tiles;
typedef __nv_bfloat16 bf16;

// out[row, col .. col + 3] = bf16(v * scale[col .. col + 3])
struct W8Epi {
  bf16* out;
  const float* scale;
  int N;
  __device__ __forceinline__ void prepare(float*, int, int, int, int,
                                          int) const {}
  __device__ __forceinline__ void store(int row, int col, float4 v, int,
                                        const float*) const {
    const float4 s = *reinterpret_cast<const float4*>(scale + col);
    uint2 o;
    o.x = hopper::pack_bf16(v.x * s.x, v.y * s.y);
    o.y = hopper::pack_bf16(v.z * s.z, v.w * s.w);
    *reinterpret_cast<uint2*>(out + size_t(row) * N + col) = o;
  }
};

}  // namespace

// x (M, K) bf16, w (K, N) int8, scale (N,) f32, out (M, N) bf16, all
// contiguous and 16-byte aligned; K and N multiples of 128. One launch.
// Returns its cudaGetLastError() (cudaErrorInvalidValue, launching nothing,
// for a shape it refuses or a tensor map the driver refuses).
extern "C" int pt_w8_matmul(const void* x, const void* w, const void* scale,
                            void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K <= 0 || N <= 0 || K % 128 || N % 128)
    return (int)cudaErrorInvalidValue;
  const st::Plan p = st::plan(M, K, N, sg::sm_count());
  CUtensorMap tw;
  if (st::bad_plan(p) || !sg::weight_map(&tw, w, K, N, true))
    return (int)cudaErrorInvalidValue;
  const W8Epi epi{static_cast<bf16*>(out), static_cast<const float*>(scale),
                  N};
  cudaError_t e = sg::launch<true, false>(tw, x, p, M, K, N, epi, false,
                                   reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel's launch shape for token tile X (8-128) and WG 64-column
// blocks of W a block (1, 2) into out[8] (stream_gemm::describe).
extern "C" int pt_w8_matmul_config(int X, int WG, int* out) {
  return sg::describe<true, W8Epi>(X, WG, out);
}

// The plan of an (M, K) @ (K, N) streaming product on this device into
// out[6]: token tile, 64-column blocks of W a block, splits, K steps a
// split, column tiles, token tiles.
extern "C" int pt_stream_plan(int M, int K, int N, int* out) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const st::Plan p = st::plan(M, K, N, sg::sm_count());
  const int v[6] = {p.tok, p.wg, p.splits, p.ks, p.col_tiles, p.tok_tiles};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
