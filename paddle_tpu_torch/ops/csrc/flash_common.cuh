// What the flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the TMA tile load into the
// layout of hopper.cuh (device), and on the host the tensor maps, encoded
// at each launch with cuTensorMapEncodeTiled reached through
// cudaGetDriverEntryPoint (no link against libcuda), the backward's
// launch-order rule and the shared-memory attribute.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_common {

constexpr int kBox = 64;          // TMA box: 64 rows x 64 columns
constexpr int kBlockRow = 128;    // bytes a row of a column block

// bytes of an R-row x kD bf16 tile: kD / 64 column blocks of R x 128 bytes
template <int kD>
constexpr int tile_bytes(int rows) {
  return rows * kD * 2;
}

// rows [row0, row0 + R) of head `bh` of a (kD, S, heads) map into the tile
// at dst (R a multiple of 64), completing on `bar`
template <int kD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int c = 0; c < kD / 64; ++c)
#pragma unroll
    for (int r = 0; r < R / kBox; ++r)
      hopper::tma_load_3d(dst + (c * R + r * kBox) * kBlockRow, map, bar,
                          c * 64, row0 + r * kBox, bh);
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (kD, rows, heads) bf16 tensor at `ptr` as a TMA map of 64 x 64 boxes,
// 128-byte swizzle, out-of-bounds rows read as zeros (a box never crosses
// into the next head)
template <int kD>
bool encode(CUtensorMap* map, const void* ptr, int rows, int heads) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(kD), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(kD) * 2,
                                 cuuint64_t(rows) * kD * 2};
  const cuuint32_t box[3] = {64, kBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch order of the backward pair. Causal tiles differ in work, so the
// blocks that see the most pairs should start first, or the last wave
// waits on them; and the blocks that read the same operands (dQ: one KV
// head's K/V; dK/dV: one group's Q/dO) should run together, so that those
// reads hit the L2. The heavy tiles of every head go first where a tail
// would idle SMs, the grid spanning at most 4 waves, or where the shared
// operands fit in the L2 whatever the order; otherwise one (batch, head)'s
// tiles stay adjacent, heavy first among them. On an H100 the first
// measured faster at S = 2048 (dQ, dK/dV) and the second at S = 16384
// (PERF.md §6). Without the causal mask every tile has the same work. The
// forward always puts heavy tiles first (flash_tiles::fwd_block): there
// adjacency measured no faster at S = 16384.
inline bool order_heavy_first(int causal, long long blocks,
                              double shared_bytes) {
  int dev = 0, sms = 0, l2 = 0;
  if (!causal || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) != cudaSuccess)
    return false;
  return blocks <= 4LL * sms || shared_bytes <= double(l2);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = e == cudaSuccess;
  return e;
}

// a kernel's launch shape into out[8]: threads a block, rows a block owns,
// rows a ring stage holds, ring stages, dynamic shared memory bytes,
// registers a thread at launch, local (spill and stack) bytes a thread, and
// the consumers' setmaxnreg count
template <typename Kernel>
int describe(Kernel kernel, int threads, int block_rows, int stage_rows,
             int stages, int smem, int consumer_regs, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  const int vals[8] = {threads, block_rows, stage_rows, stages, smem,
                       a.numRegs, int(a.localSizeBytes), consumer_regs};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace flash_common
