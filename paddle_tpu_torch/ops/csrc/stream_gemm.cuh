// The weight-streaming product out (M, N) = x (M, K) @ W (K, N) for few
// rows of x, on Hopper (sm_90a): the main loop that the int8 matmul
// (w8_matmul.cu, W int8), the fused LoRA kernel's base product
// (fused_lora.cu, W bf16) and the bf16 decode product (stream_matmul.cu,
// W (K, N) or a tied head's W (N, K)) share. Each source supplies an
// epilogue.
//
// Batch invariance: row r of out depends only on row r of x and on W. The
// K split is a function of (K, N, sms) (stream_tiles::plan), each block
// sums its K steps in order, the two warpgroups that share an int8 tile
// take even and odd stages at every token tile, and the cluster's
// partials add in rank order; a wgmma's sum for one element is taken not
// to depend on its N (chip_smoke.py phase 28 checks the bits at M = 1 to
// 128 on the card).
//
// Bound: bytes. A decode batch (M <= 16) does 2 M flops per weight it
// reads (16 per 2-byte weight at M = 8); a 128-row prefill chunk 256 per
// weight, still under the ~295 flops a byte where the card turns compute-
// bound. So the design keeps W's bytes in flight and reads each weight
// once.
//
// Design:
//   * swap-AB: the product runs as out^T = W^T . x^T, so that x's rows are
//     the wgmma's N (8, 16, 32, 48, 64 or 128: stream_tiles::token_tile,
//     so a verify window of 40 rows pads to 48, not 128) and W's
//     columns its M = 64. A decode batch of 8 rows costs no padding: m64n8
//     products, 4 accumulator registers a thread. A (64 W columns x 16 K)
//     is read MN-major from a W tile (K-major from a W^T tile), B (16 K x
//     the rows) K-major from an x tile, both 128-byte swizzled as TMA
//     writes them (hopper.cuh).
//   * blocks of one or two consumer warpgroups (64 columns of W each; an
//     int8 64-column tile takes two, which take its stages in turn) and
//     one producer warp. The producer streams K steps
//     of 64 rows through a ring of kStages stages (full/empty mbarriers):
//     per stage one TMA box of W per 64 columns (64 x 64) and one of x (64
//     columns x the token tile; rows past M read as zeros). 6 stages of up
//     to 18 KB at a decode token tile, so that two blocks fit an SM; 4 of
//     up to 32 KB at 128 rows.
//   * int8 W: the ring carries the codes (half the bytes). Each consumer
//     warpgroup converts its 64 x 64 codes to bf16 (exact: |code| <= 127
//     fits bf16's significand) into one of two swizzled tiles, fences the
//     writes to the async proxy, and runs the products on that tile while
//     it converts the next stage.
//   * K split: an output tile's K range is split over the blocks of a
//     cluster (stream_tiles::plan: up to 8, so that the blocks of a decode
//     token tile about fill the SMs twice). After the main loop each block writes its fp32 partial tile
//     to its shared memory; after a cluster barrier, block r sums its range
//     of the tile over the cluster's blocks in rank order (distributed
//     shared memory) and runs the epilogue on it: a fixed order, whatever
//     order the blocks ran in, and no workspace in device memory.
//   * the tensor map of W is encoded once per weight (pointer, shape, type)
//     and cached; x's at every launch (a new tensor each call).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "stream_tiles.cuh"

namespace stream_gemm {

using namespace hopper;
namespace st = stream_tiles;
typedef __nv_bfloat16 bf16;

constexpr int kWg = 128;                  // threads a warpgroup
constexpr int kKStep = st::kKStep;        // K rows a stage
constexpr int kRow = 128;                 // bytes a row of a swizzled block
constexpr int kTile = kKStep * kRow;      // a 64 x 64 bf16 block: 8 KB
constexpr int kBarConsumers = 3;          // named barrier of all consumers
// the epilogue's sum over a cluster's blocks loads this many addends
// before adding them, in order: the loads' latencies overlap, the order of
// the adds stays fixed
constexpr int kLoadBatch = 8;
static_assert(kKStep == 64 && st::kColBlock == 64,
              "a stage's W box is one 64 x 64 swizzle block a warpgroup, "
              "its x box one 64-column block");

template <int kX, int kWG, bool kInt8>
struct Layout {
  static constexpr int kBN = kWG * st::kColBlock;        // columns a block
  // consumer warpgroups: one a 64-column block of W, but two on the one
  // block of an int8 64-column tile, taking the stages in turn (the
  // conversion, not the bytes, limited one warpgroup at a decode token
  // tile). At every token tile, so that an element's sum over its K
  // range is added up in the same order (even stages, odd stages, then
  // the two) whatever the number of rows
  static constexpr bool kShare = kInt8 && kWG == 1;
  static constexpr int kCons = kShare ? 2 : kWG;
  static constexpr int kWBlock = kInt8 ? kKStep * 64 : kTile;
  static constexpr int kW = kWG * kWBlock;              // W of a stage
  static constexpr int kXT = kX * kRow;                 // x of a stage
  static constexpr int kStage = kW + kXT;
  // int8: two converted bf16 tiles a consumer warpgroup
  static constexpr int kConv = kInt8 ? kCons * 2 * kTile : 0;
  // ring stages: 6 at a decode token tile (two blocks fit an SM; deeper
  // rings measured slower, PERF.md, PR 10), 4 at 128 rows
  static constexpr int kStages = kX <= 16 ? 6 : 4;
  static constexpr int kRing = kStages * kStage;
  // after the main loop the ring holds the fp32 partial tile (rows padded
  // by 4 floats: the accumulator's stores hit 32 banks) and, for LoRA,
  // the block's rows of xa
  static constexpr int kPStride = kBN + 4;
  static constexpr int kPartial = kX * kPStride * 4;
  static constexpr int kXa = kInt8 ? 0 : kX * st::kMaxRank * 4;
  static constexpr int kBars = kRing + kConv;
  static constexpr int kBytes = kBars + 8 * 2 * kStages;
  static constexpr int kAlloc = kBytes + 1024;   // room to align the base
  static constexpr int kThreads = kCons * kWg + 32;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle alignment");
  static_assert(kPartial + kXa <= kRing, "the partial tile fits the ring");
  static_assert(kAlloc <= 232448, "shared memory of a block");
  static_assert(kStages >= 4 && kStages % 2 == 0,
                "a ring of at least 4 stages, an even count: a shared "
                "block's two consumers own alternate stages");
};

// 16 int8 codes (one row of a warpgroup's 64 x 64 stage, columns c0 ..
// c0 + 15) to bf16, exact: each code's byte placed in the mantissa of 2^23
// after a bias flip, 2^23 + 128 subtracted, the small integer packed to bf16
__device__ __forceinline__ uint32_t pack2(uint32_t u, int i) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i));
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (i + 1)));
  return pack_bf16(lo - 8388736.f, hi - 8388736.f);
}
__device__ __forceinline__ void codes16(const uint4 v, uint32_t (&o)[8]) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[2 * q] = pack2(w[q], 0);
    o[2 * q + 1] = pack2(w[q], 2);
  }
}

// a warpgroup's 64 x 64 codes (row-major, 64 bytes a row) into a bf16 tile
// in the 128-byte swizzle: element (k, n) at k * 128 + ((n / 8) ^ (k % 8))
// * 16 + (n % 8) * 2. Thread t converts rows t / 4 and t / 4 + 32, columns
// 16 (t % 4) .. + 15: neighbouring threads read neighbouring 16 bytes, and
// each 16-byte store wave hits every bank four times (no conflict past the
// 4 waves 512 bytes need)
__device__ __forceinline__ void convert_tile(const unsigned char* codes,
                                             unsigned char* tile, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = t / 4 + 32 * i, grp = t % 4;
    const uint4 v = *reinterpret_cast<const uint4*>(codes + k * 64 + grp * 16);
    uint32_t o[8];
    codes16(v, o);
    unsigned char* row = tile + k * kRow;
    const int j = 2 * grp;
    *reinterpret_cast<uint4*>(row + ((j ^ (k & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((j + 1) ^ (k & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// acc (64 W columns x kX rows) += A (a column block, 64 K) . B (x tile).
// A is a W (K, N) tile read MN-major (16 K rows 2048 bytes on), or with
// kKMaj a W^T tile of W (N, K) (a tied lm-head's embedding: 64 rows of 64
// K) read K-major (16 K columns 32 bytes on)
template <int kX, bool kKMaj>
__device__ __forceinline__ void stage_products(float (&acc)[kX / 2],
                                               uint32_t a, uint32_t b,
                                               bool first) {
  constexpr int kTA = kKMaj ? 0 : 1;
#pragma unroll
  for (int kk = 0; kk < kKStep / 16; ++kk) {
    const uint64_t da = smem_desc(a + kk * (kKMaj ? 32 : 2048));
    const uint64_t db = smem_desc(b + kk * 32);     // 16 K columns
    const int scale_d = (first && kk == 0) ? 0 : 1;
    if constexpr (kX == 8)
      wgmma_m64n8k16_ss_ta<kTA>(acc, da, db, scale_d);
    else if constexpr (kX == 16)
      wgmma_m64n16k16_ss_ta<kTA>(acc, da, db, scale_d);
    else if constexpr (kX == 32)
      wgmma_m64n32k16_ss_ta<kTA>(acc, da, db, scale_d);
    else if constexpr (kX == 48)
      wgmma_m64n48k16_ss_ta<kTA>(acc, da, db, scale_d);
    else if constexpr (kX == 64)
      wgmma_m64n64k16_ss_ta<kTA>(acc, da, db, scale_d);
    else
      wgmma_m64n128k16_ss_ta<kTA>(acc, da, db, scale_d);
  }
}

// The kernel. Grid (splits, column tiles, token tiles), cluster (splits, 1,
// 1): block (s, c, z) sums K steps [s ks, (s + 1) ks) of rows [z kX, z kX +
// kX) and columns [c kBN, c kBN + kBN) (Layout::kShare: two consumer
// warpgroups on one column block take its stages in turn and add their
// sums in warpgroup order). Epi supplies
//   prepare(xa, m0, r0, r1, tid, nthreads): called by the consumers before
//     the epilogue for the tile rows [r0, r1) this block finishes, with
//     kX * 64 floats of shared memory at xa;
//   store(row, col, v, r, xa): the fully reduced fp32 sums v of out[row,
//     col .. col + 3] (r: the row's index from r0).
template <int kX, int kWG, bool kInt8, bool kKMaj, class Epi>
__global__ void __launch_bounds__(Layout<kX, kWG, kInt8>::kThreads)
stream_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx, int M, int K, int N,
              int ks, Epi epi) {
  using L = Layout<kX, kWG, kInt8>;
  constexpr int S = L::kStages, kCons = L::kCons;
  constexpr int kStep = L::kShare ? 2 : 1;   // a consumer's stage stride
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto stage = [&](int j) { return (j % S) * L::kStage; };   // offset

  const int C = gridDim.x;
  const int n0 = blockIdx.y * L::kBN, m0 = blockIdx.z * kX;
  const int s0 = blockIdx.x * ks;
  const int ns = min(ks, st::cdiv(K, kKStep) - s0);   // > 0 by the plan

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), (kCons / kStep) * 4);   // its consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  const int tid = threadIdx.x % kWg;
  if (wg == kCons) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kCons * kWg) {
      prefetch_tensormap(&tw);
      prefetch_tensormap(&tx);
      for (int j = 0; j < ns; ++j) {
        const int s = j % S;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::kStage);
        const uint32_t st_ = base + stage(j);
        const int k = (s0 + j) * kKStep;
#pragma unroll
        for (int c = 0; c < kWG; ++c) {
          if constexpr (kKMaj)
            tma_load_2d(st_ + c * L::kWBlock, &tw, full(s), k, n0 + c * 64);
          else
            tma_load_2d(st_ + c * L::kWBlock, &tw, full(s), n0 + c * 64, k);
        }
        tma_load_2d(st_ + L::kW, &tx, full(s), k, m0);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int warp = tid / 32, lane = tid & 31;
    float acc[kX / 2];
#pragma unroll
    for (int i = 0; i < kX / 2; ++i) acc[i] = 0.f;
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % S));
    };
    const int cb = L::kShare ? 0 : wg;         // the column block
    const int j0 = L::kShare ? wg : 0;         // the first own stage
    for (int j = j0; j < ns; j += kStep) {
      mbar_wait(full(j % S), (j / S) & 1);
      const uint32_t st_ = base + stage(j);
      uint32_t a;
      if constexpr (kInt8) {
        // the tile converted two own stages ago has been read: the wait
        // below (one group in flight) retired its products
        const int off = L::kRing + (wg * 2 + ((j / kStep) & 1)) * kTile;
        convert_tile(sbase + stage(j) + cb * L::kWBlock, sbase + off, tid);
        fence_proxy_async();
        bar_sync(1 + wg, kWg);
        a = base + off;
      } else {
        a = st_ + cb * L::kWBlock;
      }
      wgmma_fence();
      stage_products<kX, kKMaj>(acc, a, st_ + L::kW, j == j0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (j > j0) release(j - kStep);
    }
    if (ns > j0) {
      wgmma_wait<0>();
      fence_regs(acc);
      release(j0 + (ns - 1 - j0) / kStep * kStep);
    }
    // the partial tile (kX rows x kBN columns, fp32) over the ring once
    // every consumer is done with it: thread (warp w, lane 4 g + t) holds
    // W columns 16 w + g (+ 8) and rows 8 i + 2 t (+ 1); a shared block's
    // second warpgroup adds its sums to the first's
    bar_sync(kBarConsumers, kCons * kWg);
    float* P = reinterpret_cast<float*>(sbase);
    const int g = lane >> 2, t = lane & 3;
    for (int turn = 0; turn < kStep; ++turn) {
      if (wg == turn || !L::kShare) {
#pragma unroll
        for (int i = 0; i < kX / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 8 * i + 2 * t + (e & 1);
            const int col = cb * 64 + warp * 16 + g + 8 * (e >> 1);
            float& d = P[row * L::kPStride + col];
            d = turn == 0 ? acc[4 * i + e] : d + acc[4 * i + e];
          }
      }
      if (L::kShare) bar_sync(kBarConsumers, kCons * kWg);
    }
  }

  // every block's partial tile is written
  if (C > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg < kCons) {
    const int nthreads = kCons * kWg, ct = threadIdx.x;
    constexpr int kQuads = L::kBN / 4;
    const int rows = min(kX, M - m0);
    int b, e;
    st::reduce_range(rows * kQuads, C, blockIdx.x, &b, &e);
    const int r0 = b / kQuads, r1 = e > b ? (e - 1) / kQuads + 1 : r0;
    float* xa = reinterpret_cast<float*>(sbase + L::kPartial);
    epi.prepare(xa, m0, r0, r1, ct, nthreads);
    bar_sync(kBarConsumers, nthreads);
    const uint32_t pbase = base;
    for (int it = b + ct; it < e; it += nthreads) {
      const int row = it / kQuads, q = it % kQuads;
      const uint32_t off = (row * L::kPStride + 4 * q) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (C > 1) {
        for (int c0 = 0; c0 < C; c0 += kLoadBatch) {
          float4 u[kLoadBatch];
#pragma unroll
          for (int i = 0; i < kLoadBatch; ++i)
            if (c0 + i < C)
              u[i] = ld_cluster_f4(cluster_map(pbase + off, c0 + i));
#pragma unroll
          for (int i = 0; i < kLoadBatch; ++i) {
            if (c0 + i == 0) {
              v = u[i];
            } else if (c0 + i < C) {
              v.x += u[i].x;
              v.y += u[i].y;
              v.z += u[i].z;
              v.w += u[i].w;
            }
          }
        }
      } else {
        v = *reinterpret_cast<const float4*>(sbase + off);
      }
      const int col = n0 + 4 * q;
      if (col < N) epi.store(m0 + row, col, v, row - r0, xa);
    }
  }
  // no block leaves while the cluster still reads its shared memory
  if (C > 1) cluster_sync();
}

// ------------------------------------------------------------------- host
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

// W (K, N), row-major, bf16 (128-byte swizzle) or int8 codes (no swizzle:
// the consumers read them row by row), or with kmajor a bf16 W (N, K)
// whose product is x @ W^T (boxes of 64 K x 64 rows), as a map of 64 x 64
// boxes, encoded once per (pointer, shape, type, layout) and cached;
// columns and rows past the edge read as zeros
inline bool weight_map(CUtensorMap* out, const void* w, int K, int N,
                       bool int8, bool kmajor = false) {
  struct Key {
    const void* p;
    int K, N, kind;
    bool operator==(const Key& o) const {
      return p == o.p && K == o.K && N == o.N && kind == o.kind;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^ (size_t(k.K) << 40) ^
             (size_t(k.N) << 8) ^ size_t(k.kind);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{w, K, N, (int8 ? 1 : 0) | (kmajor ? 2 : 0)};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  flash_common::EncodeTiled fn = flash_common::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(kmajor ? K : N),
                              cuuint64_t(kmajor ? N : K)};
  const cuuint64_t strides[1] = {
      cuuint64_t(kmajor ? K : N) * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {64, kKStep};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(out,
         int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         2, const_cast<void*>(w), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return true;
}

// x (M, K) bf16 as a map of boxes of 64 columns x `rows` rows (the token
// tile), 128-byte swizzle, rows past M and columns past K read as zeros
inline bool rows_map(CUtensorMap* out, const void* x, int M, int K,
                     int rows) {
  flash_common::EncodeTiled fn = flash_common::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * 2};
  const cuuint32_t box[2] = {kKStep, cuuint32_t(rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one launch of the kernel for plan p, as a cluster of p.splits blocks,
// with programmatic stream serialization when `pdl` (the kernel may start
// while the one before it runs; Epi::prepare waits for it)
template <int kX, int kWG, bool kInt8, bool kKMaj, class Epi>
cudaError_t launch_plan(const CUtensorMap& tw, const CUtensorMap& tx,
                        const st::Plan& p, int M, int K, int N,
                        const Epi& epi, bool pdl, cudaStream_t stream) {
  using L = Layout<kX, kWG, kInt8>;
  auto kernel = stream_kernel<kX, kWG, kInt8, kKMaj, Epi>;
  static bool attr = false;
  cudaError_t e = flash_common::allow_smem(kernel, L::kAlloc, &attr);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.col_tiles, p.tok_tiles);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kAlloc;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, tw, tx, M, K, N, p.ks, epi);
}

// launch the instantiation that plan p names (kKMaj: W's map is
// weight_map's kmajor layout)
template <bool kInt8, bool kKMaj, class Epi>
cudaError_t launch(const CUtensorMap& tw, const void* x, const st::Plan& p,
                   int M, int K, int N, const Epi& epi, bool pdl,
                   cudaStream_t stream) {
  CUtensorMap tx;
  if (!rows_map(&tx, x, M, K, p.tok)) return cudaErrorInvalidValue;
#define STREAM_GEMM_CASE(X, WG)                                            \
  if (p.tok == X && p.wg == WG)                                            \
    return launch_plan<X, WG, kInt8, kKMaj>(tw, tx, p, M, K, N, epi, pdl, \
                                             stream);
  STREAM_GEMM_CASE(8, 1)
  STREAM_GEMM_CASE(8, 2)
  STREAM_GEMM_CASE(16, 1)
  STREAM_GEMM_CASE(16, 2)
  STREAM_GEMM_CASE(32, 1)
  STREAM_GEMM_CASE(32, 2)
  STREAM_GEMM_CASE(48, 1)
  STREAM_GEMM_CASE(48, 2)
  STREAM_GEMM_CASE(64, 1)
  STREAM_GEMM_CASE(64, 2)
  STREAM_GEMM_CASE(128, 1)
  STREAM_GEMM_CASE(128, 2)
#undef STREAM_GEMM_CASE
  return cudaErrorInvalidValue;
}

// an instantiation's launch shape into out[8]: threads a block, rows of x
// a block (token tile), K rows a stage, ring stages, dynamic shared memory
// bytes, registers a thread, local (spill and stack) bytes a thread, and
// W columns a block
template <bool kInt8, class Epi, bool kKMaj = false>
int describe(int X, int WG, int* out) {
#define STREAM_GEMM_DESCRIBE(X_, WG_)                                      \
  if (X == X_ && WG == WG_) {                                              \
    using L = Layout<X_, WG_, kInt8>;                                      \
    return flash_common::describe(stream_kernel<X_, WG_, kInt8, kKMaj,    \
                                                Epi>,                      \
                                  L::kThreads, X_, kKStep, L::kStages,     \
                                  L::kAlloc, L::kBN, out);                 \
  }
  STREAM_GEMM_DESCRIBE(8, 1)
  STREAM_GEMM_DESCRIBE(8, 2)
  STREAM_GEMM_DESCRIBE(16, 1)
  STREAM_GEMM_DESCRIBE(16, 2)
  STREAM_GEMM_DESCRIBE(32, 1)
  STREAM_GEMM_DESCRIBE(32, 2)
  STREAM_GEMM_DESCRIBE(48, 1)
  STREAM_GEMM_DESCRIBE(48, 2)
  STREAM_GEMM_DESCRIBE(64, 1)
  STREAM_GEMM_DESCRIBE(64, 2)
  STREAM_GEMM_DESCRIBE(128, 1)
  STREAM_GEMM_DESCRIBE(128, 2)
#undef STREAM_GEMM_DESCRIBE
  return (int)cudaErrorInvalidValue;
}

}  // namespace stream_gemm
