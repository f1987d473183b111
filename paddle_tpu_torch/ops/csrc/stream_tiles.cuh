// The launch plan of the weight-streaming products (stream_gemm.cuh: the
// int8 matmul of w8_matmul.cu and the base product of fused_lora.cu) and of
// the fused LoRA kernel's first launch, x @ A. Plain C++, so that a host
// compiler can build it into a test harness (tests/test_torch_stream_gemm.
// py); under nvcc the functions are __host__ __device__.
//
// A product out (M, N) = x (M, K) @ W (K, N) (or W^T with W (N, K)) runs
// as a grid of
// (splits, column tiles, token tiles) blocks. A block owns one token tile of
// x's rows (the N of its wgmma: 8, 16, 32, 48, 64 or 128 rows), one column tile of W
// (one or two blocks of 64 columns) and one K range
// of `ks` steps of kKStep rows. The splits of one output tile are the blocks
// of one thread-block cluster: after the main loop they add their fp32
// partial sums through distributed shared memory, each block a range of
// the tile's elements (reduce_range), every element summed over the
// cluster's ranks 0, 1, ... in that order, whatever order the blocks
// finished in. So one launch is deterministic, with no atomics.
#pragma once

#if defined(__CUDACC__)
#define STREAM_TILES_FN __host__ __device__ __forceinline__
#else
#define STREAM_TILES_FN inline
#endif

namespace stream_tiles {

constexpr int kKStep = 64;       // rows of W (columns of x) a ring stage
constexpr int kColBlock = 64;    // columns of W one wgmma M covers
constexpr int kMaxCluster = 8;   // blocks of a cluster (the portable limit)
constexpr int kMaxGrid = 65535;  // the grid's y and z extents
// the fused LoRA kernel: K rows of x and A its first launch stages at a
// time, the most K slices it splits into, the largest rank
constexpr int kLoraChunk = 64;
constexpr int kMaxSlices = 32;
constexpr int kMaxRank = 64;

STREAM_TILES_FN int cdiv(int a, int b) { return (a + b - 1) / b; }

// rows of x one block covers: the smallest wgmma N of 8, 16, 32, 48 and
// 64 that holds a decode batch or a verify window; larger M runs in tiles
// of 128 rows
STREAM_TILES_FN int token_tile(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 48 ? 48
         : M <= 64 ? 64 : 128;
}

struct Plan {
  int tok;        // rows of x a block (token tile)
  int wg;         // 64-column blocks of W a block (its column tile 64 wg)
  int splits;     // K ranges of one output tile: the blocks of its cluster
  int ks;         // K steps (of kKStep rows) a split; the last may be short
  int col_tiles;  // grid y
  int tok_tiles;  // grid z
};

// The plan for x (M, K) @ W (K, N) on `sms` SMs, a pure function of its
// arguments. Column tiles of 128 where they alone give at least 3/4 of
// the SMs a block (the MLP's wide projections, the lm-head), else of 64.
// On an H100 these measured faster than 128-column tiles split over one
// block an SM (PERF.md §6, row 9).
//
// The column tile and the K split are functions of (K, N, sms) alone, at
// every M: the K split is the one a decode token tile takes (the blocks
// of one token tile about fill the SMs twice, two blocks fit an SM
// there), at most kMaxCluster, never an empty split. So an output element
// is summed over the same K ranges in the same order whatever the number
// of rows: row r of the product does not depend on M or on the other
// rows (a decode tick at 8 rows, a verify window at 40 and a batch of
// several 128-row token tiles give the same bits), given that a wgmma's
// sum over K for one element does not depend on its N. The column tile
// is fixed too because an int8 tile of 64 columns shares its stages
// between two warpgroups (stream_gemm.cuh), which changes an element's
// order of adds. The token tile (8, 16, 32, 48, 64 or 128 rows) and the
// number of token tiles still follow M.
STREAM_TILES_FN int col_wg(int N, int sms) {
  return 4 * cdiv(N, 2 * kColBlock) >= 3 * sms ? 2 : 1;
}

STREAM_TILES_FN int k_split(int K, int N, int sms) {
  const int steps = cdiv(K, kKStep);
  int s = 2 * sms / cdiv(N, col_wg(N, sms) * kColBlock);
  if (s > kMaxCluster) s = kMaxCluster;
  if (s > steps) s = steps;
  if (s < 1) s = 1;
  return s;
}

STREAM_TILES_FN Plan plan(int M, int K, int N, int sms) {
  Plan p;
  p.tok = token_tile(M);
  p.tok_tiles = cdiv(M, p.tok);
  const int steps = cdiv(K, kKStep);
  p.wg = col_wg(N, sms);
  p.col_tiles = cdiv(N, p.wg * kColBlock);
  p.ks = cdiv(steps, k_split(K, N, sms));
  p.splits = cdiv(steps, p.ks);
  return p;
}

// The first launch of the fused LoRA kernel: K slices of xa = x32 @ A at
// rank R, each slice a multiple of kLoraChunk rows: at most kMaxSlices,
// at most 512 / R (the second launch sums the slices' partials of each
// row it finishes, in slice order), no empty slice. A function of (K, R)
// alone, so that a row's xa is summed over the same slices in the same
// order whatever the number of entries and rows.
STREAM_TILES_FN int lora_slices(int K, int R) {
  const int chunks = cdiv(K, kLoraChunk);
  int s = 512 / (R < 1 ? 1 : R);
  if (s > kMaxSlices) s = kMaxSlices;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  return cdiv(chunks, cdiv(chunks, s));   // no empty slice
}

// K rows of one slice of the first launch (a multiple of kLoraChunk)
STREAM_TILES_FN int lora_slice_rows(int K, int slices) {
  return cdiv(cdiv(K, kLoraChunk), slices) * kLoraChunk;
}

// The elements [*b, *e) of `items` that rank `rank` of a cluster of C
// blocks sums over the cluster and finishes: C contiguous ranges that
// cover the items once.
STREAM_TILES_FN void reduce_range(int items, int C, int rank, int* b,
                                  int* e) {
  *b = static_cast<int>(static_cast<long long>(items) * rank / C);
  *e = static_cast<int>(static_cast<long long>(items) * (rank + 1) / C);
}

// the shapes a streaming product refuses: no rows, no K, a grid past its
// extents
STREAM_TILES_FN bool bad_plan(const Plan& p) {
  return p.col_tiles > kMaxGrid || p.tok_tiles > kMaxGrid ||
         p.splits < 1 || p.splits > kMaxCluster;
}

}  // namespace stream_tiles
