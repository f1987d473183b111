// Paged GQA attention (decode, verify window and chunked prefill) over an fp
// or an int8 block pool, for Hopper (sm_90a), on the tensor cores through
// wgmma, fed by a TMA ring that reads the pool page by page.
//
// Replaces: paddle_tpu/ops/paged_attention_pallas.py, `_attn_kernel` as
// launched by `_paged_attention_call` (:253), for an fp pool
// (`paged_attention`) and for an int8 pool with per-(block, KV head) scales
// (`paged_attention_q`). Semantics, kept:
//   q (B, W, H, D); K/V pools (N, bs, KV, D); tables (B, M) int32 block ids;
//   pos (B,) int32 = absolute position of each row's first query token.
//   Query rows are grouped per KV head as (W, rep), rep = H / KV; row r sits
//   at position pos[b] + r / rep and sees key j (table entry j / bs, column
//   j % bs) iff j <= pos[b] + r / rep. QK in fp32, divided by sqrt(D);
//   running max, sum and accumulator in fp32; p is cast to V's dtype before
//   PV; out = acc / max(l, 1e-30) in q's dtype.
//   int8 pool: codes (exact in bf16) with scales (N, KV) f32 read through the
//   same table entry. The fp32 QK accumulator is multiplied by the block's
//   k-scale before the division by sqrt(D) (:140-143); the running sum takes
//   p before the v-scale, and the v-scale multiplies the fp32 p before its
//   cast to bf16 for PV (:154-156).
//   A masked key gets p = 0 exactly. The TPU kernel gives masked scores
//   -1e30, which yields the same result because every row sees key 0; here
//   it also keeps a row's partial sum over a context split that holds none
//   of its keys at exactly zero.
//
// Bound: bytes at decode, operations at prefill. Decode reads every visible
// K/V row once and does 4 flops per element per query row of the group
// (rep = 4 for Llama-3-8B): about 4 flops per byte (8 for the int8 pool)
// against the card's ~295. A prefill chunk (C = 128 behind 384 earlier
// tokens, 512 rows per KV head) does ~220 flops per byte of q, out and K/V:
// under the tensor-core line too, but only the tensor cores deliver it in
// time, so both products run on them.
//
// Design. The TPU walked the table on a sequential grid axis with the block
// ids as scalar prefetch; on Hopper blocks run in parallel, so:
//   * the plan (paged_tiles.cuh): a unit of work is one tile of 64 query
//     rows of one (batch row, KV head) (one wgmma M tile; a decode group
//     of 4 rows fills 4 of them: the products cost little beside the
//     bytes) and one split of the row's keys, so that each row takes as
//     many splits as its own length needs; a split's keys (at least 128,
//     from key 0) are sized from the launch's shapes, to about one wave
//     of units were half the rows as long as the table (so a row's
//     rounding never depends on the other rows of the batch, nor a
//     query's on the window's width: verify windows round as decode
//     ticks). The grid is
//     persistent, at most one wave of blocks, sized from shapes alone:
//     each block reads pos on the card and walks its units (i, i + grid,
//     ...), its ring running on from one to the next, so no host reads a
//     device tensor (the call can be captured in a CUDA graph). A tile that
//     needs one split writes its output; otherwise each split writes its
//     unnormalised (m, l, acc) and a second kernel merges exactly the
//     splits that were written (flash-decoding), launched early by
//     programmatic dependent launch.
//   * blocks of two warpgroups, two blocks on an SM: the consumers (setmaxnreg
//     208 registers a thread) and the producers (48; one warp loads, three
//     exit). The loading warp reads the block's table entries and keeps
//     a ring of 64-key stages in flight, each stage one TMA box per (page,
//     64-column half) of K and of V, the pool viewed as (D, KV, N * bs) with
//     boxes of bs keys (at most 64; bs a multiple of 8). A box that starts
//     past the tile's causal frontier is never read from the pool: the
//     producer asks for an out-of-range box, which TMA fills with zeros, and
//     the mask gives its keys p = 0. So the tail entries that point at
//     scratch block 0 are never read: whatever it holds (even +-1e9, or
//     codes with a huge scale) never reaches an output.
//   * q: the tile's rows are gathered with 16-byte loads (any rep) into the
//     128-byte swizzle of hopper.cuh; zeros past the group's rows.
//   * products: S = Q.K^T by wgmma m64n64k16 over D = 128 (both operands
//     from shared memory, K-major); the mask per row from pos, the online
//     softmax in registers in the log2 domain (exp2 on the SFU); P rounded
//     to bf16 from the accumulator into the A fragment; O += P.V by wgmma
//     m64n128k16 with A from registers and V read MN-major.
//   * int8 pools: the codes come by TMA (one 128-byte box row a key, no
//     swizzle); the consumers widen each stage to bf16 (exact) in the swizzle
//     the products read, and the producer stages each key's k- and v-scale
//     beside its codes: the k-scale multiplies the key's score, the v-scale
//     the fp32 p after the sum took it.
//   * the shared-memory attribute is set once per device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "paged_tiles.cuh"

namespace {

using namespace hopper;
namespace pt = paged_tiles;
typedef __nv_bfloat16 bf16;

constexpr int kD = 128;                  // head dim (Llama-3-8B's)
constexpr int kWg = 128;                 // the consumer warpgroup
constexpr int kThreads = 2 * kWg;        // + the producer warpgroup
constexpr int kProducerWarp = kWg / 32;  // its first warp loads; 3 idle
// registers a thread: 128 at launch (two blocks an SM), then the
// producers give theirs back and the consumers take them (setmaxnreg):
// 128 x 208 + 128 x 48 = 256 x 128
constexpr int kConsumerRegs = 208, kProducerRegs = 48;
constexpr int kRows = pt::kRows;
constexpr int kKeys = pt::kStageKeys;
constexpr int kRowBytes = 128;           // a row of a 64-column block
constexpr int kSmemPerSm = 233472;      // an SM's shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;        // running-max start, as the TPU's
static_assert(kRows == 64 && kKeys == 64, "one m64n64 product a stage");

// Shared memory of a block, every region 1024-byte aligned: the Q tile;
// for an int8 pool the bf16 tile the consumers widen a stage into; the
// ring (fp: K and V bf16 tiles; int8: K and V codes, 128 bytes a key, and
// each key's k- and v-scale); the barriers.
template <bool kQuant>
struct Smem {
  static constexpr int kQ = kRows * kD * 2;
  static constexpr int kTile = kKeys * kD * 2;          // K or V in bf16
  static constexpr int kConv = kQuant ? 2 * kTile : 0;  // widened K, V
  static constexpr int kCodes = kKeys * kD;             // K or V codes
  static constexpr int kStages = kQuant ? 3 : 2;
  static constexpr int kStage = kQuant ? 2 * kCodes : 2 * kTile;
  static constexpr int kScales = kQuant ? 2 * kKeys * 4 : 0;
  static constexpr int kRing = kQ + kConv;
  static constexpr int kScaleOff = kRing + kStages * kStage;
  static constexpr int kBars = kScaleOff + kStages * kScales;
  // barriers: full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * 2 * kStages;
  static constexpr int kAlloc = kBytes + 1024;   // room to align the base
  // two blocks an SM, each with the 1 KB the system keeps a block
  static_assert(2 * (kAlloc + 1024) <= kSmemPerSm, "two blocks an SM");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// byte offset of the 16-byte chunk `ch` (0-15) of row r of a 64-row bf16
// tile of D = 128 columns in the 128-byte swizzle (two column blocks)
__device__ __forceinline__ int swz(int r, int ch) {
  return (ch >> 3) * kRows * kRowBytes + r * kRowBytes +
         (((ch & 7) ^ (r & 7)) << 4);
}

// 16 int8 codes (one 16-byte vector) to 16 bf16 values (two 16-byte
// vectors), exactly: the code's byte goes into the mantissa of 2^23 after a
// bias flip, and 2^23 + 128 comes off
__device__ __forceinline__ void codes_to_bf16(const uint4& c, uint4* out) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
             8388736.f;
    o[2 * i] = pack_bf16(f[0], f[1]);
    o[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// A (b, tile) pair's split count and its row's keys a split
// (paged_tiles::row_split_keys); n = 0 past the launch's pairs.
struct PairSplits {
  int n, ks;
};
__device__ __forceinline__ PairSplits pair_splits(const int* __restrict__ pos,
                                                  int idx, int B, int KV,
                                                  int rep, int M, int bs,
                                                  const pt::Plan& p,
                                                  int wave) {
  PairSplits r{0, 0};
  if (idx < B * p.tiles) {
    const int b = idx / p.tiles;
    r.ks = pt::row_split_keys(pos[b], B, KV, rep, M, bs, p, wave);
    r.n = pt::tile_splits(
        pt::tile_frontier(pos[b], idx % p.tiles, p.rows, rep, M, bs), r.ks);
  }
  return r;
}

// The launch's work units (paged_tiles::launch_units), a warp summing the
// splits of 32 (b, tile) pairs at a time; every warp that calls it gets the
// same. `first`: this lane's pair of the first 32 (pair_splits of the
// lane), which each thread computes once a block.
__device__ __forceinline__ int launch_units(const int* __restrict__ pos,
                                            int B, int KV, int rep, int M,
                                            int bs, const pt::Plan& p,
                                            int wave, PairSplits first) {
  const int lane = threadIdx.x & 31;
  int items = first.n;
  for (int idx = lane + 32; idx < B * p.tiles; idx += 32)
    items += pair_splits(pos, idx, B, KV, rep, M, bs, p, wave).n;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    items += __shfl_xor_sync(0xffffffffu, items, o);
  return items * KV;
}

// Work unit L (< the launch's units): its batch row, tile and split from
// the tiles' split counts in (b, tile) order, a warp scan over 32 (b, tile)
// pairs at a time, and its KV head (paged_tiles::item_of); with its row's
// keys a split.
struct Found {
  pt::Item it;
  int ks;
};
__device__ __forceinline__ Found find_item(const int* __restrict__ pos,
                                           int L, int B, int KV, int rep,
                                           int M, int bs, const pt::Plan& p,
                                           int wave, PairSplits first) {
  const int lane = threadIdx.x & 31;
  int item = L / KV;
  const int pairs = B * p.tiles;
  for (int base = 0; base < pairs; base += 32) {
    const PairSplits ps =
        base == 0 ? first
                  : pair_splits(pos, base + lane, B, KV, rep, M, bs, p, wave);
    int c = ps.n;   // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += v;
    }
    const int total = __shfl_sync(0xffffffffu, c, 31);
    if (item < total) {
      const unsigned hit = __ballot_sync(0xffffffffu, c > item);
      const int Ln = __ffs(hit) - 1;
      const int cl = __shfl_sync(0xffffffffu, c, Ln);
      const int nl = __shfl_sync(0xffffffffu, ps.n, Ln);
      const int ks = __shfl_sync(0xffffffffu, ps.ks, Ln);
      const int pair = base + Ln;
      return Found{pt::Item{pair / p.tiles, pair % p.tiles, item - (cl - nl),
                            L % KV},
                   ks};
    }
    item -= total;
  }
  return Found{pt::Item{0, 0, 0, 0}, 0};   // not reached: L is below the units
}

// PT: the pools' element type, bf16 (fp pool) or int8_t (codes with scales)
template <typename PT>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const bf16* __restrict__ q,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int B, int W, int H,
                       int KV, int N, int bs, int M, int wave) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  using L = Smem<kQuant>;
  constexpr int kStages = L::kStages;
  const int rep = H / KV;
  const pt::Plan p = pt::plan(B, W, H, KV, bs, M);
  // the combine pass may start now: it waits for this grid's writes
  griddep_launch_dependents();
  // this lane's (b, tile) pair of the first 32, once a block
  const PairSplits first =
      pair_splits(pos, threadIdx.x & 31, B, KV, rep, M, bs, p, wave);
  const int units = launch_units(pos, B, KV, rep, M, bs, p, wave, first);
  if (static_cast<int>(blockIdx.x) >= units) return;
  // the unit's tile, split and keys
  struct Unit {
    pt::Item it;
    int pos_b, frontier, n_splits, nst;
    pt::Keys keys;
  };
  auto unit = [&](int Lu) {
    Unit u;
    const Found f = find_item(pos, Lu, B, KV, rep, M, bs, p, wave, first);
    u.it = f.it;
    u.pos_b = pos[u.it.b];
    u.frontier = pt::tile_frontier(u.pos_b, u.it.tile, p.rows, rep, M, bs);
    u.n_splits = pt::tile_splits(u.frontier, f.ks);
    u.keys = pt::split_keys(u.it.split, u.frontier, f.ks);
    u.nst = pt::split_stages(u.keys);
    return u;
  };

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto stage = [&](int j) { return L::kRing + (j % kStages) * L::kStage; };
  auto scales = [&](int j) {
    return reinterpret_cast<float*>(sbase + L::kScaleOff +
                                    (j % kStages) * L::kScales);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWg / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp >= kProducerWarp) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    // ring stage jg counts on across the block's units
    const int boxes = kKeys / p.box;
    int jg = 0;
    for (int Lu = blockIdx.x; Lu < units; Lu += gridDim.x) {
      const Unit u = unit(Lu);
      const int g = u.it.g;
      const int* trow = tables + static_cast<size_t>(u.it.b) * M;
      for (int j = 0; j < u.nst; ++j, ++jg) {
        const int s = jg % kStages;
        const int key0 = u.keys.begin + j * kKeys;
        mbar_wait(empty(s), ((jg / kStages) & 1) ^ 1);
        if constexpr (kQuant) {
          // each key's scales beside its codes (0 for a key past the
          // frontier, whose codes are zeros and whose p is 0)
          float* sc = scales(jg);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = key0 + lane + 32 * h;
            float ksv = 0.f, vsv = 0.f;
            if (k <= u.frontier) {
              const size_t e = static_cast<size_t>(trow[k / bs]) * KV + g;
              ksv = k_scales[e];
              vsv = v_scales[e];
            }
            sc[lane + 32 * h] = ksv;
            sc[kKeys + lane + 32 * h] = vsv;
          }
          __syncwarp();
        }
        if (lane == 0) mbar_arrive_expect_tx(full(s), L::kStage);
        __syncwarp();
        for (int i = lane; i < boxes; i += 32) {
          const int key = key0 + i * p.box;
          // out of range (zeros) past the frontier: that page is not read
          const int row = pt::box_loaded(key, u.frontier)
                              ? trow[key / bs] * bs + key % bs
                              : N * bs;
          const uint32_t dst = base + stage(jg) + i * p.box * kRowBytes;
          if constexpr (kQuant) {
            tma_load_3d(dst, &tk, full(s), 0, g, row);
            tma_load_3d(dst + L::kCodes, &tv, full(s), 0, g, row);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              tma_load_3d(dst + c * kKeys * kRowBytes, &tk, full(s), 64 * c,
                          g, row);
              tma_load_3d(dst + L::kTile + c * kKeys * kRowBytes, &tv,
                          full(s), 64 * c, g, row);
            }
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int grp = lane >> 2, t = lane & 3;
  const float sl2 = kLog2e / sqrtf(static_cast<float>(kD));
  int jg = 0;
  for (int Lu = blockIdx.x; Lu < units; Lu += gridDim.x) {
    const Unit u = unit(Lu);
    const int b = u.it.b, g = u.it.g;
    const int row0 = u.it.tile * kRows;
    // the unit's query rows into the swizzled Q tile (zeros past the
    // rows), once the last unit's epilogue is done with it
    bar_sync(1, kWg);
#pragma unroll
    for (int i = 0; i < kRows * 16 / kWg; ++i) {
      const int idx = i * kWg + tid, r = idx / 16, ch = idx % 16;
      const int rr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (rr < p.rows) {
        const int w = rr / rep, h = g * rep + rr % rep;
        v = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * W + w) * H + h) * kD + ch * 8);
      }
      *reinterpret_cast<uint4*>(sbase + swz(r, ch)) = v;
    }
    fence_proxy_async();
    bar_sync(1, kWg);

    // this thread's two rows: the last key each sees (-1: a row past the
    // group's, which sees none)
    int fr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = row0 + warp * 16 + grp + 8 * i;
      fr[i] = rr < p.rows ? pt::row_frontier(u.pos_b, rr, rep) : -1;
    }
    float acc[2][32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {kNegBig * kLog2e, kNegBig * kLog2e}, l[2] = {0.f, 0.f};

    for (int j = 0; j < u.nst; ++j, ++jg) {
      const int s = jg % kStages;
      const int key0 = u.keys.begin + j * kKeys;
      mbar_wait(full(s), (jg / kStages) & 1);
      uint32_t k_t, v_t;
      if constexpr (kQuant) {
        // widen the stage's codes into the bf16 tile once every warp's
        // products of the last stage are done with it
        bar_sync(1, kWg);
        const unsigned char* codes = sbase + stage(jg);
#pragma unroll 2
        for (int i = 0; i < 2 * kKeys * 8 / kWg; ++i) {
          const int idx = i * kWg + tid;
          const int kv = idx / (kKeys * 8), rem = idx % (kKeys * 8);
          const int r = rem / 8, c = rem % 8;
          const uint4 code = *reinterpret_cast<const uint4*>(
              codes + kv * L::kCodes + r * kRowBytes + c * 16);
          uint4 w[2];
          codes_to_bf16(code, w);
          unsigned char* dst = sbase + L::kQ + kv * L::kTile;
          *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) = w[0];
          *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) = w[1];
        }
        fence_proxy_async();
        bar_sync(1, kWg);
        k_t = base + L::kQ;
        v_t = base + L::kQ + L::kTile;
      } else {
        k_t = base + stage(jg);
        v_t = base + stage(jg) + L::kTile;
      }

      // S = Q.K^T over D
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        const int c = kc / 4, o = (kc % 4) * 32;
        wgmma_m64n64k16_ss(sc, smem_desc(base + c * kRows * kRowBytes + o),
                           smem_desc(k_t + c * kKeys * kRowBytes + o),
                           kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in the log2 domain: sc[4 jj + e] is row grp + 8
      // (e >> 1) of this warp's 16, key key0 + 8 jj + 2 t + (e & 1)
      const float* ksc = scales(jg);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float f[2] = {sl2, sl2};
        if constexpr (kQuant) {
          const float2 k2 =
              *reinterpret_cast<const float2*>(ksc + 8 * jj + 2 * t);
          f[0] = k2.x * sl2;   // scores * k-scale / sqrt(D), log2 units
          f[1] = k2.y * sl2;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * jj + 2 * t + (e & 1);
          float x = sc[4 * jj + e] * f[e & 1];
          if (key > fr[e >> 1]) x = -INFINITY;
          sc[4 * jj + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mi = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = exp2_ftz(m[i] - mi);
        m[i] = mi;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float vs[2] = {1.f, 1.f};
        if constexpr (kQuant) {
          const float2 v2 =
              *reinterpret_cast<const float2*>(ksc + kKeys + 8 * jj + 2 * t);
          vs[0] = v2.x;
          vs[1] = v2.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2_ftz(sc[4 * jj + e] - m[e >> 1]);  // 0: masked
          l[e >> 1] += pr;
          sc[4 * jj + e] = kQuant ? pr * vs[e & 1] : pr;   // v-scale after l
        }
      }
      if constexpr (kQuant) {
        // codes and scales read: the stage goes back to the producer
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int r = 0; r < kKeys / 16; ++r) acc_to_a(pa[r], sc, r);

      // O += P.V over the stage's keys, V read MN-major (its two column
      // blocks kKeys rows apart)
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < kKeys / 16; ++r)
        wgmma_m64n128k16_rs_tb(acc[0], acc[1], pa[r],
                               smem_desc(v_t + r * 16 * kRowBytes,
                                         kKeys * kRowBytes),
                               1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if constexpr (!kQuant) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
    }

    float lt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lt[i] = quad_sum(l[i]);
    if (pt::writes_direct(u.n_splits)) {
      // O / max(l, 1e-30) in bf16 into the Q tile (its products are
      // done), then out in 16-byte stores, a row's chunks by neighbouring
      // threads
      bar_sync(1, kWg);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.f / fmaxf(lt[i], 1e-30f);
        const int r = warp * 16 + grp + 8 * i;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e = 4 * jj + 2 * i;
            *reinterpret_cast<uint32_t*>(sbase + swz(r, 8 * c + jj) +
                                         4 * t) =
                pack_bf16(acc[c][e] * inv, acc[c][e + 1] * inv);
          }
      }
      bar_sync(1, kWg);
#pragma unroll
      for (int i = 0; i < kRows * 16 / kWg; ++i) {
        const int idx = i * kWg + tid, r = idx / 16, ch = idx % 16;
        const int rr = row0 + r;
        if (rr < p.rows) {
          const int w = rr / rep, h = g * rep + rr % rep;
          *reinterpret_cast<uint4*>(
              out + ((static_cast<size_t>(b) * W + w) * H + h) * kD +
              ch * 8) = *reinterpret_cast<const uint4*>(sbase + swz(r, ch));
        }
      }
    } else {
      // this split's unnormalised rows for the combine pass
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = row0 + warp * 16 + grp + 8 * i;
        if (rr >= p.rows) continue;
        const size_t prow =
            ((static_cast<size_t>(b) * KV + g) * p.splits + u.it.split) *
                p.rows + rr;
        float* pa_row = part_acc + prow * kD;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e = 4 * jj + 2 * i;
            *reinterpret_cast<float2*>(pa_row + 64 * c + 8 * jj + 2 * t) =
                make_float2(acc[c][e], acc[c][e + 1]);
          }
        if (t == 0)
          *reinterpret_cast<float2*>(part_ml + prow * 2) =
              make_float2(m[i], lt[i]);
      }
    }
  }
}

// Merge the splits a tile wrote: one warp per (b, KV head, row), each lane
// 4 of the D columns; a row whose tile took one split was written directly.
__global__ void __launch_bounds__(128)
paged_attention_combine(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        const int* __restrict__ pos, bf16* __restrict__ out,
                        int B, int W, int H, int KV, int bs, int M,
                        int wave) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rep = H / KV;
  const pt::Plan p = pt::plan(B, W, H, KV, bs, M);
  // B * KV * rows < 2^31 (bad_args): int indices, no 64-bit division
  const int row = static_cast<int>(blockIdx.x) * 4 + warp;
  if (row >= B * KV * p.rows) return;
  const int rr = row % p.rows, bg = row / p.rows;
  const int g = bg % KV, b = bg / KV;
  const int n =
      pt::row_tile_splits(pos[b], rr / kRows, B, KV, rep, M, bs, p, wave);
  if (pt::writes_direct(n)) return;
  griddep_wait();   // the attention grid's partials are written
  auto prow = [&](int s) {
    return (static_cast<size_t>(bg) * p.splits + s) * p.rows + rr;
  };
  float m_max = kNegBig * kLog2e;
  for (int s = 0; s < n; ++s) m_max = fmaxf(m_max, part_ml[prow(s) * 2]);
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + prow(s) * 2);
    const float wgt = exp2_ftz(ml.x - m_max);
    l += ml.y * wgt;
    const float4 a =
        *reinterpret_cast<const float4*>(part_acc + prow(s) * kD + 4 * lane);
    acc[0] += a.x * wgt;
    acc[1] += a.y * wgt;
    acc[2] += a.z * wgt;
    acc[3] += a.w * wgt;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int w = rr / rep, h = g * rep + rr % rep;
  *reinterpret_cast<uint2*>(
      out + ((static_cast<size_t>(b) * W + w) * H + h) * kD + 4 * lane) =
      make_uint2(pack_bf16(acc[0] * inv, acc[1] * inv),
                 pack_bf16(acc[2] * inv, acc[3] * inv));
}

// the (D, KV, N * bs) pool at `ptr` as a TMA map of boxes of `box` keys:
// bf16, two 64-column boxes a key in the 128-byte swizzle; int8, one
// 128-byte box a key, unswizzled. Out-of-range boxes read as zeros.
bool encode_pool(CUtensorMap* map, const void* ptr, bool codes, int KV,
                 int N, int bs, int box) {
  flash_common::EncodeTiled fn = flash_common::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t esz = codes ? 1 : 2;
  const cuuint64_t dims[3] = {cuuint64_t(kD), cuuint64_t(KV),
                              cuuint64_t(N) * bs};
  const cuuint64_t strides[2] = {kD * esz, cuuint64_t(KV) * kD * esz};
  const cuuint32_t boxd[3] = {codes ? 128u : 64u, 1u, cuuint32_t(box)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, boxd, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the pools a server reuses every pass (two a layer), kept by
// everything that shapes them: a key that matches gives the same map, so
// a pointer reused for another tensor of the same shape is safe.
struct PoolMap {
  const void* ptr;
  int codes, KV, N, bs, box;
  CUtensorMap map;
};

bool pool_map(CUtensorMap* map, const void* ptr, bool codes, int KV, int N,
              int bs, int box) {
  constexpr int kCache = 256;
  static PoolMap cache[kCache];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const PoolMap& e = cache[i];
    if (e.ptr == ptr && e.codes == int(codes) && e.KV == KV && e.N == N &&
        e.bs == bs && e.box == box) {
      *map = e.map;
      return true;
    }
  }
  if (!encode_pool(map, ptr, codes, KV, N, bs, box)) return false;
  PoolMap& e = cache[next];
  e = PoolMap{ptr, int(codes), KV, N, bs, box, *map};
  next = (next + 1) % kCache;
  if (used < kCache) ++used;
  return true;
}

// raise the kernel's shared-memory limit on the current device, once per
// device (the attribute belongs to the device's copy of the kernel)
template <typename Kernel>
cudaError_t allow_smem_here(Kernel kernel, int bytes,
                            unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (*done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done |= bit;
  return e;
}

// blocks of the kernel the current device holds at once (one wave), once
// per device
template <typename PT>
int wave(int smem) {
  static int cached[64] = {0};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, paged_attention_kernel<PT>, kThreads, smem) !=
          cudaSuccess)
    return 1;
  const int w = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) cached[dev] = w;
  return w;
}

template <typename PT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* tables, const int* pos, void* out,
           float* part_acc, float* part_ml, int B, int W, int H, int KV,
           int N, int bs, int M, cudaStream_t s) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const pt::Plan p = pt::plan(B, W, H, KV, bs, M);
  if (p.splits > 1 && (part_acc == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  if (!pool_map(&mk, kp, kQuant, KV, N, bs, p.box) ||
      !pool_map(&mv, vp, kQuant, KV, N, bs, p.box))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = Smem<kQuant>::kAlloc;
  static unsigned long long attr = 0;   // a bit per device
  cudaError_t e = allow_smem_here(paged_attention_kernel<PT>, kSmem, &attr);
  if (e != cudaSuccess) return (int)e;
  const int w = wave<PT>(kSmem);
  const int grid = pt::work_blocks(p, w);
  paged_attention_kernel<PT><<<grid, kThreads, kSmem, s>>>(
      mk, mv, static_cast<const bf16*>(q), ksc, vsc, tables, pos,
      static_cast<bf16*>(out), part_acc, part_ml, B, W, H, KV, N, bs, M, w);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  // the combine launched early (programmatic dependent launch): its
  // blocks set up while the attention grid drains, and wait for it
  const long long rows = static_cast<long long>(B) * KV * p.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((rows + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_attention_combine,
                                 static_cast<const float*>(part_acc),
                                 static_cast<const float*>(part_ml), pos,
                                 static_cast<bf16*>(out), B, W, H, KV, bs,
                                 M, w);
}

bool bad_args(int B, int W, int H, int KV, int D, int N, int bs, int M) {
  return D != kD || pt::bad_shape(B, W, H, KV, bs, M, N) || KV > 65535 ||
         static_cast<long long>(B) * KV * W * (H / KV) >= (1LL << 31);
}

}  // namespace

// bfloat16 only, D = 128 (the served model's). All tensors contiguous; q,
// pools and out 16-byte aligned; H % KV == 0; bs a multiple of 8 (the TPU
// kernel's rule); every table entry a valid block id in [0, N). With more
// than one split in the plan (pt_paged_plan), part_acc (B, KV, splits,
// W*H/KV, D) and part_ml (B, KV, splits, W*H/KV, 2) are fp32 workspaces.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue,
// launching nothing, for a shape it refuses).
extern "C" int pt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* pos, void* out, void* part_acc,
                                  void* part_ml, int B, int W, int H, int KV,
                                  int D, int N, int bs, int M, void* stream) {
  if (bad_args(B, W, H, KV, D, N, bs, M)) return (int)cudaErrorInvalidValue;
  return launch<bf16>(q, k_pool, v_pool, nullptr, nullptr,
                      static_cast<const int*>(tables),
                      static_cast<const int*>(pos), out,
                      static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), B, W, H, KV, N, bs, M,
                      reinterpret_cast<cudaStream_t>(stream));
}

// The int8 pool: k_pool/v_pool (N, bs, KV, D) int8 codes, 16-byte aligned;
// k_scales/v_scales (N, KV) f32. Otherwise as pt_paged_attention.
extern "C" int pt_paged_attention_int8(
    const void* q, const void* k_pool, const void* k_scales,
    const void* v_pool, const void* v_scales, const void* tables,
    const void* pos, void* out, void* part_acc, void* part_ml, int B, int W,
    int H, int KV, int D, int N, int bs, int M, void* stream) {
  if (bad_args(B, W, H, KV, D, N, bs, M) || k_scales == nullptr ||
      v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<int8_t>(q, k_pool, v_pool, static_cast<const float*>(k_scales),
                        static_cast<const float*>(v_scales),
                        static_cast<const int*>(tables),
                        static_cast<const int*>(pos), out,
                        static_cast<float*>(part_acc),
                        static_cast<float*>(part_ml), B, W, H, KV, N, bs, M,
                        reinterpret_cast<cudaStream_t>(stream));
}

// The launch plan from shapes alone, into out[7]: query rows a (b, KV
// head), 64-row tiles, keys a split, splits a tile at most, keys a TMA
// box, work items and units at most (the grid is at most one wave of
// them). Returns cudaErrorInvalidValue for a shape the kernel refuses.
extern "C" int pt_paged_plan(int B, int W, int H, int KV, int bs, int M,
                             int* out) {
  if (bad_args(B, W, H, KV, kD, 1, bs, M)) return (int)cudaErrorInvalidValue;
  const pt::Plan p = pt::plan(B, W, H, KV, bs, M);
  const int vals[7] = {p.rows, p.tiles, p.split_keys, p.splits, p.box,
                       static_cast<int>(p.items), static_cast<int>(p.units)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

namespace {
template <typename PT>
int config(int* out) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int kSmem = Smem<kQuant>::kAlloc;
  static unsigned long long attr = 0;
  cudaError_t e = allow_smem_here(paged_attention_kernel<PT>, kSmem, &attr);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_attention_kernel<PT>, kThreads, kSmem);
  if (e != cudaSuccess) return (int)e;
  return flash_common::describe(paged_attention_kernel<PT>, kThreads, kRows,
                                kKeys, Smem<kQuant>::kStages, kSmem, per_sm,
                                out);
}
}  // namespace

// The kernel's launch shape for a pool type (0 bf16, 1 int8), into out[8]:
// threads a block, query rows a block, keys a ring stage, ring stages,
// dynamic shared memory bytes, registers a thread, local (spill and stack)
// bytes a thread, and blocks an SM holds at once.
extern "C" int pt_paged_attention_config(int quant, int* out) {
  return quant ? config<int8_t>(out) : config<bf16>(out);
}
