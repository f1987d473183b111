// Flash attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, on the tensor cores through wgmma, fed by a TMA ring.
//
// Replaces: paddle_tpu/ops/flash_attention.py
//   _bwd_dq_kernel_loop   launched by _flash_bwd_bhsd_loop    (:628)
//   _bwd_dkv_kernel_loop  launched by _flash_bwd_bhsd_loop    (:646)
//   _bwd_dq_kernel        launched by _flash_bwd_bhsd_stream  (:352)
//   _bwd_dkv_kernel       launched by _flash_bwd_bhsd_stream  (:376)
// The TPU splits loop and stream forms because its loop kernels hold all of
// K/V in VMEM; these kernels stream tiles at any length, so the loop rows
// (3, 4) and the stream rows (5, 6) launch the same two entry points, and
// the Python wrappers count them apart.
//
// Function (as the plain version flash_attention._flash_bwd_plain): bf16
// q, dO (B, H, Sq, D) and k, v (B, Hkv, Sk, D), D = 64 or 128; fp32 LSE and
// delta = rowsum(dO * O) (B, H, Sq). Query head h reads KV head
// h / (H / Hkv). Causal masks align bottom-right (row i sees key j iff
// j <= i + Sk - Sq); a row that sees no key gets zero gradients.
// P = exp(s * scale - LSE), rounded to bf16 before dV = P^T.dO;
// dS = P * (dP - delta), rounded to bf16 before dQ = scale * dS.K and
// dK = scale * dS^T.Q. dK and dV are summed over the GQA group in fp32
// inside the kernel and rounded once. Deterministic: every sum is taken in
// a fixed order, with no atomics (dQ and dK/dV are two kernels, 7 products
// where a fused backward with fp32 atomics on dQ does 5).
//
// Bound: operations. dQ does 3 products of 2 * D flops per visible (row,
// key) pair and head, dK/dV 4; at B = 2, H = 32, S = 2048, D = 128 causal
// that is 0.104 and 0.139 ms at the H100 SXM's 989 TFLOP/s bf16 (data
// sheet, 700 W), against 0.03 ms for their bytes at 3.35 TB/s.
//
// Design (FlashAttention-3's backward, without its dQ atomics):
//   * blocks of three warpgroups: warpgroups 0 and 1 consume (64 rows of
//     the block's tile each, setmaxnreg 232 registers a thread), warpgroup
//     2 produces (setmaxnreg 40; one warp issues the TMA loads, the other
//     three exit). 2 x 128 x 232 + 128 x 40 = 64,512 registers, the 168 a
//     thread of a 384-thread block that __launch_bounds__(384, 1) allows.
//   * dK/dV: one block per (128-key tile, KV head, batch). K and V arrive
//     once by TMA; a ring of stages holds (Q, dO, LSE, delta) of a
//     64-row query tile, for each query head of the GQA group and each
//     query tile from the causal lower bound on. A stage: S^T = K.Q^T and
//     dP^T = V.dO^T (wgmma, both operands from shared memory), P^T and dS^T
//     in registers, dV += P^T.dO and dK += dS^T.Q (wgmma, A from registers:
//     the accumulator layout is the next A fragment; B = dO or Q read
//     MN-major, the transpose bf16 allows). The stage is released through
//     its mbarrier; dK and dV are scaled and written once.
//   * dQ: one block per (128-row query tile, head, batch). Q and dO arrive
//     once; a ring of 64-key K/V tiles follows, up to the block's causal
//     frontier. S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K with K
//     read MN-major. LSE and delta of a thread's two rows live in
//     registers.
//   * the mask runs only on tiles that the causal diagonal or a ragged edge
//     crosses (a compile-time branch); scale * log2(e) is folded into one
//     FMA before exp2f.
//   * launch order (order_heavy_first, flash_common.cuh): the heavy causal
//     tiles (dQ's last query tiles, dK/dV's first key tiles) of every head
//     first where
//     a tail would idle SMs or the shared operands fit the L2; otherwise one
//     (batch, head)'s tiles adjacent, heavy first among them, so that
//     blocks sharing K/V (dQ) or the group's Q/dO (dK/dV) read them from
//     the 50 MB L2.
//   * TMA: 3-D tensor maps (D, S, B * heads) with 64 x 64 boxes and the
//     128-byte swizzle the wgmma descriptors read (hopper.cuh); a ragged
//     tile zero-fills at its own head's end. The maps are encoded at each
//     launch with cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no link against libcuda), and passed as
//     __grid_constant__ kernel parameters.
// The tile schedule (first and last tiles, which need the mask) is
// flash_tiles.cuh, which the CPU tests build with a host compiler; the
// tile loads, tensor maps and launch rule are flash_common.cuh, shared
// with the forward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace flash_common;
using namespace hopper;
namespace ft = flash_tiles;
typedef __nv_bfloat16 bf16;

constexpr int kWg = 128;                 // threads a warpgroup
constexpr int kThreads = 3 * kWg;        // 2 consumer warpgroups + producer
constexpr int kProducerWarp = 2 * kWg / 32;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kConsumerWarps = 2 * kWg / 32;
constexpr int kStages = 3;               // ring depth (2-4 measured alike)
constexpr int kSmemMax = 232448;         // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ dK/dV
template <int kD>
struct DkvSmem {
  static constexpr int kKV = tile_bytes<kD>(ft::kDkvKeys);   // K or V
  static constexpr int kQ = tile_bytes<kD>(ft::kDkvRows);    // Q or dO
  // a stage: Q, dO, then LSE * log2(e) and delta of its 64 rows (fp32)
  static constexpr int kStage = 2 * kQ + 1024;
  static constexpr int kK = 0, kV = kKV, kRing = 2 * kKV;
  static constexpr int kBars = kRing + kStages * kStage;
  // barriers: K/V, full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;   // room to align the base
  static_assert(2 * ft::kDkvRows * 4 <= 1024, "LSE and delta of a stage");
  static_assert(kAlloc <= kSmemMax, "shared memory of a block");
};

template <int kD, bool kMask>
__device__ __forceinline__ void dkv_stage(float (&dka)[kD / 64][32],
                                          float (&dva)[kD / 64][32],
                                          uint32_t k_a, uint32_t v_a,
                                          uint32_t st, const float* rows,
                                          int key, int col, int Sq, int Sk,
                                          int causal, float sl2) {
  using L = DkvSmem<kD>;
  float s[32], dp[32];
  // S^T (64 keys x 64 rows) = K.Q^T and dP^T = V.dO^T, reduced over D
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc / 4, o = (kc % 4) * 32;
    wgmma_m64n64k16_ss(
        s, smem_desc(k_a + c * ft::kDkvKeys * kBlockRow + o),
        smem_desc(st + c * ft::kDkvRows * kBlockRow + o), kc > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc / 4, o = (kc % 4) * 32;
    wgmma_m64n64k16_ss(
        dp, smem_desc(v_a + c * ft::kDkvKeys * kBlockRow + o),
        smem_desc(st + L::kQ + c * ft::kDkvRows * kBlockRow + o), kc > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);
  // s[4 j + e]: key `key + 8 (e >> 1)`, tile row 8 j + 2 t + (e & 1),
  // query row `col + 8 j + (e & 1)` (col = q0 + 2 t)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tr = 8 * j + (e & 1);   // plus 2 t, folded into `rows`
      float p = exp2f(fmaf(s[4 * j + e], sl2, -rows[tr]));
      if (kMask) {
        const int kr = key + 8 * (e >> 1), qr = col + 8 * j + (e & 1);
        if (!(qr < Sq && kr < Sk && (!causal || kr <= qr + (Sk - Sq))))
          p = 0.f;
      }
      s[4 * j + e] = p;
    }
  }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = s[4 * j + e] *
                      (dp[4 * j + e] - rows[ft::kDkvRows + 8 * j + (e & 1)]);
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc_to_a(pa[r], s, r);
    acc_to_a(da[r], dp, r);
  }
  // dV += P^T.dO and dK += dS^T.Q, reduced over the 64 query rows; dO and Q
  // are read MN-major, one 64-column block of D at a time. (Issuing dV
  // before forming dS^T measured slower: it needs 240 registers a consumer
  // thread, or spills at 232.)
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
      wgmma_m64n64k16_rs_tb(
          dva[c], pa[r],
          smem_desc(st + L::kQ + c * ft::kDkvRows * kBlockRow + r * 2048),
          1);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
      wgmma_m64n64k16_rs_tb(
          dka[c], da[r],
          smem_desc(st + c * ft::kDkvRows * kBlockRow + r * 2048), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
    fence_regs(dka[c]);
    fence_regs(dva[c]);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale, int heavy_first) {
  using L = DkvSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBars;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };

  // launch order (launch_bwd_dkv): the first key tiles are the heavy
  // ones; with heavy_first they lead in blockIdx.z across every head, else
  // one (batch, KV head)'s tiles are adjacent in blockIdx.x
  const int k0 = (heavy_first ? blockIdx.z : blockIdx.x) * ft::kDkvKeys;
  const int hk = heavy_first ? blockIdx.x : blockIdx.y;
  const int b = heavy_first ? blockIdx.y : blockIdx.z, rep = H / Hkv;
  const int nq = ft::cdiv(Sq, ft::kDkvRows);
  const int first = ft::dkv_first_qtile(k0, ft::kDkvRows, Sq, Sk, causal);
  const int per_head = nq > first ? nq - first : 0;
  const int total = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);                 // the producer warp's lanes
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kProducerWarp) {
      const int lane = threadIdx.x & 31;
      if (total > 0 && lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
        load_tile<kD, ft::kDkvKeys>(base + L::kK, &tk, bar_kv, k0,
                                    b * Hkv + hk);
        load_tile<kD, ft::kDkvKeys>(base + L::kV, &tv, bar_kv, k0,
                                    b * Hkv + hk);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int r = it / per_head;
        const int q0 = (first + it - r * per_head) * ft::kDkvRows;
        const int bh = b * H + hk * rep + r;
        float* rows = reinterpret_cast<float*>(sbase + L::kRing +
                                               s * L::kStage + 2 * L::kQ);
        for (int i = lane; i < ft::kDkvRows; i += 32) {
          const bool in = q0 + i < Sq;
          const size_t at = size_t(bh) * Sq + q0 + i;
          rows[i] = in ? lse[at] * kLog2e : 0.f;
          rows[ft::kDkvRows + i] = in ? delta[at] : 0.f;
        }
        if (lane == 0) {
          const uint32_t st = base + L::kRing + s * L::kStage;
          mbar_arrive_expect_tx(full(s), 2 * L::kQ);
          load_tile<kD, ft::kDkvRows>(st, &tq, full(s), q0, bh);
          load_tile<kD, ft::kDkvRows>(st + L::kQ, &tdo, full(s), q0, bh);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int tw = threadIdx.x % kWg, warp = tw / 32, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + wg * ft::kWgRows;     // the warpgroup's first key
    const float sl2 = scale * kLog2e;
    float dka[kD / 64][32], dva[kD / 64][32];
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
    const uint32_t k_a = base + L::kK + wg * ft::kWgRows * kBlockRow;
    const uint32_t v_a = base + L::kV + wg * ft::kWgRows * kBlockRow;
    if (total > 0) mbar_wait(bar_kv, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % kStages;
      const int r = it / per_head;
      const int q0 = (first + it - r * per_head) * ft::kDkvRows;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = base + L::kRing + s * L::kStage;
      // this thread's query columns are 8 j + 2 t + {0, 1}: offset the
      // stage's LSE / delta rows by 2 t
      const float* rows = reinterpret_cast<const float*>(
                              sbase + L::kRing + s * L::kStage + 2 * L::kQ) +
                          2 * t;
      const int key = kw0 + warp * 16 + g, col = q0 + 2 * t;
      if (ft::tile_needs_mask(q0, ft::kDkvRows, kw0, ft::kWgRows, Sq, Sk,
                              causal))
        dkv_stage<kD, true>(dka, dva, k_a, v_a, st, rows, key, col, Sq, Sk,
                            causal, sl2);
      else
        dkv_stage<kD, false>(dka, dva, k_a, v_a, st, rows, key, col, Sq, Sk,
                             causal, sl2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    // dK = scale * sum dS^T.Q and dV, rounded once
    const size_t bhk = size_t(b) * Hkv + hk;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = kw0 + warp * 16 + g + 8 * half;
      if (kr >= Sk) continue;
      bf16* krow = dk + (bhk * Sk + kr) * kD;
      bf16* vrow = dv + (bhk * Sk + kr) * kD;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * c + 8 * j + 2 * t, i = 4 * j + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(krow + d) =
              __floats2bfloat162_rn(dka[c][i] * scale, dka[c][i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + d) =
              __floats2bfloat162_rn(dva[c][i], dva[c][i + 1]);
        }
    }
  }
}

// --------------------------------------------------------------------- dQ
template <int kD>
struct DqSmem {
  static constexpr int kQ = tile_bytes<kD>(ft::kDqRows);     // Q or dO
  static constexpr int kKV = tile_bytes<kD>(ft::kDqKeys);    // K or V
  static constexpr int kStage = 2 * kKV;                      // K, V
  static constexpr int kQo = 0, kDo = kQ, kRing = 2 * kQ;
  static constexpr int kBars = kRing + kStages * kStage;
  // barriers: Q/dO, full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= kSmemMax, "shared memory of a block");
};

template <int kD, bool kMask>
__device__ __forceinline__ void dq_stage(float (&dqa)[kD / 64][32],
                                         uint32_t q_a, uint32_t do_a,
                                         uint32_t st, const float (&lse2)[2],
                                         const float (&dl)[2], int row,
                                         int key, int Sq, int Sk, int causal,
                                         float sl2) {
  using L = DqSmem<kD>;
  constexpr int kN = ft::kDqKeys;   // the stage's keys
  static_assert(kN == 64, "the S and dP products are m64n64");
  float s[kN / 2], dp[kN / 2];
  // S (64 rows x kN keys) = Q.K^T and dP = dO.V^T, reduced over D
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc / 4, o = (kc % 4) * 32;
    wgmma_m64n64k16_ss(s, smem_desc(q_a + c * ft::kDqRows * kBlockRow + o),
                       smem_desc(st + c * kN * kBlockRow + o), kc > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc / 4, o = (kc % 4) * 32;
    wgmma_m64n64k16_ss(dp,
                       smem_desc(do_a + c * ft::kDqRows * kBlockRow + o),
                       smem_desc(st + L::kKV + c * kN * kBlockRow + o),
                       kc > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);
  // s[4 j + e]: row `row + 8 (e >> 1)`, key `key + 8 j + (e & 1)`
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(s[4 * j + e], sl2, -lse2[e >> 1]));
      if (kMask) {
        const int qr = row + 8 * (e >> 1), kr = key + 8 * j + (e & 1);
        if (!(qr < Sq && kr < Sk && (!causal || kr <= qr + (Sk - Sq))))
          p = 0.f;
      }
      s[4 * j + e] = p;
    }
  }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
  uint32_t da[kN / 16][4];
#pragma unroll
  for (int r = 0; r < kN / 16; ++r) acc_to_a(da[r], dp, r);
  // dQ += dS.K, reduced over the stage's keys; K read MN-major
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < kN / 16; ++r)
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
      wgmma_m64n64k16_rs_tb(dqa[c], da[r],
                            smem_desc(st + c * kN * kBlockRow + r * 2048),
                            1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) fence_regs(dqa[c]);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Hkv, int Sq, int Sk, int causal, float scale,
                    int heavy_first) {
  using L = DqSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_qo = base + L::kBars;
  auto full = [&](int s) { return bar_qo + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_qo + 8 * (1 + kStages + s); };

  // launch order (launch_bwd_dq): the last query tiles see the most keys
  // and launch first, across every head in blockIdx.z with heavy_first,
  // else within one (batch, head) in blockIdx.x
  const int tiles = heavy_first ? gridDim.z : gridDim.x;
  const int q0 =
      (tiles - 1 - (heavy_first ? blockIdx.z : blockIdx.x)) * ft::kDqRows;
  const int h = heavy_first ? blockIdx.x : blockIdx.y;
  const int b = heavy_first ? blockIdx.y : blockIdx.z, hk = h / (H / Hkv);
  const int bh = b * H + h, bhk = b * Hkv + hk;
  const int nk = ft::dq_key_tiles(q0, ft::kDqRows, ft::kDqKeys, Sq, Sk,
                                  causal);

  if (threadIdx.x == 0) {
    mbar_init(bar_qo, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kProducerWarp * 32 && nk > 0) {
      mbar_arrive_expect_tx(bar_qo, 2 * L::kQ);
      load_tile<kD, ft::kDqRows>(base + L::kQo, &tq, bar_qo, q0, bh);
      load_tile<kD, ft::kDqRows>(base + L::kDo, &tdo, bar_qo, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        const uint32_t st = base + L::kRing + s * L::kStage;
        mbar_arrive_expect_tx(full(s), 2 * L::kKV);
        load_tile<kD, ft::kDqKeys>(st, &tk, full(s), j * ft::kDqKeys, bhk);
        load_tile<kD, ft::kDqKeys>(st + L::kKV, &tv, full(s),
                                   j * ft::kDqKeys, bhk);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int tw = threadIdx.x % kWg, warp = tw / 32, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + wg * ft::kWgRows;     // the warpgroup's first row
    const int row = qw0 + warp * 16 + g;       // and rows row, row + 8
    const float sl2 = scale * kLog2e;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = row + 8 * i < Sq;
      const size_t at = size_t(bh) * Sq + row + 8 * i;
      lse2[i] = in ? lse[at] * kLog2e : 0.f;
      dl[i] = in ? delta[at] : 0.f;
    }
    float dqa[kD / 64][32];
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;
    const uint32_t q_a = base + L::kQo + wg * ft::kWgRows * kBlockRow;
    const uint32_t do_a = base + L::kDo + wg * ft::kWgRows * kBlockRow;
    if (nk > 0) mbar_wait(bar_qo, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % kStages;
      const int k0 = j * ft::kDqKeys;
      mbar_wait(full(s), (j / kStages) & 1);
      const uint32_t st = base + L::kRing + s * L::kStage;
      if (ft::tile_needs_mask(qw0, ft::kWgRows, k0, ft::kDqKeys, Sq, Sk,
                              causal))
        dq_stage<kD, true>(dqa, q_a, do_a, st, lse2, dl, row, k0 + 2 * t, Sq,
                           Sk, causal, sl2);
      else
        dq_stage<kD, false>(dqa, q_a, do_a, st, lse2, dl, row, k0 + 2 * t,
                            Sq, Sk, causal, sl2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qr = row + 8 * half;
      if (qr >= Sq) continue;
      bf16* drow = dq + (size_t(bh) * Sq + qr) * kD;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * c + 8 * j + 2 * t, i = 4 * j + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(drow + d) =
              __floats2bfloat162_rn(dqa[c][i] * scale, dqa[c][i + 1] * scale);
        }
    }
  }
}

// ------------------------------------------------------------------- host
template <int kD>
bool encode_all(CUtensorMap (&m)[4], const void* q, const void* k,
                const void* v, const void* dout, int B, int H, int Hkv, int Sq,
                int Sk) {
  return encode<kD>(&m[0], q, Sq, B * H) && encode<kD>(&m[1], k, Sk, B * Hkv) &&
         encode<kD>(&m[2], v, Sk, B * Hkv) &&
         encode<kD>(&m[3], dout, Sq, B * H);
}

template <int kD>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int H, int Hkv, int Sq, int Sk, int causal,
                  float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_all<kD>(m, q, k, v, dout, B, H, Hkv, Sq, Sk))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = DqSmem<kD>::kAlloc;
  static bool attr = false;   // one per head dim
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<kD>, kSmem, &attr);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ft::cdiv(Sq, ft::kDqRows);
  // blocks share one KV head's K and V
  const bool heavy = order_heavy_first(causal, (long long)tiles * H * B,
                                       4.0 * B * Hkv * double(Sk) * kD);
  const dim3 grid = heavy ? dim3(H, B, tiles) : dim3(tiles, H, B);
  flash_bwd_dq_kernel<kD><<<grid, kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hkv, Sq,
      Sk, causal, scale, heavy);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_all<kD>(m, q, k, v, dout, B, H, Hkv, Sq, Sk))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = DkvSmem<kD>::kAlloc;
  static bool attr = false;   // one per head dim
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<kD>, kSmem, &attr);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ft::cdiv(Sk, ft::kDkvKeys);
  // blocks share one GQA group's Q and dO
  const bool heavy = order_heavy_first(causal, (long long)tiles * Hkv * B,
                                       4.0 * B * H * double(Sq) * kD);
  const dim3 grid = heavy ? dim3(Hkv, B, tiles) : dim3(tiles, Hkv, B);
  flash_bwd_dkv_kernel<kD><<<grid, kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, Sq, Sk, causal, scale, heavy);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 only, head dim D = 64 or 128. q, dO: (B, H, Sq, D); k, v, dK,
// dV: (B, Hkv, Sk, D); lse, delta: fp32 (B, H, Sq); all contiguous and
// 16-byte aligned. Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue, launching nothing, for another D, a bad shape or
// a tensor map that cuTensorMapEncodeTiled refuses). Rows 3, 4 and the
// streaming rows 5, 6 launch these same entry points.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Hkv, int Sq, int Sk, int D, int causal,
                               float scale, void* stream) {
  if (ft::bad_shape(B, H, Hkv, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk,
                             causal, scale, s);
  if (D == 128)
    return launch_bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                              Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Hkv, int Sq, int Sk, int D,
                                int causal, float scale, void* stream) {
  if (ft::bad_shape(B, H, Hkv, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                              Sq, Sk, causal, scale, s);
  if (D == 128)
    return launch_bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                               Sq, Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The launch shape of a backward kernel (which: 0 dQ, 1 dK/dV) at head dim
// D, into out[8]: threads a block, rows a block owns (dQ query rows, dK/dV
// keys), rows a ring stage holds (keys, query rows), ring stages, dynamic
// shared memory bytes, registers a thread at launch, local (spill and
// stack) bytes a thread, and the consumers' setmaxnreg count.
extern "C" int pt_flash_bwd_config(int which, int D, int* out) {
  if (which == 0 && D == 64)
    return describe(flash_bwd_dq_kernel<64>, kThreads, ft::kDqRows,
                    ft::kDqKeys, kStages, DqSmem<64>::kAlloc, kConsumerRegs,
                    out);
  if (which == 0 && D == 128)
    return describe(flash_bwd_dq_kernel<128>, kThreads, ft::kDqRows,
                    ft::kDqKeys, kStages, DqSmem<128>::kAlloc, kConsumerRegs,
                    out);
  if (which == 1 && D == 64)
    return describe(flash_bwd_dkv_kernel<64>, kThreads, ft::kDkvKeys,
                    ft::kDkvRows, kStages, DkvSmem<64>::kAlloc, kConsumerRegs,
                    out);
  if (which == 1 && D == 128)
    return describe(flash_bwd_dkv_kernel<128>, kThreads, ft::kDkvKeys,
                    ft::kDkvRows, kStages, DkvSmem<128>::kAlloc,
                    kConsumerRegs, out);
  return (int)cudaErrorInvalidValue;
}
