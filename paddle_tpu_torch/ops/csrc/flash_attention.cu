// Causal / GQA flash attention forward for Hopper (sm_90a), on the tensor
// cores through wgmma, fed by a TMA ring. The backward pair (dQ, dK/dV) is
// flash_attention_bwd.cu.
//
// Replaces: paddle_tpu/ops/flash_attention.py, the full-K loop kernel
//   _fwd_kernel_loop      launched by _flash_fwd_bhsd_loop   (:488)
// and the streaming kernel the JAX package takes past _FULL_K_MAX = 8192
// keys (:678, dispatch :771-789)
//   _fwd_kernel           launched by _flash_fwd_bhsd_stream (:189)
// The TPU keeps two forms because its loop kernel holds the whole of K/V in
// VMEM, which stops fitting past 8192 keys; they compute one function. The
// kernel below streams K/V tiles through shared memory at any length, so
// both forms launch the same entry point; the Python wrappers
// (flash_fwd_cuda, flash_fwd_stream_cuda) keep their own launch counters so
// that a run can count row 2 apart from row 1. Long keys are safe here:
// every tensor offset is formed in size_t, row and tile indices stay below
// Sq, Sk < 2^31, and the wrapper refuses a tensor of 2^31 or more elements
// (so b * H + h cannot wrap).
// Head dims: the kernel is a template on D, instantiated for D = 128
// (Llama-3-8B) and D = 64 (ERNIE-3.0 base, 12 heads of 64); the entry
// point takes D and refuses any other.
// Semantics, kept: q (B, H, Sq, D), k/v (B, Hkv, Sk, D), query head h reads
// KV head h / (H / Hkv); causal masks align bottom-right (query i sees key j
// iff j <= i + Sk - Sq). QK in fp32 times `scale`; running max from -1e30,
// running sum and accumulator in fp32; p cast to bf16 before PV;
// O = acc / max(l, 1e-30) in bf16, LSE = m + log(max(l, 1e-30)) in fp32. A
// masked key gets p = 0 exactly, so a row that sees no key (causal with
// Sq > Sk) gets O = 0; every other row matches the TPU kernel.
// Deterministic: every sum is taken in a fixed order, with no atomics.
//
// Bound: operations. At the training shape (B = 2, H = 32, Hkv = 8, S =
// 2048, D = 128, causal) the forward does 2 products of 2*S*S*D/2 flops
// per head (~69 us at the H100 SXM's 989 TFLOP/s bf16 peak, data sheet,
// 700 W) on 84 MB of q, k, v and O (~25 us at its 3.35 TB/s). So the
// products must run on the tensor cores at wgmma's rate.
//
// Design (FlashAttention-3's forward; the backward's shape):
//   * blocks of three warpgroups, one per (128-row query tile, head,
//     batch): warpgroups 0 and 1 consume (64 query rows each, setmaxnreg
//     232 registers a thread), warpgroup 2 produces (setmaxnreg 40; one
//     warp issues the TMA loads, the other three exit). 2 x 128 x 232 +
//     128 x 40 = 64,512 registers, the 168 a thread of a 384-thread block
//     that __launch_bounds__(384, 1) allows.
//   * loads: Q once by TMA, on its own mbarrier; then 128-key K and V tiles
//     through a ring of kStages stages with full and empty mbarriers, from
//     key tile 0 up to the block's causal frontier (flash_tiles::
//     dq_key_tiles, the TPU kernel's early stop). GQA reads the shared KV
//     head through its own tensor map: nothing is repeated in memory. A
//     warpgroup whose rows stop at an earlier frontier releases the block's
//     last stages without computing on them. Q and 3 stages fill 230,456
//     of a block's 232,448 bytes at D = 128 (2 stages ran 14-36 % slower).
//   * products: S = Q.K^T by wgmma m64n128k16 with Q and K both K-major in
//     shared memory; the online softmax in registers (the row max taken
//     over the raw scores, scale * log2(e) folded into one FMA before
//     ex2.approx.ftz where scale > 0; the mask only on tiles that the
//     causal diagonal or a ragged edge crosses, a compile-time branch);
//     P rounded to bf16 straight from the accumulator into the A fragment;
//     O += P.V by wgmma m64n128k16 (m64n64k16 at D = 64) with A from
//     registers and V read MN-major.
//   * overlap inside a warpgroup: tile j's S product and tile j - 1's P.V
//     product are issued together, and tile j's softmax runs while P.V is
//     in flight; O is rescaled once P.V has landed. Across the two
//     warpgroups, ping-pong: each issues its products only in its turn
//     (two named barriers), so that one's softmax runs under the other's
//     products.
//   * epilogue: O scaled by 1 / max(l, 1e-30), rounded to bf16 into the
//     warpgroup's own rows of the Q tile and copied out in 16-byte stores
//     (faster than bf16 pairs stored from the accumulator); LSE per row;
//     no row at or past Sq is written.
//   * launch order (flash_tiles::fwd_block): a 1-D grid in order of
//     falling work: the heavy causal tiles of every head first; without
//     the mask, where every tile weighs the same, one (batch, KV head)'s
//     blocks adjacent, so that they read its K/V through the L2.
//   * TMA: 3-D tensor maps (D, S, B * heads) with 64 x 64 boxes and the
//     128-byte swizzle the wgmma descriptors read (hopper.cuh); a ragged
//     tile zero-fills at its own head's end (flash_common.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
constexpr int kStages = 3;               // ring depth
constexpr int kSmemMax = 232448;         // shared memory a block may use
constexpr int kN = ft::kFwdKeys;         // keys a stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;        // running-max start, as the TPU's
static_assert(kN == 128, "S is one m64n128 product a warpgroup");

template <int kD>
struct FwdSmem {
  static constexpr int kQ = tile_bytes<kD>(ft::kFwdRows);
  static constexpr int kKV = tile_bytes<kD>(kN);    // K or V of a stage
  static constexpr int kStage = 2 * kKV;             // K, V
  static constexpr int kRing = kQ;
  static constexpr int kBars = kRing + kStages * kStage;
  // barriers: Q, full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;   // room to align the base
  static_assert(kAlloc <= kSmemMax, "shared memory of a block");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (the warpgroup's 64 rows x kN keys) = Q.K^T, reduced over D
template <int kD>
__device__ __forceinline__ void issue_s(float (&s)[kN / 2], uint32_t q_a,
                                        uint32_t k_st) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc / 4, o = (kc % 4) * 32;
    wgmma_m64n128k16_ss(s,
                        smem_desc(q_a + c * ft::kFwdRows * kBlockRow + o),
                        smem_desc(k_st + c * kN * kBlockRow + o), kc > 0);
  }
}

// O += P.V, reduced over the stage's kN keys; V read MN-major, all of D in
// one product a 16-key step (at D = 128 its two column blocks kN rows
// apart: m64n128 measured 3-5 % faster than two m64n64)
template <int kD>
__device__ __forceinline__ void issue_pv(float (&acc)[kD / 64][32],
                                         const uint32_t (&pa)[kN / 16][4],
                                         uint32_t v_st) {
  static_assert(kD == 64 || kD == 128, "head dim 64 or 128");
#pragma unroll
  for (int r = 0; r < kN / 16; ++r) {
    if constexpr (kD == 128)
      wgmma_m64n128k16_rs_tb(acc[0], acc[1], pa[r],
                             smem_desc(v_st + r * 2048, kN * kBlockRow), 1);
    else
      wgmma_m64n64k16_rs_tb(acc[0], pa[r], smem_desc(v_st + r * 2048), 1);
  }
}

// The online softmax of one tile, in the log2 domain: m is the running max
// of s * scale * log2(e), l the running sum of this thread's p (the quad
// sums them at the end). s[4 j + e] holds row `row + 8 (e >> 1)`, key
// `key + 8 j + (e & 1)`; it leaves p = exp2(x - m) there, 0 for a masked
// key, and the factor alpha that rescales the rows' earlier sums. With
// kPos (scale > 0) the max is taken over the raw scores and scaled once,
// and each exponent is one FMA; otherwise each score is scaled first.
template <bool kMask, bool kPos>
__device__ __forceinline__ void online_softmax(float (&s)[kN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int row,
                                               int key, int Sq, int Sk,
                                               int causal, float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kPos ? s[4 * j + e] : s[4 * j + e] * sl2;
      if (kMask) {
        const int qr = row + 8 * (e >> 1), kr = key + 8 * j + (e & 1);
        if (!(kr < Sk && (!causal || kr <= qr + (Sk - Sq)))) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mi = quad_max(mx[i]);
    if (kPos) mi *= sl2;
    mi = fmaxf(m[i], mi);
    alpha[i] = exp2_ftz(m[i] - mi);
    m[i] = mi;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float p = exp2_ftz(kPos ? fmaf(x, sl2, -m[e >> 1])
                                    : x - m[e >> 1]);   // 0 if masked
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

__device__ __forceinline__ void to_p(uint32_t (&pa)[kN / 16][4],
                                     const float (&s)[kN / 2]) {
#pragma unroll
  for (int r = 0; r < kN / 16; ++r) acc_to_a(pa[r], s, r);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int B,
                 int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using L = FwdSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto stage = [&](int j) {
    return base + L::kRing + (j % kStages) * L::kStage;
  };

  const int rep = H / Hkv, tiles = ft::cdiv(Sq, ft::kFwdRows);
  const ft::FwdBlock blk =
      ft::fwd_block(blockIdx.x, tiles, H, Hkv, B, causal);
  const int q0 = blk.q0, bh = blk.b * H + blk.h;
  const int bhk = blk.b * Hkv + blk.h / rep;
  const int nk = ft::dq_key_tiles(q0, ft::kFwdRows, kN, Sq, Sk, causal);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
      mbar_arrive_expect_tx(bar_q, L::kQ);
      load_tile<kD, ft::kFwdRows>(base, &tq, bar_q, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::kStage);
        load_tile<kD, kN>(stage(j), &tk, full(s), j * kN, bhk);
        load_tile<kD, kN>(stage(j) + L::kKV, &tv, full(s), j * kN, bhk);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int tw = threadIdx.x % kWg, warp = tw / 32, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + wg * ft::kWgRows;     // the warpgroup's first row
    const int row = qw0 + warp * 16 + g;       // and rows row, row + 8
    // key tiles up to this warpgroup's own frontier (at most nk)
    const int nw = ft::dq_key_tiles(qw0, ft::kWgRows, kN, Sq, Sk, causal);
    const float sl2 = scale * kLog2e;
    const uint32_t q_a = base + wg * ft::kWgRows * kBlockRow;
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % kStages));
    };
    auto softmax = [&](float (&s)[kN / 2], float (&m)[2], float (&l)[2],
                       float (&alpha)[2], int j) {
      const bool mask =
          ft::tile_needs_mask(qw0, ft::kWgRows, j * kN, kN, Sq, Sk, causal);
      if (sl2 > 0.f) {
        if (mask)
          online_softmax<true, true>(s, m, l, alpha, row, j * kN + 2 * t, Sq,
                                     Sk, causal, sl2);
        else
          online_softmax<false, true>(s, m, l, alpha, row, j * kN + 2 * t,
                                      Sq, Sk, causal, sl2);
      } else {
        if (mask)
          online_softmax<true, false>(s, m, l, alpha, row, j * kN + 2 * t,
                                      Sq, Sk, causal, sl2);
        else
          online_softmax<false, false>(s, m, l, alpha, row, j * kN + 2 * t,
                                       Sq, Sk, causal, sl2);
      }
    };
    // ping-pong: warpgroup w issues its products only in its turn, on
    // named barrier 1 + w, and passes the turn to the other when they are
    // issued, so that one's softmax runs under the other's products. Both
    // take nk + 1 turns (turn j issues tile j's S and tile j - 1's P.V;
    // the turns past a warpgroup's own frontier are empty); warpgroup 1
    // passes first, and warpgroup 0 takes its last pass at the end.
    auto my_turn = [&] { bar_sync(1 + wg, 2 * kWg); };
    auto pass_turn = [&] { bar_arrive(2 - wg, 2 * kWg); };
    if (nk > 0 && wg == 1) pass_turn();
    float acc[kD / 64][32];
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {kNegBig * kLog2e, kNegBig * kLog2e}, l[2] = {0.f, 0.f};
    if (nw > 0) {
      float s[kN / 2], alpha[2];
      uint32_t pa[kN / 16][4];
      mbar_wait(bar_q, 0);
      mbar_wait(full(0), 0);
      my_turn();
      wgmma_fence();
      issue_s<kD>(s, q_a, stage(0));
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, m, l, alpha, 0);
      to_p(pa, s);
      for (int j = 1; j < nw; ++j) {
        mbar_wait(full(j % kStages), (j / kStages) & 1);
        // tile j's S and tile j - 1's P.V in flight together
        my_turn();
        wgmma_fence();
        issue_s<kD>(s, q_a, stage(j));
        wgmma_commit();
        issue_pv<kD>(acc, pa, stage(j - 1) + L::kKV);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_regs(s);
        softmax(s, m, l, alpha, j);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) fence_regs(acc[c]);
        release(j - 1);
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
        to_p(pa, s);
      }
      my_turn();
      wgmma_fence();
      issue_pv<kD>(acc, pa, stage(nw - 1) + L::kKV);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) fence_regs(acc[c]);
      release(nw - 1);
    }
    // the block's tiles past this warpgroup's frontier, released unread in
    // its remaining (empty) turns: turn t releases tile t - 1
    if (nk > 0) {
      for (int t = nw > 0 ? nw + 1 : 0; t <= nk; ++t) {
        if (t > 0) {
          mbar_wait(full((t - 1) % kStages), ((t - 1) / kStages) & 1);
          release(t - 1);
        }
        my_turn();
        pass_turn();
      }
      if (wg == 0) my_turn();
    }
    // epilogue: O / max(l, 1e-30) in bf16 goes into this warpgroup's own
    // rows of the Q tile (in its swizzle) once every S product has read
    // them and Q's TMA has landed, then out in 16-byte stores, a row's
    // chunks by neighbouring threads (named barrier 3 + wg)
    if (nk > 0 && nw == 0) mbar_wait(bar_q, 0);
    bar_sync(3 + wg, kWg);
    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float ls = fmaxf(quad_sum(l[half]), 1e-30f);
      inv[half] = 1.f / ls;
      const int qr = row + 8 * half;
      if (t == 0 && qr < Sq)
        lse[size_t(bh) * Sq + qr] = m[half] * kLn2 + logf(ls);
    }
    unsigned char* sq = smem_raw + (base - smem_addr(smem_raw));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wg * ft::kWgRows + warp * 16 + g + 8 * half;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * half;
          __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[c][i] * inv[half],
                                                   acc[c][i + 1] * inv[half]);
          *reinterpret_cast<__nv_bfloat162*>(
              sq + c * ft::kFwdRows * kBlockRow + r * kBlockRow +
              ((j ^ (r & 7)) << 4) + 4 * t) = v2;
        }
    }
    bar_sync(3 + wg, kWg);
    constexpr int kChunks = kD / 8;   // 16-byte chunks a row
#pragma unroll
    for (int it = 0; it < ft::kWgRows * kChunks / kWg; ++it) {
      const int idx = it * kWg + tw, rr = idx / kChunks, ch = idx % kChunks;
      const int r = wg * ft::kWgRows + rr, qr = qw0 + rr;
      const uint4 val = *reinterpret_cast<const uint4*>(
          sq + (ch / 8) * ft::kFwdRows * kBlockRow + r * kBlockRow +
          (((ch % 8) ^ (r & 7)) << 4));
      if (qr < Sq)
        *reinterpret_cast<uint4*>(out + (size_t(bh) * Sq + qr) * kD + ch * 8) =
            val;
    }
  }
}

template <int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  if (!(encode<kD>(&m[0], q, Sq, B * H) && encode<kD>(&m[1], k, Sk, B * Hkv) &&
        encode<kD>(&m[2], v, Sk, B * Hkv)))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = FwdSmem<kD>::kAlloc;
  static bool attr = false;   // one per head dim
  cudaError_t e = allow_smem(flash_fwd_kernel<kD>, kSmem, &attr);
  if (e != cudaSuccess) return (int)e;
  const int blocks = ft::fwd_blocks(ft::cdiv(Sq, ft::kFwdRows), H, B);
  flash_fwd_kernel<kD><<<blocks, kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), B,
      H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 only, head dim D = 64 or 128. q, O: (B, H, Sq, D); k, v:
// (B, Hkv, Sk, D); lse: fp32 (B, H, Sq); all contiguous and 16-byte
// aligned. Returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue, launching nothing, for another D, a bad shape or
// a tensor map that cuTensorMapEncodeTiled refuses). Row 1 and the
// streaming row 2 launch this same entry point.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Hkv, int Sq,
                            int Sk, int D, int causal, float scale,
                            void* stream) {
  if (ft::bad_shape(B, H, Hkv, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

// The forward kernel's launch shape at head dim D, into out[8]: threads a
// block, query rows a block owns, keys a ring stage, ring stages, dynamic
// shared memory bytes, registers a thread at launch, local (spill and
// stack) bytes a thread, and the consumers' setmaxnreg count.
extern "C" int pt_flash_fwd_config(int D, int* out) {
  if (D == 64)
    return describe(flash_fwd_kernel<64>, kThreads, ft::kFwdRows, kN, kStages,
                    FwdSmem<64>::kAlloc, kConsumerRegs, out);
  if (D == 128)
    return describe(flash_fwd_kernel<128>, kThreads, ft::kFwdRows, kN,
                    kStages, FwdSmem<128>::kAlloc, kConsumerRegs, out);
  return (int)cudaErrorInvalidValue;
}
