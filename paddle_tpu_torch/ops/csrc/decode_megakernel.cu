// Whole-tick decode megakernel for Hopper (sm_90a): every decoder layer of
// one decode (W = 1) or verify (W > 1) tick in ONE persistent cooperative
// launch.
//
// Replaces: paddle_tpu/ops/decode_megakernel.py, `_tick_kernel` (launched by
// `decode_tick`, the `pallas_call` at :845), fp or int8 KV pools, with or
// without pooled LoRA deltas. Per layer: RMSNorm, q/k/v products, RoPE, the
// window's K/V written through the block table, paged attention (online
// softmax, the in-window causal mask), o product + residual, RMSNorm,
// SiLU(g) * u, down product + residual.
//
// Bound: bytes. A tick reads every layer's seven projection weights once
// (436 MB a layer at Llama-3-8B, 14 GB a tick) and the rows' visible K/V; at
// B * W rows the products do 2 B W flops per weight element, far below the
// ~295 flops a byte where the bf16 tensor-core rate would limit. So the
// design keeps the weight stream running, across the tick's grid barriers,
// and spends as little as it can on everything else.
//
// Design. One block per SM, all co-resident (a cooperative launch), three
// warpgroups: two consumer warpgroups and a producer warpgroup (setmaxnreg:
// consumers 240 registers, producers 24). The tick is a sequence of phases
// separated by grid barriers of the consumers only:
//   q/k/v products | attention | o products | gate/up products | down products
// five barriers a layer, and with LoRA one more before each served target
// set's products (its shrink, below).
//   * The weight stream. The work plan (tick_plan.cuh) cuts every product
//     phase's weights into 64 x 64 tiles and gives each block a contiguous
//     run of them, the same bytes to within one tile, walked fragment by
//     fragment (a fragment: the block's tiles of one column block and K
//     slice). One producer thread walks the block's schedule for the whole
//     tick, every phase of every layer, issuing one TMA box a tile into a
//     ring of 12 stages (96 KB an SM). It never waits for a grid barrier:
//     while the consumers stage activations, attend or wait at a barrier,
//     it fills the free stages with the next phase's (and the next layer's)
//     tiles. Producer and consumers step through the ring with running
//     counters (no division on the stream's path). The 224 weight tensor
//     maps (7 a layer) are encoded once per weight table into a device
//     table (pt_decode_tick_maps) and prefetched a phase ahead.
//   * The products run on the tensor cores, in swap-AB form: out^T = W^T .
//     x^T, a ring tile the A operand (64 output columns x 64 K, read MN-major
//     from the 128-byte swizzle TMA writes), the rows of x the B operand
//     (N = 8, 16, 32 or 64 rows: one instantiation of the tile loop each),
//     fp32 sums in registers. The two consumer warpgroups take the tiles in
//     turn. At W > 1 every weight is read once for all B * W rows.
//   * x is staged in shared memory one K slice at a time (as the block's
//     fragments reach it) by cp.async, in the swizzled K-major layout wgmma
//     reads; the residual is then normed in place (RMSNorm from its 1/rms,
//     which every block computes for all rows) and rounded to bf16 as the
//     plain twin rounds; then a fence to the async proxy.
//   * K-split sums. At a fragment's end warpgroup 1 hands its sums to
//     warpgroup 0 through shared memory, which adds them in and writes the
//     block's fp32 partial to a scratch slot of its own; one thread then
//     adds one to the output group's arrival counter (acquire-release). The
//     block whose arrival completes the count sums the group's partials in
//     the plan's fixed order and runs the group's epilogue with all its
//     consumers: LoRA expand, RoPE of the (d, d + 64) pairs and the K/V write
//     (q/k/v), the residual (o, down), SiLU(g) * u (gate/up). No floating-
//     point atomics: a tick is deterministic.
//   * Attention. An item is (row b, KV head g, split): a row's visible
//     blocks in splits of 16 blocks, over fp pools anchored at block 0 (a
//     key's split does not depend on the window's width: verify windows
//     round as decode ticks), over int8 pools counted from its last block,
//     so that the blocks a window's inserts requantize lie in one split;
//     the kernel reads pos and sizes the splits on the card. A block's 8 consumer warps take 32 keys
//     each: a lane's QK runs over D for its key (q broadcast from shared
//     memory) and the online softmax over the warp's keys, then PV runs over
//     D across the lanes, the keys in order; the warps' states are merged in
//     warp order, up to 8 query rows a pass. A row of one split writes its
//     output, else each split its (max, sum, unnormalised output) and the
//     last split to arrive merges them in split order.
//   * The grid barrier: a named barrier of the 256 consumer threads, then
//     one thread's release-add and acquire-spin on a counter that the
//     wrapper zeroes each call. The producer takes no part, so the stream
//     runs ahead; the launch stays cooperative for co-residency.
// Each product's output is rounded to bf16 once, the residual is kept in
// bf16, RoPE runs in fp32, the scores are divided by sqrt(D): the plain twin
// (decode_megakernel._tick_plain) rounds the same way. Data written during
// the tick is read with ld.global.cg (L2) by generic loads only, never
// through TMA, so no global write needs a proxy fence. The kernel allocates
// nothing: the residual, q, the attention output, the SiLU product, the
// partial sums and the counters are tensors of the wrapper.
//
// int8 pools (quant = 1; codes (N, bs, KV, D) int8, scales (N, KV) f32, four
// tensors a layer). A window token joins its block by whole-block
// requantization (the reference's _insert_token_q: dequantize the block-head,
// drop the token in, absmax, re-code), which needs the whole block-head. So
// the q/k/v epilogue writes the roped, bf16-rounded K and V rows to a
// scratch (B*W, KV*D), and the attention item of (row b, KV head g) and its
// last split — the only item that touches the window's blocks of head g of
// row b — inserts its W tokens in window order before it reads any block. The
// block-head (bs x 128) is dequantized into shared memory in fp32, the
// per-head absmax reduced over the block, the scale max(amax, 1e-8) / 127
// computed with IEEE division, and the codes rounded half to even (rintf, as
// torch.round) and clamped to +-127. A token bound for scratch block 0 (idle
// and prefilling rows) is not inserted: those rows would requantize block 0
// concurrently; block 0 is never attended, so skipping keeps the kernel
// deterministic and leaves every live block as the reference writes it.
// Attention widens each lane's four codes in registers (exact) with the
// block's two scales beside them, in the mode's order: dequant = 0
// ("scores") multiplies the fp32 QK sum by the k-scale before the division
// by sqrt(D) and p by the v-scale before PV, the running sum taking p
// unscaled; dequant = 1 ("tile") rounds code * scale to bf16 first, as the
// reference dequantizes its VMEM tile.
//
// LoRA (la[t] != nullptr for a served target t of q k v o gate up down):
// the adapter pool's pages are read in place, A (pages, L, in, R) and B
// (pages, L, R, out) f32, the row's page from laidx and its alpha/r from
// lscale; page 0 is the null adapter and its rows are skipped (their
// outputs are the fp kernel's, bit for bit). A delta has two steps. The
// shrink t = x @ A[page] needs a whole input row, complete only after a
// grid barrier, and every expand of its target needs all of t, so it gets a
// phase of its own before its products: items (row, target, 512-wide K
// slice) write fp32 partial sums to a scratch (B*W, 7, NS, R), then a
// barrier. The expand runs in the group's epilogue: it sums the
// slices of its rows in order, d = s * (t @ B[page]) in fp32, and out =
// bf16(bf16(base) + bf16(d)) — the JAX kernel's rounding (the fused LoRA
// kernel of the per-layer path rounds once instead). q/k/v deltas come
// before RoPE and the K/V write, the o delta reads the attention output,
// the down delta SiLU(g) * u.
//
// The clock counters: with a trace buffer (a diagnostic call; null on the
// served path) the kernel records, for each (layer, phase, block), the
// global timer at phase entry, at the end of the block's work and at its
// exit from the grid barrier, the consumers' summed wait on the ring and
// the producer's summed wait on a full ring. The output is the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tick_plan.cuh"

namespace {

using namespace hopper;
namespace tp = tick_plan;
typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and the producer warpgroup
constexpr int kWarps = kConsumers / 32;       // consumer warps
constexpr int kHeadDim = tp::kHeadDim;
constexpr int kMaxRows = tp::kMaxRows;        // B * W
constexpr int kAttnRows = 8;    // query rows of one attention pass
constexpr int kSplitBlocks = 16;  // KV blocks of one attention split
constexpr int kTargets = 7;     // LoRA targets: q k v o gate up down
constexpr int kMaxRank = tp::kMaxRank;
constexpr int kShrink = 512;    // K slice of one shrink item
constexpr int kMaxBlock = 128;  // int8 pools: bs <= 128
constexpr int kStages = tp::kStages;
constexpr int kUnit = tp::kUnitBytes;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBarConsumers = 1;  // the named barrier of all consumers
constexpr float kNegInf = -1e30f;
// the clock counters' layout: phases of a layer (LoRA shrinks included) and
// the slots of a (layer, phase, block): entry, end of work, barrier exit,
// then sums in ns: the consumers' ring waits, the producer's waits on a full
// ring, and three parts of the consumers' work (a product phase: staging x,
// fragment ends with their arrivals, epilogues; attention: the key loops,
// the merges of splits, the int8 inserts)
constexpr int kPhases = 9;
constexpr int kTraceSlots = 8;
// the trace phase of each product phase (q/k/v, o, gate/up, down)
__device__ __forceinline__ int trace_phase(int ph) {
  return ph == tp::kQKV ? 1 : ph == tp::kO ? 4 : ph == tp::kGateUp ? 6 : 8;
}

struct Args {
  const CUtensorMap* maps;   // (7, L): wq wk wv wo wg wu wd
  const long long* wptrs;    // (9, L): wq wk wv wo wg wu wd ln1 ln2
  const long long* pools;    // fp: (2 L) k0 v0 ...; int8: (4 L) kq0 ks0 vq0 vs0 ...
  const int* tables;         // (B, M)
  const int* pos;            // (B,)
  const float* cos_rows;     // (B*W, D/2)
  const float* sin_rows;
  bf16* xres;                // (B*W, hid) in: embedded rows; out: residual
  bf16* q;                   // (B*W, H*D) scratch
  bf16* ao;                  // (B*W, H*D) scratch
  bf16* hbuf;                // (B*W, I) scratch
  bf16* ktok;                // int8: (B*W, KV*D) roped K rows of the window
  bf16* vtok;                // int8: (B*W, KV*D) V rows of the window
  const float* la[kTargets];   // LoRA A (pages, L, in, R) or nullptr
  const float* lb[kTargets];   // LoRA B (pages, L, R, out) or nullptr
  const float* lscale;       // (pages,) alpha / r
  const int* laidx;          // (B,) page of each row
  float* lpart;              // (B*W, 7, NS, R) shrink partial sums
  float* part;               // product partials: tick_plan::scratch_floats
  float* apart;              // attention split partials (B, KV, MS, W rep, 130)
  unsigned* gsync;           // [0] grid barrier, then the group counters
  unsigned* acnt;            // (B, KV) attention split counters
  unsigned long long* trace; // (L, kPhases, grid, kTraceSlots) or nullptr
  tp::Dims dims;
  int L, B, W, H, KV, I, bs, M, MS;   // MS: most attention splits of a row
  int dequant, R, NS;        // int8: 0 "scores", 1 "tile"; LoRA rank, slices
  float eps;
};

// Shared memory, at a 1024-byte aligned base
struct Smem {
  unsigned char ring[kStages][kUnit];    // weight stages
  union {
    unsigned char xs[tp::kUnionBytes];   // x slab [K step][row][64]
    float red[kMaxBlock * kHeadDim];     // int8: one dequantized block-head
    struct {
      float q[kAttnRows * kHeadDim];
      float m[kWarps * kAttnRows];
      float l[kWarps * kAttnRows];
      float o[kWarps * kAttnRows * kHeadDim];
    } at;
  } u;
  float lt[tp::kLtFloats];               // LoRA t rows of an epilogue; at a
                                         // fragment's end warpgroup 1's sums
  float inv[kMaxRows];                   // per-row 1/rms
  float wred[kWarps * kMaxRank];         // per-warp partials of a reduction
  int flag;                              // the block's last-arrival flag
  int aprefix[kMaxRows + 1];             // attention splits before row b
  unsigned long long full[kStages], empty[kStages];
};
static_assert(sizeof(Smem) + tp::kGridAlign <= tp::kSmemBytes,
              "Smem outgrew the plan's budget");
static_assert(offsetof(Smem, u) % 1024 == 0, "the slab keeps the swizzle");

__device__ __forceinline__ void csync() { bar_sync(kBarConsumers, kConsumers); }

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* trace_at(const Args& a, int l,
                                                        int p, int slot) {
  return a.trace +
         (((size_t)l * kPhases + p) * gridDim.x + blockIdx.x) * kTraceSlots +
         slot;
}

// add v to slot `slot` of (layer l, phase p) (with a trace buffer)
__device__ __forceinline__ void trace_add(const Args& a, int l, int p,
                                          int slot, unsigned v) {
  if (a.trace != nullptr) atomicAdd(trace_at(a, l, p, slot), (unsigned long long)v);
}

// the global timer's low 32 bits when tracing (differences of under 4 s
// come out right modulo 2^32), else 0
__device__ __forceinline__ unsigned ttime(const Args& a) {
  unsigned t = 0;
  if (a.trace != nullptr) asm volatile("mov.u32 %0, %%globaltimer_lo;" : "=r"(t));
  return t;
}

// slot 0 (entry) of (layer l, phase p), by consumer thread 0
__device__ __forceinline__ void stamp_entry(const Args& a, int l, int p) {
  if (a.trace != nullptr && threadIdx.x == 0) *trace_at(a, l, p, 0) = globaltimer();
}

__device__ __forceinline__ float bf(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float ldcg_bf(const bf16* p) {
  unsigned short s = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(s));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// an arrival at a counter: release of this thread's (and, through the
// named barrier before it, its block's) writes, acquire of the writes of
// the arrivals before it; returns the old count
__device__ __forceinline__ unsigned arrive_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// The grid barrier of the consumers (the k-th of the tick, k = *nbar): a
// named barrier of the block's consumers, then thread 0's release-add and
// acquire-spin on the monotone counter gsync[0]. With a trace, the end of
// the block's work (slot 1) and the exit (slot 2) of (layer l, phase p).
__device__ void grid_barrier(const Args& a, int* nbar, int l, int p) {
  csync();
  if (threadIdx.x == 0) {
    if (a.trace != nullptr) *trace_at(a, l, p, 1) = globaltimer();
    __threadfence();
    atomicAdd(a.gsync, 1u);
    const unsigned target = (unsigned)(*nbar + 1) * gridDim.x;
    while (ld_acquire(a.gsync) < target) {
    }
    __threadfence();
  }
  ++*nbar;
  csync();
  if (a.trace != nullptr && threadIdx.x == 0) *trace_at(a, l, p, 2) = globaltimer();
}

// (in, out) dims of LoRA target t (q k v o gate up down).
__device__ __forceinline__ void lora_dims(const Args& a, int t, int& K, int& N) {
  const int hid = a.H * kHeadDim;
  K = t == 6 ? a.I : hid;
  N = t == 1 || t == 2 ? a.KV * kHeadDim : t == 4 || t == 5 ? a.I : hid;
}

// 1/rms of every row of the residual, into s.inv (all consumers).
__device__ void row_inv_rms(const Args& a, int rows, int hid, Smem& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const uint4* x = reinterpret_cast<const uint4*>(a.xres + (size_t)r * hid);
    float ss = 0.f;
#pragma unroll 8
    for (int i = lane; i < hid / 8; i += 32) {
      float f[8];
      unpack8(__ldcg(x + i), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    }
    ss = warp_sum(ss);
    if (lane == 0) s.inv[r] = rsqrtf(ss / (float)hid + a.eps);
  }
}

// ------------------------------------------------------------ LoRA
// True when one of the LoRA targets t0 .. t0 + nt - 1 is served.
__device__ __forceinline__ bool any_served(const Args& a, int t0, int nt) {
  for (int t = t0; t < t0 + nt; ++t)
    if (a.la[t] != nullptr) return true;
  return false;
}

// Input of a shrink: the normed residual (norm != nullptr) or a bf16
// activation (src).
struct XSrc {
  const bf16* src;
  const bf16* norm;   // norm weight (hid,) or nullptr
  int ld;             // row length of src
};

// Element k of input row r, normed and rounded as the slab is.
__device__ __forceinline__ float x_at(const XSrc& x, int r, int k, const Smem& s) {
  const float f = ldcg_bf(x.src + (size_t)r * x.ld + k);
  if (x.norm == nullptr) return f;
  return bf(__fmul_rn(__fmul_rn(f, s.inv[r]), __bfloat162float(x.norm[k])));
}

// Shrink phase of the LoRA targets t0 .. t0 + nt - 1 (they share the input
// x and its length): for each served target t, every row r on a page
// other than 0 and every K slice sp, lpart[r][t][sp][:R] = the slice's
// share of x[r] @ A_t[page, l]. An item is (row, target, slice); its 256
// threads take K elements in turn and the partial sums are reduced in a
// fixed order (warp trees, then the warps in order).
__device__ void phase_shrink(const Args& a, int l, int t0, int nt,
                             const XSrc& x, Smem& s) {
  const int rows = a.B * a.W, R = a.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int K, N;
  lora_dims(a, t0, K, N);
  const int ns = (K + kShrink - 1) / kShrink;
  if (x.norm != nullptr) {
    row_inv_rms(a, rows, a.H * kHeadDim, s);
    csync();
  }
  for (int it = blockIdx.x; it < rows * nt * ns; it += gridDim.x) {
    const int r = it / (nt * ns), t = t0 + (it / ns) % nt, sp = it % ns;
    const int page = __ldg(a.laidx + r / a.W);
    if (page == 0 || a.la[t] == nullptr) continue;
    const float* A = a.la[t] + ((size_t)page * a.L + l) * K * R;
    float acc[kMaxRank];
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) acc[j] = 0.f;
    const int k1 = min(K, (sp + 1) * kShrink);
    for (int k = sp * kShrink + threadIdx.x; k < k1; k += kConsumers) {
      const float xv = x_at(x, r, k, s);
      const float* ak = A + (size_t)k * R;
#pragma unroll
      for (int j = 0; j < kMaxRank; ++j)
        if (j < R) acc[j] = fmaf(xv, __ldg(ak + j), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) {
      if (j >= R) break;
      const float v = warp_sum(acc[j]);
      if (lane == 0) s.wred[warp * kMaxRank + j] = v;
    }
    csync();
    if (threadIdx.x < R) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += s.wred[w * kMaxRank + threadIdx.x];
      a.lpart[(((size_t)r * kTargets + t) * a.NS + sp) * R + threadIdx.x] = v;
    }
    csync();
  }
}

// ------------------------------------------------------------ products
// acc (64 W columns x N rows, fp32) += A (64 x 16, MN-major) . B (16 x N,
// K-major), N = 8, 16, 32, 64: the accumulator of m64nN, N / 2 registers a
// thread
__device__ __forceinline__ void mma_n8(float (&d)[4], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n16(float (&d)[8], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}


// acc += a ring tile (64 K x 64 columns at `a`) times the slab's tile of x
// (NR rows x 64 K at `b`): four k16 steps
template <int NR>
__device__ __forceinline__ void unit_products(float (&acc)[NR / 2], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < tp::kKStep / 16; ++kk) {
    const uint64_t da = smem_desc(a + kk * 2048);   // 16 K rows
    const uint64_t db = smem_desc(b + kk * 32);     // 16 K columns
    if constexpr (NR == 8)
      mma_n8(acc, da, db);
    else if constexpr (NR == 16)
      mma_n16(acc, da, db);
    else if constexpr (NR == 32)
      mma_n32(acc, da, db);
    else
      mma_n64(acc, da, db);
  }
}

// A position in the ring: the stage and the parity of its mbarriers' phase,
// advanced one unit at a time (no division on the stream's path)
struct RingPos {
  int st = 0;
  unsigned ph = 0;
  __device__ __forceinline__ void next() {
    if (++st == kStages) {
      st = 0;
      ph ^= 1u;
    }
  }
};

// the producer: one thread walks the block's fragments of every product
// phase of every layer (the consumers' walk, tick_plan::next_frag), one TMA
// box a unit into the ring; it waits only for free stages
__device__ void producer(const Args& a, Smem& s) {
  const uint32_t ring = smem_addr(s.ring);
  const uint32_t full = smem_addr(s.full), empty = smem_addr(s.empty);
  RingPos rp;
  for (int l = 0; l < a.L; ++l) {
    for (int ph = 0; ph < tp::kProductPhases; ++ph) {
      const tp::PhasePlan p = tp::plan(a.dims, ph, gridDim.x);
      int u = tp::block_start(p, blockIdx.x);
      const int u1 = tp::block_start(p, blockIdx.x + 1);
      const int w0 = ph == tp::kQKV ? 0 : ph == tp::kO ? 3 : ph == tp::kGateUp ? 4 : 6;
      const int nw = ph == tp::kQKV ? 3 : ph == tp::kGateUp ? 2 : 1;
      for (int w = w0; w < w0 + nw; ++w) prefetch_tensormap(a.maps + w * a.L + l);
      while (u < u1) {
        const tp::Frag f = tp::next_frag(p, &u, u1);
        int w, n0;
        tp::columns(a.dims, ph, tp::item_group(p, f.item), tp::item_col(f.item),
                    &w, &n0);
        const CUtensorMap* map = a.maps + w * a.L + l;
        for (int k = 0; k < f.n; ++k, rp.next()) {
          const unsigned t0 = ttime(a);
          mbar_wait(empty + 8 * rp.st, rp.ph ^ 1u);
          trace_add(a, l, trace_phase(ph), 4, ttime(a) - t0);
          mbar_arrive_expect_tx(full + 8 * rp.st, kUnit);
          tma_load_2d(ring + rp.st * kUnit, map, full + 8 * rp.st, n0,
                      (f.t0 + k) * tp::kKStep);
        }
      }
    }
  }
}

// x rows [0, nr) x K steps [k0, k1) of a phase's input into the slab: the
// normed residual (norm != nullptr; s.inv holds the rows' 1/rms), or a bf16
// activation, rounded to bf16, rows past `rows` zero; K step t's tile at
// (t - k0) nr 128 bytes, row r at r 128 bytes, 16-byte chunk c at (c ^ r % 8)
// 16 bytes: the 128-byte swizzle wgmma reads K-major. The rows are copied
// by cp.async (L2 to shared memory, every copy in flight at once), then
// each thread norms its own chunks in place.
__device__ void stage_slab(const bf16* src, const bf16* norm, int ld, int rows,
                           int nr, int k0, int k1, Smem& s) {
  const int nk = (k1 - k0) * (tp::kKStep / 8);   // 16-byte chunks a row
  auto chunk = [&](int v) {
    const int r = v / nk, kv = v % nk;
    return reinterpret_cast<uint4*>(
        s.u.xs + ((kv >> 3) * nr + r) * 128 + (((kv & 7) ^ (r & 7)) << 4));
  };
  for (int v = threadIdx.x; v < nr * nk; v += kConsumers) {
    const int r = v / nk;
    if (r < rows) {
      const bf16* g = src + (size_t)r * ld + k0 * tp::kKStep + (v % nk) * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(chunk(v))),
                   "l"(g)
                   : "memory");
    } else {
      *chunk(v) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (norm == nullptr) return;
  for (int v = threadIdx.x; v < rows * nk; v += kConsumers) {
    uint4* q = chunk(v);
    float f[8], w[8];
    unpack8(*q, f);
    unpack8(__ldg(reinterpret_cast<const uint4*>(norm + k0 * tp::kKStep +
                                                 (v % nk) * 8)),
            w);
    const float inv = s.inv[v / nk];
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = pack_bf16(__fmul_rn(__fmul_rn(f[2 * j], inv), w[2 * j]),
                       __fmul_rn(__fmul_rn(f[2 * j + 1], inv), w[2 * j + 1]));
    *q = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// a fragment's partial (64 columns x rows) into its slot, by warpgroup 0:
// thread (warp w, lane 4 g + t) holds columns 16 w + g (+ 8) of rows 8 i +
// 2 t (+ 1)
template <int NR>
__device__ __forceinline__ void write_partial(float* P, int rows,
                                              const float (&acc)[NR / 2]) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NR / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * i + 2 * t + (e & 1);
      const int col = warp * 16 + g + 8 * (e >> 1);
      if (row < rows) P[row * tp::kColBlock + col] = acc[4 * i + e];
    }
}

// The units of fragment f, summed on the tensor cores at row tile NR (the
// block's units go to the consumer warpgroups in turn: rp is the ring
// position of the next unit, par the warpgroup that takes it; both walk
// every unit), then the block's partial: warpgroup 1's sums through shared
// memory into warpgroup 0's, in that order, written to P. Returns the
// trace's time at the end of the units (0 without a trace).
template <int NR>
__device__ __forceinline__ unsigned fragment_units(const Args& a, int l, int ph,
                                               const tp::Frag& f, int k0,
                                               RingPos& rp, int& par,
                                               float* P, int rows, Smem& s) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, lane = tid & 31;
  const uint32_t ring = smem_addr(s.ring), xs = smem_addr(s.u.xs);
  const uint32_t full = smem_addr(s.full), empty = smem_addr(s.empty);
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  float acc[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int k = 0; k < f.n; ++k, rp.next(), par ^= 1) {
    if (par != wg) continue;
    const unsigned t0 = ttime(a);
    mbar_wait(full + 8 * rp.st, rp.ph);
    if (tid == 0) trace_add(a, l, trace_phase(ph), 3, ttime(a) - t0);
    wgmma_fence();
    unit_products<NR>(acc, ring + rp.st * kUnit, xs + (f.t0 + k - k0) * NR * 128);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (prev >= 0) release(prev);
    prev = rp.st;
  }
  const unsigned t_end = ttime(a);
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0) release(prev);
  float* X = s.lt;          // free between epilogues: NR / 2 x 128 floats
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) X[i * 128 + tid] = acc[i];
  }
  csync();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[i] += X[i * 128 + tid];
    write_partial<NR>(P, rows, acc);
  }
  return t_end;
}

// The fragments of column block c of group g in the plan's order (K
// slice, then block): a cursor over (slice, block) pairs, blocks that
// stream no unit included (they add zeros)
struct FragCursor {
  int sl, b, b1, i;
  __device__ __forceinline__ FragCursor(const tp::PhasePlan& p, int g, int c)
      : sl(0), i(tp::item_of(p, 0, g, c)) {
    tp::item_blocks(p, i, &b, &b1);
  }
  __device__ __forceinline__ void next(const tp::PhasePlan& p, int g, int c) {
    if (++b > b1 && ++sl < p.S) {
      i = tp::item_of(p, sl, g, c);
      tp::item_blocks(p, i, &b, &b1);
    }
  }
};

// the sums of column block c of group g at row r, columns 4 q .. 4 q + 3,
// over its fragments in the plan's order (K slice, block); eight
// fragments' loads in flight at a time
__device__ __forceinline__ float4 group_sum(const Args& a,
                                            const tp::PhasePlan& p, int g,
                                            int c, int r, int q, int rows) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  FragCursor fc(p, g, c);
  while (fc.sl < p.S) {
    float4 x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool ok = fc.sl < p.S && (p.U >= p.NB || tp::streams(p, fc.b));
      x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok)
        x[k] = __ldcg(reinterpret_cast<const float4*>(
                          a.part + ((size_t)tp::slot(fc.i, fc.b) * rows + r) *
                                       tp::kColBlock) + q);
      if (fc.sl < p.S) fc.next(p, g, c);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v.x += x[k].x; v.y += x[k].y; v.z += x[k].z; v.w += x[k].w;
    }
  }
  return v;
}

// The epilogue of group g of product phase ph, by the consumers of the
// block whose arrival completed it, a thread for each 4 columns of a row: the
// group's sums, its LoRA deltas (bf16(bf16(base) + bf16(d))), then RoPE and
// the q / K / V writes (q/k/v), the residual (o, down) or SiLU(g) * u
// (gate/up).
template <bool kQ, bool kLora>
__device__ void epilogue(const Args& a, int l, int ph, const tp::PhasePlan& p,
                         int g, Smem& s) {
  const int tid = threadIdx.x, rows = a.B * a.W;
  const int D = kHeadDim, H = a.H, KV = a.KV, hid = H * D;
  // the group's kind: q/k/v 0 / 1 / 2 and its head; its LoRA targets
  const int kind = ph != tp::kQKV ? 3 : g < H ? 0 : g < H + KV ? 1 : 2;
  const int head = kind == 0 ? g : kind == 1 ? g - H : g - H - KV;
  const int t0 = ph == tp::kQKV ? kind : ph == tp::kO ? 3 : ph == tp::kGateUp ? 4 : 6;
  const int t1 = ph == tp::kGateUp ? 5 : t0;
  float* lt = s.lt;
  const bool lora = kLora && (a.la[t0] != nullptr || a.la[t1] != nullptr);
  if (lora) {
    // t = x @ A of each row on a page other than 0, summed over its shrink
    // slices in order, for each target of the group
    const int R = a.R;
    for (int idx = tid; idx < 2 * rows * R; idx += kConsumers) {
      const int c = idx / (rows * R), r = (idx / R) % rows, jj = idx % R;
      const int t = c ? t1 : t0;
      int K, N;
      lora_dims(a, t, K, N);
      const int ns = (K + kShrink - 1) / kShrink;
      float v = 0.f;
      if (a.la[t] != nullptr && __ldg(a.laidx + r / a.W) != 0) {
        const float* pp = a.lpart + (((size_t)r * kTargets + t) * a.NS) * R + jj;
        for (int sp = 0; sp < ns; ++sp) v += __ldcg(pp + (size_t)sp * R);
      }
      lt[(c * kMaxRows + r) * kMaxRank + jj] = v;
    }
    csync();
  }
  constexpr int kQuads = tp::kColBlock / 4;
  for (int idx = tid; idx < rows * kQuads; idx += kConsumers) {
    const int r = idx / kQuads, q = idx % kQuads, j = 4 * q;
    float v[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 u = group_sum(a, p, g, c, r, q, rows);
      v[c][0] = u.x; v[c][1] = u.y; v[c][2] = u.z; v[c][3] = u.w;
      if (lora) {
        const int t = c ? t1 : t0;
        const int page = __ldg(a.laidx + r / a.W);
        if (a.la[t] != nullptr && page != 0) {
          int K, N, w, n0;
          lora_dims(a, t, K, N);
          tp::columns(a.dims, ph, g, c, &w, &n0);
          const float* bp = a.lb[t] + ((size_t)page * a.L + l) * a.R * N + n0 + j;
          const float* tr = lt + (c * kMaxRows + r) * kMaxRank;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < a.R; ++k) {
            const float4 bk = __ldg(reinterpret_cast<const float4*>(bp + (size_t)k * N));
            d[0] = fmaf(tr[k], bk.x, d[0]);
            d[1] = fmaf(tr[k], bk.y, d[1]);
            d[2] = fmaf(tr[k], bk.z, d[2]);
            d[3] = fmaf(tr[k], bk.w, d[3]);
          }
          const float sc = __ldg(a.lscale + page);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[c][e] = bf(bf(v[c][e]) + bf(d[e] * sc));
        }
      }
    }
    if (ph == tp::kQKV) {
      const int st = kQ ? 4 : 2;
      bf16* dst = nullptr;
      if (kind == 0) {
        dst = a.q + (size_t)r * hid + head * D;
      } else if (kQ) {                       // to the token scratch
        dst = (kind == 1 ? a.ktok : a.vtok) + (size_t)r * KV * D + head * D;
      } else {
        const int b = r / a.W, pj = __ldg(a.pos + b) + r % a.W;
        if (pj / a.bs < a.M) {
          const int blk = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
          dst = reinterpret_cast<bf16*>(a.pools[st * l + (kind == 1 ? 0 : st / 2)]) +
                (((size_t)blk * a.bs + pj % a.bs) * KV + head) * D;
        }
      }
      if (dst != nullptr) {
        bf16 o1[4], o2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kind < 2) {
            const float x1 = bf(v[0][e]), x2 = bf(v[1][e]);
            const float cs = __ldg(a.cos_rows + (size_t)r * (D / 2) + j + e);
            const float sn = __ldg(a.sin_rows + (size_t)r * (D / 2) + j + e);
            o1[e] = __float2bfloat16(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
            o2[e] = __float2bfloat16(__fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)));
          } else {
            o1[e] = __float2bfloat16(v[0][e]);
            o2[e] = __float2bfloat16(v[1][e]);
          }
        }
        *reinterpret_cast<uint2*>(dst + j) = *reinterpret_cast<const uint2*>(o1);
        *reinterpret_cast<uint2*>(dst + j + D / 2) = *reinterpret_cast<const uint2*>(o2);
      }
    } else if (ph == tp::kGateUp) {
      bf16 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gt = bf(v[0][e]), up = bf(v[1][e]);
        const float silu = bf(gt / (1.0f + expf(-gt)));
        h[e] = __float2bfloat16(silu * up);
      }
      *reinterpret_cast<uint2*>(a.hbuf + (size_t)r * a.I + g * tp::kColBlock + j) =
          *reinterpret_cast<const uint2*>(h);
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        bf16* xp = a.xres + (size_t)r * hid + g * 2 * tp::kColBlock +
                   c * tp::kColBlock + j;
        const uint2 old = __ldcg(reinterpret_cast<const uint2*>(xp));
        const bf16* ov = reinterpret_cast<const bf16*>(&old);
        bf16 nv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nv[e] = __float2bfloat16(__bfloat162float(ov[e]) + bf(v[c][e]));
        *reinterpret_cast<uint2*>(xp) = *reinterpret_cast<const uint2*>(nv);
      }
    }
  }
}

// A product phase, by the consumers: for each of the block's fragments,
// stage x of its K slice when the slice changes, sum its units on the
// tensor cores (fragment_units), write the partial and arrive at the
// group's counter; the block whose arrival completes a group runs its
// epilogue.
template <bool kQ, bool kLora>
__device__ void product_phase(const Args& a, int l, int ph, Smem& s,
                              RingPos& rp, int& par) {
  const tp::PhasePlan p = tp::plan(a.dims, ph, gridDim.x);
  const int blk = blockIdx.x, rows = a.B * a.W, hid = a.H * kHeadDim;
  const int u0 = tp::block_start(p, blk), u1 = tp::block_start(p, blk + 1);
  if (u1 <= u0) return;
  const unsigned t_inv = ttime(a);
  const bf16* norm = ph == tp::kQKV ? reinterpret_cast<const bf16*>(a.wptrs[7 * a.L + l])
                     : ph == tp::kGateUp ? reinterpret_cast<const bf16*>(a.wptrs[8 * a.L + l])
                     : nullptr;
  const bf16* src = ph == tp::kO ? a.ao : ph == tp::kDown ? a.hbuf : a.xres;
  if (norm != nullptr) {
    row_inv_rms(a, rows, hid, s);
    csync();
  }
  if (threadIdx.x == 0) trace_add(a, l, trace_phase(ph), 5, ttime(a) - t_inv);
  int staged = -1, k0 = 0;     // the K slice in the slab, its first K step
  const int lane = threadIdx.x & 31;
  int u = u0;
  while (u < u1) {
    const tp::Frag f = tp::next_frag(p, &u, u1);
    const int sl = tp::item_slice(p, f.item);
    if (sl != staged) {
      // x of the fragment's K slice into the slab, once both warpgroups
      // are done with the slice before (both walk the same fragments)
      const unsigned t0 = ttime(a);
      int k1;
      tp::slice_steps(p, sl, &k0, &k1);
      csync();
      stage_slab(src, norm, ph == tp::kDown ? a.I : hid, rows, p.nr, k0, k1, s);
      fence_proxy_async();
      csync();
      staged = sl;
      if (threadIdx.x == 0) trace_add(a, l, trace_phase(ph), 5, ttime(a) - t0);
    }
    float* P = a.part + (size_t)tp::slot(f.item, blk) * rows * tp::kColBlock;
    const unsigned t_end =
        p.nr == 8 ? fragment_units<8>(a, l, ph, f, k0, rp, par, P, rows, s)
        : p.nr == 16 ? fragment_units<16>(a, l, ph, f, k0, rp, par, P, rows, s)
        : p.nr == 32 ? fragment_units<32>(a, l, ph, f, k0, rp, par, P, rows, s)
        : fragment_units<64>(a, l, ph, f, k0, rp, par, P, rows, s);
    // arrive; the block whose arrival completes the group's count (its
    // fragments, which the first warp adds up over the group's items, a
    // lane an item) finishes the group
    const int g = tp::item_group(p, f.item);
    unsigned target = 0;
    if (threadIdx.x < 32) {
      for (int it = lane; it < 2 * p.S; it += 32)
        target += tp::item_frags(p, tp::item_of(p, it >> 1, g, it & 1));
      target = (unsigned)warp_sum_int(target);
    }
    csync();
    if (threadIdx.x == 0) {
      const int last = arrive_acq_rel(a.gsync + 1 + g) + 1 == target;
      if (last) a.gsync[1 + g] = 0;   // for the next phase, after a barrier
      s.flag = last;
    }
    csync();
    const unsigned t_arrived = ttime(a);
    if (threadIdx.x == 0) trace_add(a, l, trace_phase(ph), 6, t_arrived - t_end);
    if (s.flag) {
      epilogue<kQ, kLora>(a, l, ph, p, g, s);
      csync();                        // lt is free for the next fragment
      if (threadIdx.x == 0) trace_add(a, l, trace_phase(ph), 7, ttime(a) - t_arrived);
    }
  }
}

// ------------------------------------------------------------ attention
// int8: insert one token (head g's 128 values at `tok`) at slot `off` of
// block `bid`, requantizing the block-head in place (all consumers).
__device__ void insert_token_q(int8_t* codes, float* scales, const bf16* tok,
                               int bid, int off, int g, const Args& a, Smem& s) {
  const int D = kHeadDim, n = a.bs * D;
  const size_t row = (size_t)a.KV * D;
  int8_t* base = codes + (size_t)bid * a.bs * row + (size_t)g * D;
  const float sc = __ldcg(scales + (size_t)bid * a.KV + g);
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += kConsumers) {
    const int j = i / D, d = i % D;
    const float v = j == off ? ldcg_bf(tok + d)
                             : __fmul_rn((float)__ldcg(base + j * row + d), sc);
    s.u.red[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) s.wred[threadIdx.x >> 5] = amax;
  csync();
  float m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s.wred[w]);
  const float ns = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  for (int i = threadIdx.x; i < n; i += kConsumers) {
    const float qv = fminf(fmaxf(rintf(__fdiv_rn(s.u.red[i], ns)), -127.f), 127.f);
    base[(i / D) * row + i % D] = (int8_t)qv;
  }
  if (threadIdx.x == 0) scales[(size_t)bid * a.KV + g] = ns;
  csync();
}

// One lane's four K (or V) elements of one key as loaded: four bf16 (fp
// pool) or four int8 codes.
template <bool kQ> struct Raw4 { typedef uint2 T; typedef bf16 E; };
template <> struct Raw4<true> { typedef unsigned T; typedef int8_t E; };

// A lane's eight K elements of one key (its QK runs over D): 16 bytes of
// bf16 or 8 of int8 codes, widened as widen4 does.
template <bool kQ> struct Raw8 { typedef uint4 T; };
template <> struct Raw8<true> { typedef uint2 T; };
template <bool kQ>
__device__ __forceinline__ void widen8(const typename Raw8<kQ>::T& u, float sc,
                                       bool tile, float* f) {
  if constexpr (kQ) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = (float)(int8_t)((e < 4 ? u.x : u.y) >> (8 * (e & 3)));
      f[e] = tile ? bf(__fmul_rn(c, sc)) : c;
    }
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
  }
}

// Widen them to fp32: exact, or for dequant "tile" the rounded code * scale.
template <bool kQ>
__device__ __forceinline__ void widen4(const typename Raw4<kQ>::T& u, float sc,
                                       bool tile, float* f) {
  if constexpr (kQ) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = (float)(int8_t)(u >> (8 * e));
      f[e] = tile ? bf(__fmul_rn(c, sc)) : c;
    }
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(e[j]);
  }
}

// The attention phase. Row b's nb visible blocks go in splits of
// kSplitBlocks, over fp pools from block 0 (split sp: blocks [16 sp, 16 sp
// + 16)), over int8 pools counted from its last block (split 0 the last,
// holding every block the window writes); an item is (row, KV head g,
// split), in the
// order of s.aprefix. Per item the block's 8 consumer warps share its
// blocks, each keeping an online softmax per query row, merged in warp
// order; a row of one split writes its output rows, else the split writes
// (max, sum, unnormalised output) a query row to a.apart and the last
// split to arrive at (b, g)'s counter merges the splits in order.
template <bool kQ>
__device__ void phase_attention(const Args& a, int l, Smem& s) {
  const bool tile = kQ && a.dequant == 1;   // dequant "tile", else "scores"
  const int D = kHeadDim, H = a.H, KV = a.KV, hid = H * D;
  const int rep = H / KV, Wr = a.W * rep;
  const int st = kQ ? 4 : 2;
  typedef typename Raw4<kQ>::T RawT;
  typedef typename Raw4<kQ>::E ElemT;
  const ElemT* kpool = reinterpret_cast<const ElemT*>(a.pools[st * l]);
  const ElemT* vpool = reinterpret_cast<const ElemT*>(a.pools[st * l + st / 2]);
  const float* kscl = kQ ? reinterpret_cast<const float*>(a.pools[4 * l + 1]) : nullptr;
  const float* vscl = kQ ? reinterpret_cast<const float*>(a.pools[4 * l + 3]) : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sqrt_d = sqrtf((float)D);
  const size_t key_stride = (size_t)KV * D;
  // each row's splits, then their prefix sums
  if (threadIdx.x < a.B) {
    const int nb = min((__ldg(a.pos + threadIdx.x) + a.W - 1) / a.bs + 1, a.M);
    s.aprefix[threadIdx.x + 1] = (nb + kSplitBlocks - 1) / kSplitBlocks;
  }
  csync();
  if (threadIdx.x == 0) {
    s.aprefix[0] = 0;
    for (int b = 0; b < a.B; ++b) s.aprefix[b + 1] += s.aprefix[b];
  }
  csync();
  const int items = s.aprefix[a.B] * KV;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = 0;
    while (s.aprefix[b + 1] * KV <= it) ++b;
    const int ns = s.aprefix[b + 1] - s.aprefix[b];
    const int g = (it - s.aprefix[b] * KV) / ns, sp = (it - s.aprefix[b] * KV) % ns;
    const int p0 = __ldg(a.pos + b);
    const int nb = min((p0 + a.W - 1) / a.bs + 1, a.M);
    // fp pools: split sp holds blocks [16 sp, 16 sp + 16) (anchored at
    // block 0): a key falls in the same split, and in the same warp's
    // chunk of it, whatever the window's width, so a verify window's
    // query rounds as the decode tick's (the window's extra blocks only
    // add keys masked for the earlier queries, which change no bit).
    // int8 pools: counted from the last block, so that one split holds
    // every block the window's inserts requantize
    const int bhi = kQ ? nb - sp * kSplitBlocks
                       : min(nb, (sp + 1) * kSplitBlocks);
    const int blo = kQ ? max(0, bhi - kSplitBlocks) : sp * kSplitBlocks;
    const unsigned t_item = ttime(a);
    if (kQ && sp == 0) {
      // this item alone touches the window's blocks of head g of row b:
      // insert the window's tokens in order, then attend (the barrier: the
      // previous item's merge may still read the shared memory the insert
      // reuses)
      csync();
      for (int w = 0; w < a.W; ++w) {
        const int pj = p0 + w;
        if (pj / a.bs >= a.M) continue;
        const int bid = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
        if (bid == 0) continue;          // scratch: see the design note
        const size_t tr = (size_t)(b * a.W + w) * key_stride + (size_t)g * D;
        for (int kv = 0; kv < 2; ++kv)     // K, then V
          insert_token_q(reinterpret_cast<int8_t*>(a.pools[4 * l + 2 * kv]),
                         reinterpret_cast<float*>(a.pools[4 * l + 2 * kv + 1]),
                         (kv ? a.vtok : a.ktok) + tr, bid, pj % a.bs, g, a, s);
      }
    }
    const unsigned t_keys = ttime(a);
    if (threadIdx.x == 0) trace_add(a, l, 2, 7, t_keys - t_item);
    // this split's partials: (max, sum, output[128]) a query row
    float* part = a.apart +
                  ((((size_t)b * KV + g) * a.MS + sp) * Wr) * (D + 2);
    for (int rc = 0; rc < Wr; rc += kAttnRows) {
      const int nr = min(kAttnRows, Wr - rc);
      csync();
      for (int i = threadIdx.x; i < kAttnRows * D; i += kConsumers) {
        const int r = i / D, d = i % D;
        float v = 0.f;
        if (r < nr) {
          const int rr = rc + r, w = rr / rep, hh = g * rep + rr % rep;
          v = ldcg_bf(a.q + (size_t)(b * a.W + w) * hid + hh * D + d);
        }
        s.u.at.q[i] = v;
      }
      csync();
      float o[kAttnRows][4], mr[kAttnRows], lr[kAttnRows];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.f;
        mr[r] = kNegInf;
        lr[r] = 0.f;
      }
      // the split's keys, 32 a warp at a time: lane j takes key kc + j for
      // QK (over D in the lane, q broadcast from shared memory) and for the
      // softmax; PV then runs over D across the lanes, the keys in order,
      // each key's p broadcast from its lane
      const int k_lo = blo * a.bs, nkeys = (bhi - blo) * a.bs;
      for (int kc = warp * 32; kc < nkeys; kc += kWarps * 32) {
        const bool in = kc + lane < nkeys;
        const int key = k_lo + kc + lane;
        // a key past the split reads scratch block 0 and is masked
        const int bid = in ? __ldg(a.tables + (size_t)b * a.M + key / a.bs) : 0;
        float ksc = 1.f, vsc = 1.f;
        if (kQ) {
          ksc = __ldcg(kscl + (size_t)bid * KV + g);
          vsc = __ldcg(vscl + (size_t)bid * KV + g);
        }
        const ElemT* krow =
            kpool + ((size_t)bid * a.bs + key % a.bs) * key_stride + (size_t)g * D;
        float sr[kAttnRows];
#pragma unroll
        for (int r = 0; r < kAttnRows; ++r) sr[r] = 0.f;
#pragma unroll 4
        for (int d0 = 0; d0 < D; d0 += 8) {
          float kf[8];
          widen8<kQ>(__ldcg(reinterpret_cast<const typename Raw8<kQ>::T*>(krow + d0)),
                     ksc, tile, kf);
#pragma unroll
          for (int r = 0; r < kAttnRows; ++r) {
            if (r >= nr) break;
            const float4 qa = *reinterpret_cast<const float4*>(s.u.at.q + r * D + d0);
            const float4 qb = *reinterpret_cast<const float4*>(s.u.at.q + r * D + d0 + 4);
            float t = sr[r];
            t = fmaf(qa.x, kf[0], t);
            t = fmaf(qa.y, kf[1], t);
            t = fmaf(qa.z, kf[2], t);
            t = fmaf(qa.w, kf[3], t);
            t = fmaf(qb.x, kf[4], t);
            t = fmaf(qb.y, kf[5], t);
            t = fmaf(qb.z, kf[6], t);
            t = fmaf(qb.w, kf[7], t);
            sr[r] = t;
          }
        }
        // the online softmax of each row over the chunk; pv: p, with the
        // v-scale for int8 "scores" (the running sum takes p unscaled)
        float pv[kAttnRows];
#pragma unroll
        for (int r = 0; r < kAttnRows; ++r) {
          pv[r] = 0.f;
          if (r >= nr) break;
          const int qpos = p0 + (rc + r) / rep;
          float sv = sr[r];
          if (kQ && !tile) sv *= ksc;
          sv /= sqrt_d;
          const bool live = in && key <= qpos;
          sv = live ? sv : kNegInf;
          const float mn = fmaxf(mr[r], warp_max(sv));
          const float alpha = expf(mr[r] - mn);
          const float pj = live ? expf(sv - mn) : 0.f;
          lr[r] = lr[r] * alpha + warp_sum(pj);
          mr[r] = mn;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[r][e] *= alpha;
          pv[r] = kQ && !tile ? pj * vsc : pj;
        }
        const int nk = min(32, nkeys - kc);
        for (int j0 = 0; j0 < nk; j0 += 4) {
          RawT vr[4];                  // four keys' loads in flight
          float vs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = (j0 + j) & 31;
            const int bj = __shfl_sync(0xffffffffu, bid, kk);
            vs[j] = __shfl_sync(0xffffffffu, vsc, kk);
            const int kj = k_lo + kc + kk;
            vr[j] = __ldcg(reinterpret_cast<const RawT*>(
                vpool + ((size_t)bj * a.bs + kj % a.bs) * key_stride +
                (size_t)g * D + lane * 4));
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j0 + j >= nk) break;
            float vf[4];
            widen4<kQ>(vr[j], vs[j], tile, vf);
#pragma unroll
            for (int r = 0; r < kAttnRows; ++r) {
              if (r >= nr) break;
              const float pj = __shfl_sync(0xffffffffu, pv[r], j0 + j);
#pragma unroll
              for (int e = 0; e < 4; ++e) o[r][e] = fmaf(pj, vf[e], o[r][e]);
            }
          }
        }
      }
      // every warp's running state, merged in warp order
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        reinterpret_cast<float4*>(s.u.at.o + (warp * kAttnRows + r) * D)[lane] =
            make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
        if (lane == 0) {
          s.u.at.m[warp * kAttnRows + r] = mr[r];
          s.u.at.l[warp * kAttnRows + r] = lr[r];
        }
      }
      csync();
      for (int i = threadIdx.x; i < nr * D; i += kConsumers) {
        const int r = i / D, d = i % D;
        float mx = kNegInf;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s.u.at.m[w * kAttnRows + r]);
        float lsum = 0.f, osum = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(s.u.at.m[w * kAttnRows + r] - mx);
          lsum = fmaf(s.u.at.l[w * kAttnRows + r], f, lsum);
          osum = fmaf(s.u.at.o[(w * kAttnRows + r) * D + d], f, osum);
        }
        const int rr = rc + r, w = rr / rep, hh = g * rep + rr % rep;
        if (ns == 1) {
          a.ao[(size_t)(b * a.W + w) * hid + hh * D + d] =
              __float2bfloat16(osum / fmaxf(lsum, 1e-30f));
        } else {
          float* pr = part + (size_t)rr * (D + 2);
          pr[2 + d] = osum;
          if (d == 0) {
            pr[0] = mx;
            pr[1] = lsum;
          }
        }
      }
    }
    const unsigned t_merge = ttime(a);
    if (threadIdx.x == 0) trace_add(a, l, 2, 5, t_merge - t_keys);
    if (ns == 1) continue;
    // arrive; the last split of (b, g) merges the splits in order
    csync();
    if (threadIdx.x == 0) {
      unsigned* cnt = a.acnt + (size_t)b * KV + g;
      const int last = arrive_acq_rel(cnt) + 1 == (unsigned)ns;
      if (last) *cnt = 0;
      s.flag = last;
    }
    csync();
    if (!s.flag) continue;
    // the splits' (max, sum) of each query row into shared memory, then
    // every output element merged over the splits in order
    const float* base = a.apart + (((size_t)b * KV + g) * a.MS) * Wr * (D + 2);
    float* ml = reinterpret_cast<float*>(s.u.xs);   // (split, row) max, sum
    const int chunk = tp::kUnionBytes / 4 / (2 * ns);  // query rows at a time
    for (int r0 = 0; r0 < Wr; r0 += chunk) {
      const int nq = min(chunk, Wr - r0);
      for (int i = threadIdx.x; i < ns * nq; i += kConsumers) {
        const float* pr = base + ((size_t)(i / nq) * Wr + r0 + i % nq) * (D + 2);
        ml[2 * i] = __ldcg(pr);
        ml[2 * i + 1] = __ldcg(pr + 1);
      }
      csync();
      for (int i = threadIdx.x; i < nq * D; i += kConsumers) {
        const int rq = i / D, rr = r0 + rq, d = i % D;
        float mx = kNegInf;
        for (int k = 0; k < ns; ++k) mx = fmaxf(mx, ml[2 * (k * nq + rq)]);
        float lsum = 0.f, osum = 0.f;
        for (int k = 0; k < ns; ++k) {
          const float f = expf(ml[2 * (k * nq + rq)] - mx);
          lsum = fmaf(ml[2 * (k * nq + rq) + 1], f, lsum);
          osum = fmaf(__ldcg(base + ((size_t)k * Wr + rr) * (D + 2) + 2 + d), f,
                      osum);
        }
        const int w = rr / rep, hh = g * rep + rr % rep;
        a.ao[(size_t)(b * a.W + w) * hid + hh * D + d] =
            __float2bfloat16(osum / fmaxf(lsum, 1e-30f));
      }
      csync();
    }
    if (threadIdx.x == 0) trace_add(a, l, 2, 6, ttime(a) - t_merge);
  }
}

// ---------------------------------------------------------------- the tick
// The consumers' tick: each layer's phases in trace order (0 shrink q/k/v,
// 1 q/k/v, 2 attention, 3 shrink o, 4 o, 5 shrink gate/up, 6 gate/up, 7
// shrink down, 8 down; a shrink only where its targets are served), each
// ended by a grid barrier. One call site a phase function: the code is
// inlined once.
template <bool kQ, bool kLora>
__device__ void consumers(const Args& a, Smem& s) {
  const int hid = a.H * kHeadDim;
  RingPos rp;         // the ring position of the block's next unit
  int par = 0;        // the warpgroup that takes it
  int nbar = 0;       // grid barriers so far
  for (int l = 0; l < a.L; ++l) {
    for (int step = 0; step < kPhases; ++step) {
      // a shrink step's first target and target count (q/k/v, o, gate/up,
      // down), or a product phase
      const int t0 = step == 0 ? 0 : step == 3 ? 3 : step == 5 ? 4 : 6;
      const int nt = step == 0 ? 3 : step == 5 ? 2 : 1;
      const bool shrink = step == 0 || step == 3 || step == 5 || step == 7;
      if (shrink && !(kLora && any_served(a, t0, nt))) continue;
      stamp_entry(a, l, step);
      if (shrink) {
        const bf16* norm = step == 0 || step == 5
            ? reinterpret_cast<const bf16*>(a.wptrs[(step == 0 ? 7 : 8) * a.L + l])
            : nullptr;
        const XSrc x{step == 3 ? a.ao : step == 7 ? a.hbuf : a.xres, norm,
                     step == 7 ? a.I : hid};
        phase_shrink(a, l, t0, nt, x, s);
      } else if (step == 2) {
        phase_attention<kQ>(a, l, s);
      } else {
        const int ph = step == 1 ? tp::kQKV : step == 4 ? tp::kO
                       : step == 6 ? tp::kGateUp : tp::kDown;
        product_phase<kQ, kLora>(a, l, ph, s, rp, par);
      }
      grid_barrier(a, &nbar, l, step);
    }
  }
}

// One instantiation per pool format and LoRA on or off, so that each
// variant carries only its own code and register pressure.
template <bool kQ, bool kLora>
__global__ void __launch_bounds__(kThreads, 1) decode_tick_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&s.full[i]), 1);
      mbar_init(smem_addr(&s.empty[i]), 4);   // the consuming warpgroup's warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) producer(a, s);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  consumers<kQ, kLora>(a, s);
}

typedef void (*TickKernel)(Args);

TickKernel kernel_for(int quant, int lora) {
  return quant ? (lora ? decode_tick_kernel<true, true> : decode_tick_kernel<true, false>)
               : (lora ? decode_tick_kernel<false, true> : decode_tick_kernel<false, false>);
}

// the shared-memory attribute and the co-residency check, once per device
// and instantiation
cudaError_t prepare(TickKernel kernel, int which, int* sms) {
  static int state[64][4];   // 0 unchecked, 1 ready, else the error
  static int count[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (state[dev][which] == 0) {
    int coop = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tp::kSmemBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        tp::kSmemBytes);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
    state[dev][which] = e == cudaSuccess ? 1 : (int)e;
  }
  *sms = count[dev];
  return state[dev][which] == 1 ? cudaSuccess : (cudaError_t)state[dev][which];
}

// W (K, N) row-major bf16 as a map of 64 x 64 boxes in the 128-byte
// swizzle, as stream_gemm::weight_map encodes it, but promoting L2 fills
// to 128 bytes only: a box's rows are 128 bytes and the neighbouring
// column block of a row is streamed much later (or by another block)
bool tick_weight_map(CUtensorMap* out, const void* w, int K, int N) {
  flash_common::EncodeTiled fn = flash_common::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(N), cuuint64_t(K)};
  const cuuint64_t strides[1] = {cuuint64_t(N) * 2};
  const cuuint32_t box[2] = {64, tp::kKStep};
  const cuuint32_t elem[2] = {1, 1};
  return fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The tensor maps of a weight table, encoded once: for each layer l the
// seven projections' [K, N] bf16 weights (wptrs, a host array (9, L) of
// device addresses: wq wk wv wo wg wu wd ln1 ln2) as maps of 64 x 64 boxes
// in the 128-byte swizzle (tick_weight_map), copied to `out`, a 64-byte
// aligned device buffer of 7 L CUtensorMap (map w * L + l).
extern "C" int pt_decode_tick_maps(const void* wptrs, int L, int hid, int kvd,
                                   int I, void* out) {
  if (L <= 0 || wptrs == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 64)
    return (int)cudaErrorInvalidValue;
  const long long* w = static_cast<const long long*>(wptrs);
  const int K[7] = {hid, hid, hid, hid, hid, hid, I};
  const int N[7] = {hid, kvd, kvd, hid, I, I, hid};
  std::vector<CUtensorMap> maps(7 * (size_t)L);
  for (int t = 0; t < 7; ++t)
    for (int l = 0; l < L; ++l)
      if (!tick_weight_map(&maps[t * L + l],
                           reinterpret_cast<const void*>(w[t * L + l]), K[t],
                           N[t]))
        return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpy(out, maps.data(), maps.size() * sizeof(CUtensorMap),
                         cudaMemcpyHostToDevice);
}

// The plan's sizes for a tick of these shapes on the current device, into
// out[7]: partial-sum scratch floats (low, high 31 bits), group counters,
// SMs (the grid), the plan's shared memory, 1 when the plan takes the
// shapes, and the KV blocks of an attention split. The wrapper allocates
// the scratch and counters from these.
extern "C" int pt_decode_tick_plan(int hid, int KV, int I, int rows, int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const tp::Dims d{hid, KV, I, rows};
  const bool ok = tp::fits(d, sms);
  const long long f = ok ? tp::scratch_floats(d, sms) : 0;
  out[0] = (int)(f & 0x7fffffff);
  out[1] = (int)(f >> 31);
  out[2] = ok ? tp::max_groups(d) : 0;
  out[3] = sms;
  out[4] = tp::kSmemBytes;
  out[5] = ok ? 1 : 0;
  out[6] = kSplitBlocks;
  return 0;
}

// An instantiation's launch shape into out[8] (quant, lora: 0 or 1):
// threads a block, row tile of a full tick (64), K rows a stage, ring
// stages, dynamic shared memory bytes, registers a thread at launch, local
// (spill and stack) bytes a thread, the consumers' setmaxnreg count.
extern "C" int pt_decode_tick_config(int quant, int lora, int* out) {
  return flash_common::describe(kernel_for(quant, lora), kThreads, kMaxRows,
                                tp::kKStep, kStages, tp::kSmemBytes,
                                kConsumerRegs, out);
}

// One decode / verify tick over all L layers. Pointers: see Args; `lora_a`
// and `lora_b` are host arrays of the 7 targets' device pointers (null for a
// target not served; both null without LoRA); `part`, `gsync` and `apart`
// as pt_decode_tick_plan sizes them, `gsync` (1 + groups + B KV unsigned)
// zeroed; `trace` null or (L, 9, SMs, 5) int64. Shapes: head dim 128; hid =
// H * 128; I a multiple of 64; B * W <= 64; bs a multiple of 8 (at most 128
// for int8 pools); H a multiple of KV; LoRA rank R <= 16 and NS >=
// ceil(max(hid, I) / 512). The grid is one block per SM; the launch is
// refused when a block does not fit on an SM. Returns cudaGetLastError()
// after the launch, or the error that refused it.
extern "C" int pt_decode_tick(const void* maps, const void* wptrs,
                              const void* pools, const void* tables,
                              const void* pos, const void* cos_rows,
                              const void* sin_rows, void* xres, void* q,
                              void* ao, void* hbuf, void* ktok, void* vtok,
                              const void* lora_a, const void* lora_b,
                              const void* lscale, const void* laidx,
                              void* lpart, void* part, void* apart, void* gsync,
                              void* trace, int L, int B, int W, int H, int KV,
                              int D, int I, int bs, int M, int quant,
                              int dequant, int R, int NS, float eps,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long* la = static_cast<const long long*>(lora_a);
  const long long* lb = static_cast<const long long*>(lora_b);
  int n_lora = 0;
  for (int t = 0; t < kTargets; ++t) {
    if ((la[t] == 0) != (lb[t] == 0)) return (int)cudaErrorInvalidValue;
    n_lora += la[t] != 0;
  }
  const int maxk = (H * D > I ? H * D : I);
  if (D != kHeadDim || L <= 0 || B <= 0 || W <= 0 || B * W > kMaxRows ||
      KV <= 0 || H <= 0 || H % KV != 0 || bs <= 0 || bs % 8 != 0 || M <= 0 ||
      (quant != 0 && quant != 1) || (dequant != 0 && dequant != 1) ||
      maps == nullptr || part == nullptr || apart == nullptr ||
      gsync == nullptr ||
      (quant && (bs > kMaxBlock || ktok == nullptr || vtok == nullptr)) ||
      (n_lora && (R <= 0 || R > kMaxRank || NS < (maxk + kShrink - 1) / kShrink ||
                  lscale == nullptr || laidx == nullptr || lpart == nullptr)))
    return (int)cudaErrorInvalidValue;
  TickKernel kernel = kernel_for(quant, n_lora != 0);
  int sms = 0;
  cudaError_t e = prepare(kernel, 2 * quant + (n_lora != 0), &sms);
  if (e != cudaSuccess) return (int)e;
  const tp::Dims dims{H * D, KV, I, B * W};
  if (!tp::fits(dims, sms)) return (int)cudaErrorInvalidValue;
  Args a;
  a.maps = static_cast<const CUtensorMap*>(maps);
  a.wptrs = static_cast<const long long*>(wptrs);
  a.pools = static_cast<const long long*>(pools);
  a.tables = static_cast<const int*>(tables);
  a.pos = static_cast<const int*>(pos);
  a.cos_rows = static_cast<const float*>(cos_rows);
  a.sin_rows = static_cast<const float*>(sin_rows);
  a.xres = static_cast<bf16*>(xres);
  a.q = static_cast<bf16*>(q);
  a.ao = static_cast<bf16*>(ao);
  a.hbuf = static_cast<bf16*>(hbuf);
  a.ktok = static_cast<bf16*>(ktok);
  a.vtok = static_cast<bf16*>(vtok);
  for (int t = 0; t < kTargets; ++t) {
    a.la[t] = reinterpret_cast<const float*>(la[t]);
    a.lb[t] = reinterpret_cast<const float*>(lb[t]);
  }
  a.lscale = static_cast<const float*>(lscale);
  a.laidx = static_cast<const int*>(laidx);
  a.lpart = static_cast<float*>(lpart);
  a.part = static_cast<float*>(part);
  a.apart = static_cast<float*>(apart);
  a.gsync = static_cast<unsigned*>(gsync);
  a.acnt = a.gsync + 1 + tp::max_groups(dims);
  a.trace = static_cast<unsigned long long*>(trace);
  a.dims = dims;
  a.L = L; a.B = B; a.W = W; a.H = H; a.KV = KV; a.I = I; a.bs = bs; a.M = M;
  a.MS = (M + kSplitBlocks - 1) / kSplitBlocks;
  a.dequant = dequant; a.R = n_lora ? R : 0; a.NS = NS;
  a.eps = eps;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(sms), dim3(kThreads), params,
                                  tp::kSmemBytes, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
