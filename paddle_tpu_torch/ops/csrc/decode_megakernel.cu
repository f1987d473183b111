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
// a decode batch of 8 rows the products do 2 flops per weight element read,
// far below the ~295 flops per byte where the bf16 tensor-core rate would
// limit.
//
// Design. The TPU kernel is one program instance that streams each layer's
// weights HBM -> VMEM by hand. Here the grid is one block per SM, all
// co-resident, launched with cudaLaunchCooperativeKernel, and the tick is
// a sequence of phases separated by grid-wide barriers; each phase is a
// grid-stride loop over independent work items:
//   P1  q/k/v products. Every block recomputes the RMSNorm of the B*W rows
//       it needs from the bf16 residual (no barrier spent on the norm). A
//       q or k item is a quarter of one head: 16 columns of each half, so
//       the RoPE pairs (d, d + D/2) meet in the epilogue; roped q goes to a
//       scratch, roped k and v straight into the pool at
//       table[b, pos // bs], offset pos % bs.
//   P2  paged attention. An item is (row b, KV head g) with the rep query
//       heads of the group; the block's 8 warps split the row's
//       nb = min((pos + W - 1) // bs + 1, M) blocks and keep an online
//       softmax each, merged in a fixed order. No block past nb is read.
//   P3  o product + residual (the block owns its 32 columns of the residual).
//   P4  RMSNorm again, gate and up products, SiLU(g) * u into a scratch.
//   P5  down product + residual.
// Five barriers a layer. Products (GEMVs): weights are Paddle's [in, out],
// so a tile is 32 output columns; 4 threads span them with 16-byte loads
// along the row and 64 groups of 4 threads split K, four rows in flight per
// thread. The input rows are staged in shared memory as fp32 (4096 of K at a
// time, kept across the block's tiles when they share it). The 64 partial
// sums of each output are added in a fixed order through shared memory: no
// atomics, so a tick is deterministic. Each product's output is rounded to
// bf16 once, the residual is kept in bf16, the scores are divided by
// sqrt(D): the plain twin (decode_megakernel._tick_plain) rounds the same
// way. Data written during the tick is read with ld.global.cg (L2), never
// through the non-coherent read-only path. The kernel allocates nothing:
// the residual, q, the attention output and the SiLU product are scratch
// tensors of the wrapper.
//
// int8 pools (quant = 1; codes (N, bs, KV, D) int8, scales (N, KV) f32, four
// tensors a layer). A window token joins its block by whole-block
// requantization (the reference's _insert_token_q: dequantize the block-head,
// drop the token in, absmax, re-code), which needs the whole block-head
// while a P1 item holds a quarter of one head. So P1 writes the roped,
// bf16-rounded K and V rows to a scratch (B*W, KV*D), and the P2 item of
// (row b, KV head g) — the only item that touches head g of row b's blocks —
// inserts its W tokens in window order before it reads any block: no extra
// barrier. The block-head (bs x 128) is dequantized into shared memory in
// fp32, the per-head absmax reduced over the block, the scale
// max(amax, 1e-8) / 127 computed with IEEE division, and the codes rounded
// half to even (rintf, as torch.round) and clamped to +-127. A token bound
// for scratch block 0 (idle and prefilling rows) is not inserted: those
// rows would requantize block 0 concurrently; block 0 is never attended, so
// skipping keeps the kernel deterministic and leaves every live block as
// the reference writes it. Attention widens each lane's four codes in
// registers (exact) with the block's two scales beside them, in the mode's
// order: dequant = 0 ("scores") multiplies the fp32 QK sum by the k-scale
// before the division by sqrt(D) and p by the v-scale before PV, the
// running sum taking p unscaled; dequant = 1 ("tile") rounds code * scale
// to bf16 first, as the reference dequantizes its VMEM tile.
//
// LoRA (la[t] != nullptr for a served target t of q k v o gate up down):
// the adapter pool's pages are read in place, A (pages, L, in, R) and B
// (pages, L, R, out) f32, the row's page from laidx and its alpha/r from
// lscale; page 0 is the null adapter and its rows are skipped (their
// outputs are the fp kernel's, bit for bit). A delta has two steps. The
// shrink t = x @ A[page] needs a whole input row, so it gets a phase of
// its own before its products: items (row, target, 512-wide K slice)
// write fp32 partial sums to a scratch (B*W, 7, NS, R), then a barrier.
// The expand runs in the product's epilogue: for its 8 rows x 32 columns
// the block adds the slices in order, d = s * (t @ B[page]) in fp32, and
// out = bf16(bf16(base) + bf16(d)) — the JAX kernel's rounding (the fused
// LoRA kernel of the per-layer path rounds once instead). q/k/v deltas come
// before RoPE and the K/V write, the o delta reads the attention output,
// the down delta SiLU(g) * u. Four shrink phases a layer (before q/k/v, o,
// gate/up and down) add four barriers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 128;   // the one head dim the kernel is built for
constexpr int kRows = 8;        // rows of one product pass
constexpr int kTileN = 32;      // output columns of one product item
constexpr int kColGroups = kTileN / 8;            // 4 threads x 8 columns
constexpr int kKGroups = kThreads / kColGroups;   // 64 groups split K
constexpr int kUnroll = 4;                        // weight rows in flight
constexpr int kKStep = kKGroups * kUnroll;        // 256: K % kKStep == 0
constexpr int kChunk = 4096;    // K staged in shared memory at a time
constexpr int kMaxRows = 64;    // B * W
constexpr int kAttnRows = 8;    // query rows of one attention pass
constexpr int kTargets = 7;     // LoRA targets: q k v o gate up down
constexpr int kMaxRank = 16;    // largest LoRA rank staged
constexpr int kShrink = 512;    // K slice of one shrink item
constexpr int kRedFloats = kKGroups * kRows * kTileN;
constexpr int kMaxBlock = kRedFloats / kHeadDim;  // int8: bs <= 128
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Args {
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
  int L, B, W, H, KV, I, bs, M;
  int dequant, R, NS;        // int8: 0 "scores", 1 "tile"; LoRA rank, slices
  float eps;
};

struct Smem {
  float xs[kChunk * kRows];              // staged input rows [k][row]
  union {
    float red[kRedFloats];               // partial sums [kgroup][row][col];
                                         // int8: one dequantized block-head
    float lt[kRows * kMaxRank];          // LoRA: t = x @ A of the tile's rows
                                         // (once gemv_tile has read red)
    struct {
      float q[kAttnRows * kHeadDim];
      float m[kWarps * kAttnRows];
      float l[kWarps * kAttnRows];
      float o[kWarps * kAttnRows * kHeadDim];
    } at;
  } u;
  float out[kRows * kTileN];             // summed tile
  union {
    float gate[kRows * kTileN];          // gate tile of P4
    float wred[kWarps * kMaxRank];       // per-warp partials of a reduction
                                         // (LoRA shrink, int8 requantization)
  } gw;
  float inv[kMaxRows];                   // per-row 1/rms
};
// With the 1 KB an SM reserves per block, the block must fit the 196 KB
// shared-memory carve-out: the next one (228 KB) would leave L1, where the
// register spills live, 28 KB instead of 60.
static_assert(sizeof(Smem) + 1024 <= 196 * 1024, "Smem outgrew its carve-out");

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (in, out) dims of LoRA target t (q k v o gate up down).
__device__ __forceinline__ void lora_dims(const Args& a, int t, int& K, int& N) {
  const int hid = a.H * kHeadDim;
  K = t == 6 ? a.I : hid;
  N = t == 1 || t == 2 ? a.KV * kHeadDim : t == 4 || t == 5 ? a.I : hid;
}

// 1/rms of every row of the residual, into s.inv (block-wide).
__device__ void row_inv_rms(const Args& a, int rows, int hid, Smem& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const uint4* x = reinterpret_cast<const uint4*>(a.xres + (size_t)r * hid);
    float ss = 0.f;
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

// Input of one product: the normed residual (norm != nullptr) or a bf16
// activation (src).
struct XSrc {
  const bf16* src;
  const bf16* norm;   // norm weight (hid,) or nullptr
  int ld;             // row length of src
  int id;             // identity for the staging cache
};

// Element k of input row r, normed and rounded as stage() does.
__device__ __forceinline__ float x_at(const XSrc& x, int r, int k, const Smem& s) {
  const float f = ldcg_bf(x.src + (size_t)r * x.ld + k);
  if (x.norm == nullptr) return f;
  return bf(__fmul_rn(__fmul_rn(f, s.inv[r]), __bfloat162float(x.norm[k])));
}

// Stage rows [r0, r0 + 8) x K [k0, k0 + n) of the input as fp32 [k][row].
__device__ void stage(const XSrc& x, int rows, int r0, int k0, int n, Smem& s) {
  // neighbouring threads take neighbouring rows (4-way bank conflicts on
  // the [k][row] store instead of 32-way)
  for (int i = threadIdx.x; i < kRows * (n / 8); i += kThreads) {
    const int m = i % kRows, kk = (i / kRows) * 8;
    float f[8];
    if (r0 + m < rows) {
      const size_t off = (size_t)(r0 + m) * x.ld + k0 + kk;
      unpack8(__ldcg(reinterpret_cast<const uint4*>(x.src + off)), f);
      if (x.norm != nullptr) {
        float w[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x.norm + k0 + kk)), w);
        const float inv = s.inv[r0 + m];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = bf(__fmul_rn(__fmul_rn(f[j], inv), w[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s.xs[(kk + j) * kRows + m] = f[j];
  }
}

// One product tile: s.out[row][c] = sum_k x[r0 + row, k] * w[k, col(c)] for
// the 32 columns whose 8-wide groups start at cols[0..3], fp32, summed in a
// fixed order. `staged` caches which (input, rows, K chunk) s.xs holds.
__device__ void gemv_tile(const bf16* __restrict__ w, int N, int K,
                          const int* cols, const XSrc& x, int rows, int r0,
                          int& staged, Smem& s) {
  const int cgp = threadIdx.x % kColGroups, kg = threadIdx.x / kColGroups;
  const bf16* wc = w + cols[cgp];
  float acc[kRows][8];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    const int key = ((x.id * kMaxRows + r0) << 8) + k0 / kChunk;
    if (staged != key) {
      __syncthreads();   // every thread is done with the previous chunk
      stage(x, rows, r0, k0, n, s);
      staged = key;
    }
    __syncthreads();
    for (int kb = kg; kb < n; kb += kKStep) {
      uint4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wv[u] = __ldg(reinterpret_cast<const uint4*>(
            wc + (size_t)(k0 + kb + u * kKGroups) * N));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float wf[8];
        unpack8(wv[u], wf);
        const float4* xp =
            reinterpret_cast<const float4*>(s.xs + (kb + u * kKGroups) * kRows);
        const float4 xa = xp[0], xb = xp[1];
        const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s.u.red[(kg * kRows + m) * kTileN + cgp * 8 + j] = acc[m][j];
  __syncthreads();
  {
    const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN;
    float t = 0.f;
    for (int g = 0; g < kKGroups; ++g) t += s.u.red[(g * kRows + m) * kTileN + c];
    s.out[m * kTileN + c] = t;
  }
  __syncthreads();
}

// ------------------------------------------------------------ LoRA
// True when one of the LoRA targets t0 .. t0 + nt - 1 is served.
__device__ __forceinline__ bool any_served(const Args& a, int t0, int nt) {
  for (int t = t0; t < t0 + nt; ++t)
    if (a.la[t] != nullptr) return true;
  return false;
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
    __syncthreads();
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
    for (int k = sp * kShrink + threadIdx.x; k < k1; k += kThreads) {
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
      if (lane == 0) s.gw.wred[warp * kMaxRank + j] = v;
    }
    __syncthreads();
    if (threadIdx.x < R) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += s.gw.wred[w * kMaxRank + threadIdx.x];
      a.lpart[(((size_t)r * kTargets + t) * a.NS + sp) * R + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// Expand epilogue of LoRA target t on a product tile (rows r0.., the 32
// columns of `cols` of an N-wide output): for rows on a page other than 0,
// s.out = bf16(bf16(base) + bf16(scale * (t @ B_t[page, l]))), t being the
// sum of the row's shrink slices in order. Rows on page 0 keep s.out.
__device__ void lora_expand(const Args& a, int l, int t, const int* cols,
                            int rows, int r0, Smem& s) {
  if (a.la[t] == nullptr) return;
  int K, N;
  lora_dims(a, t, K, N);
  const int ns = (K + kShrink - 1) / kShrink, R = a.R;
  if (threadIdx.x < kRows * kMaxRank) {
    const int m = threadIdx.x / kMaxRank, j = threadIdx.x % kMaxRank, r = r0 + m;
    float v = 0.f;
    if (r < rows && j < R && __ldg(a.laidx + r / a.W) != 0) {
      const float* p = a.lpart + (((size_t)r * kTargets + t) * a.NS) * R + j;
      for (int sp = 0; sp < ns; ++sp) v += __ldcg(p + (size_t)sp * R);
    }
    s.u.lt[threadIdx.x] = v;
  }
  __syncthreads();
  const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN, r = r0 + m;
  if (r < rows) {
    const int page = __ldg(a.laidx + r / a.W);
    if (page != 0) {
      const int cg = c >> 3;
      const int col = (cg == 0 ? cols[0] : cg == 1 ? cols[1]
                       : cg == 2 ? cols[2] : cols[3]) + (c & 7);
      const float* bp = a.lb[t] + ((size_t)page * a.L + l) * R * N + col;
      float d = 0.f;
      for (int j = 0; j < R; ++j) d = fmaf(s.u.lt[m * kMaxRank + j], __ldg(bp + (size_t)j * N), d);
      d *= __ldg(a.lscale + page);
      s.out[m * kTileN + c] = bf(bf(s.out[m * kTileN + c]) + bf(d));
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- phase 1
template <bool kQ, bool kLora>
__device__ void phase_qkv(const Args& a, int l, Smem& s, int& staged) {
  const int D = kHeadDim, H = a.H, KV = a.KV, hid = H * D;
  const int rows = a.B * a.W;
  const bf16* ln1 = reinterpret_cast<const bf16*>(a.wptrs[7 * a.L + l]);
  const bf16* wq = reinterpret_cast<const bf16*>(a.wptrs[0 * a.L + l]);
  const bf16* wk = reinterpret_cast<const bf16*>(a.wptrs[1 * a.L + l]);
  const bf16* wv = reinterpret_cast<const bf16*>(a.wptrs[2 * a.L + l]);
  const int st = kQ ? 4 : 2;
  bf16* kpool = reinterpret_cast<bf16*>(a.pools[st * l]);
  bf16* vpool = reinterpret_cast<bf16*>(a.pools[st * l + st / 2]);
  row_inv_rms(a, rows, hid, s);
  __syncthreads();
  const XSrc x{a.xres, ln1, hid, 1};
  const int quarters = D / 2 / 16;                  // 4 rope items a head
  const int n_q = H * quarters, n_k = KV * quarters, n_v = KV * D / kTileN;
  for (int it = blockIdx.x; it < n_q + n_k + n_v; it += gridDim.x) {
    const bf16* w;
    int N, cols[kColGroups], head = 0, d0 = 0, kind;
    if (it < n_q + n_k) {                           // q or k: rope quarter
      kind = it < n_q ? 0 : 1;
      const int j = kind == 0 ? it : it - n_q;
      head = j / quarters;
      d0 = (j % quarters) * 16;
      w = kind == 0 ? wq : wk;
      N = (kind == 0 ? H : KV) * D;
      const int base = head * D + d0;
      cols[0] = base; cols[1] = base + 8;
      cols[2] = base + D / 2; cols[3] = base + D / 2 + 8;
    } else {                                        // v: 32 plain columns
      kind = 2;
      w = wv;
      N = KV * D;
      const int c0 = (it - n_q - n_k) * kTileN;
      for (int c = 0; c < kColGroups; ++c) cols[c] = c0 + 8 * c;
    }
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      gemv_tile(w, N, hid, cols, x, rows, r0, staged, s);
      if (kLora) lora_expand(a, l, kind, cols, rows, r0, s);  // q, k, v
      const int t = threadIdx.x;
      if (kind < 2) {
        // 8 rows x 16 rope pairs: 128 threads
        if (t < kRows * 16) {
          const int m = t / 16, c = t % 16, r = r0 + m;
          if (r < rows) {
            const float x1 = bf(s.out[m * kTileN + c]);
            const float x2 = bf(s.out[m * kTileN + 16 + c]);
            const int d = d0 + c;
            const float cs = __ldg(a.cos_rows + (size_t)r * (D / 2) + d);
            const float sn = __ldg(a.sin_rows + (size_t)r * (D / 2) + d);
            const bf16 o1 = __float2bfloat16(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
            const bf16 o2 = __float2bfloat16(__fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)));
            if (kind == 0) {
              bf16* qr = a.q + (size_t)r * hid + head * D;
              qr[d] = o1;
              qr[d + D / 2] = o2;
            } else if (kQ) {                        // to the token scratch
              bf16* kr = a.ktok + (size_t)r * KV * D + head * D;
              kr[d] = o1;
              kr[d + D / 2] = o2;
            } else {
              const int b = r / a.W, pj = __ldg(a.pos + b) + r % a.W;
              if (pj / a.bs < a.M) {
                const int blk = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
                bf16* kr = kpool + (((size_t)blk * a.bs + pj % a.bs) * KV + head) * D;
                kr[d] = o1;
                kr[d + D / 2] = o2;
              }
            }
          }
        }
      } else {
        const int m = t / kTileN, c = t % kTileN, r = r0 + m;
        if (r < rows) {
          const bf16 v = __float2bfloat16(s.out[m * kTileN + c]);
          if (kQ) {
            a.vtok[(size_t)r * KV * D + cols[0] + c] = v;
          } else {
            const int b = r / a.W, pj = __ldg(a.pos + b) + r % a.W;
            if (pj / a.bs < a.M) {
              const int blk = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
              vpool[((size_t)blk * a.bs + pj % a.bs) * KV * D + cols[0] + c] = v;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- phase 2
// int8: insert one token (head g's 128 values at `tok`) at slot `off` of
// block `bid`, requantizing the block-head in place (block-wide).
__device__ void insert_token_q(int8_t* codes, float* scales, const bf16* tok,
                               int bid, int off, int g, const Args& a, Smem& s) {
  const int D = kHeadDim, n = a.bs * D;
  const size_t row = (size_t)a.KV * D;
  int8_t* base = codes + (size_t)bid * a.bs * row + (size_t)g * D;
  const float sc = __ldcg(scales + (size_t)bid * a.KV + g);
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = i / D, d = i % D;
    const float v = j == off ? ldcg_bf(tok + d)
                             : __fmul_rn((float)__ldcg(base + j * row + d), sc);
    s.u.red[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) s.gw.wred[threadIdx.x >> 5] = amax;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s.gw.wred[w]);
  const float ns = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float qv = fminf(fmaxf(rintf(__fdiv_rn(s.u.red[i], ns)), -127.f), 127.f);
    base[(i / D) * row + i % D] = (int8_t)qv;
  }
  if (threadIdx.x == 0) scales[(size_t)bid * a.KV + g] = ns;
  __syncthreads();
}

// One lane's four K (or V) elements of one key as loaded: four bf16 (fp
// pool) or four int8 codes.
template <bool kQ> struct Raw4 { typedef uint2 T; typedef bf16 E; };
template <> struct Raw4<true> { typedef unsigned T; typedef int8_t E; };

// Widen them to fp32: exact, or for dequant "tile" the rounded code * scale.
template <bool kQ, bool kTile>
__device__ __forceinline__ void widen4(const typename Raw4<kQ>::T& u, float sc,
                                       float* f) {
  if constexpr (kQ) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = (float)(int8_t)(u >> (8 * e));
      f[e] = kTile ? bf(__fmul_rn(c, sc)) : c;
    }
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(e[j]);
  }
}

template <bool kQ, bool kTile>
__device__ void phase_attention(const Args& a, int l, Smem& s) {
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
  for (int it = blockIdx.x; it < a.B * KV; it += gridDim.x) {
    const int b = it / KV, g = it % KV;
    const int p0 = __ldg(a.pos + b);
    const int nb = min((p0 + a.W - 1) / a.bs + 1, a.M);
    if (kQ) {
      // this item alone touches head g of row b's blocks: insert the
      // window's tokens in order, then attend (the barrier: the previous
      // item's merge may still read the shared memory the insert reuses)
      __syncthreads();
      for (int w = 0; w < a.W; ++w) {
        const int pj = p0 + w;
        if (pj / a.bs >= a.M) continue;
        const int bid = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
        if (bid == 0) continue;          // scratch: see the design note
        const size_t tr = (size_t)(b * a.W + w) * key_stride + (size_t)g * D;
        insert_token_q(reinterpret_cast<int8_t*>(a.pools[4 * l]),
                       reinterpret_cast<float*>(a.pools[4 * l + 1]),
                       a.ktok + tr, bid, pj % a.bs, g, a, s);
        insert_token_q(reinterpret_cast<int8_t*>(a.pools[4 * l + 2]),
                       reinterpret_cast<float*>(a.pools[4 * l + 3]),
                       a.vtok + tr, bid, pj % a.bs, g, a, s);
      }
    }
    for (int rc = 0; rc < Wr; rc += kAttnRows) {
      const int nr = min(kAttnRows, Wr - rc);
      __syncthreads();
      for (int i = threadIdx.x; i < kAttnRows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float v = 0.f;
        if (r < nr) {
          const int rr = rc + r, w = rr / rep, hh = g * rep + rr % rep;
          v = ldcg_bf(a.q + (size_t)(b * a.W + w) * hid + hh * D + d);
        }
        s.u.at.q[i] = v;
      }
      __syncthreads();
      float qv[kAttnRows][4], o[kAttnRows][4], mr[kAttnRows], lr[kAttnRows];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        const float4 t = reinterpret_cast<const float4*>(s.u.at.q + r * D)[lane];
        qv[r][0] = t.x; qv[r][1] = t.y; qv[r][2] = t.z; qv[r][3] = t.w;
        o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.f;
        mr[r] = kNegInf;
        lr[r] = 0.f;
      }
      for (int blk = warp; blk < nb; blk += kWarps) {
        const int bid = __ldg(a.tables + (size_t)b * a.M + blk);
        const size_t off = (size_t)bid * a.bs * key_stride + g * D + lane * 4;
        const ElemT* kb = kpool + off;
        const ElemT* vb = vpool + off;
        // int8: the block-head's scales (dequant "scores": the k-scale on
        // the QK sum, the v-scale on p)
        float ksc = 1.f, vsc = 1.f;
        if (kQ) {
          ksc = __ldcg(kscl + (size_t)bid * KV + g);
          vsc = __ldcg(vscl + (size_t)bid * KV + g);
        }
        for (int j0 = 0; j0 < a.bs; j0 += 8) {
          RawT kr[8], vr[8];           // every load in flight before use
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kr[j] = __ldcg(reinterpret_cast<const RawT*>(kb + (j0 + j) * key_stride));
            vr[j] = __ldcg(reinterpret_cast<const RawT*>(vb + (j0 + j) * key_stride));
          }
          float kf[8][4], vf[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            widen4<kQ, kTile>(kr[j], ksc, kf[j]);
            widen4<kQ, kTile>(vr[j], vsc, vf[j]);
          }
          const int key0 = blk * a.bs + j0;
#pragma unroll
          for (int r = 0; r < kAttnRows; ++r) {
            if (r >= nr) break;
            const int qpos = p0 + (rc + r) / rep;
            float sc[8];
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float part = qv[r][0] * kf[j][0];
              part = fmaf(qv[r][1], kf[j][1], part);
              part = fmaf(qv[r][2], kf[j][2], part);
              part = fmaf(qv[r][3], kf[j][3], part);
              float sv = warp_sum(part);
              if (kQ && !kTile) sv *= ksc;
              sv /= sqrt_d;
              sc[j] = key0 + j <= qpos ? sv : kNegInf;
              mx = fmaxf(mx, sc[j]);
            }
            const float mn = fmaxf(mr[r], mx);
            const float alpha = expf(mr[r] - mn);
            float psum = 0.f;
            float acc[4] = {o[r][0] * alpha, o[r][1] * alpha, o[r][2] * alpha,
                            o[r][3] * alpha};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float p = key0 + j <= qpos ? expf(sc[j] - mn) : 0.f;
              psum += p;
              const float pv = kQ && !kTile ? p * vsc : p;
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[e] = fmaf(pv, vf[j][e], acc[e]);
            }
            lr[r] = lr[r] * alpha + psum;
            mr[r] = mn;
#pragma unroll
            for (int e = 0; e < 4; ++e) o[r][e] = acc[e];
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
      __syncthreads();
      for (int i = threadIdx.x; i < nr * D; i += kThreads) {
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
        a.ao[(size_t)(b * a.W + w) * hid + hh * D + d] =
            __float2bfloat16(osum / fmaxf(lsum, 1e-30f));
      }
    }
  }
}

// ------------------------------------------------------- phases 3 and 5
// out-product + residual: xres[:, cols] = bf16(xres + bf16(x @ w)), with
// LoRA target lt's delta (3: o, 6: down) added to the product first.
template <bool kLora>
__device__ void phase_residual(const Args& a, int l, const bf16* w, int lt,
                               const XSrc& x, int K, Smem& s, int& staged) {
  const int hid = a.H * kHeadDim, rows = a.B * a.W;
  for (int it = blockIdx.x; it < hid / kTileN; it += gridDim.x) {
    int cols[kColGroups];
    for (int c = 0; c < kColGroups; ++c) cols[c] = it * kTileN + 8 * c;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      gemv_tile(w, hid, K, cols, x, rows, r0, staged, s);
      if (kLora) lora_expand(a, l, lt, cols, rows, r0, s);
      const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN, r = r0 + m;
      if (r < rows) {
        bf16* xp = a.xres + (size_t)r * hid + it * kTileN + c;
        *xp = __float2bfloat16(ldcg_bf(xp) + bf(s.out[m * kTileN + c]));
      }
    }
  }
}

// ---------------------------------------------------------------- phase 4
template <bool kLora>
__device__ void phase_gate_up(const Args& a, int l, Smem& s, int& staged) {
  const int hid = a.H * kHeadDim, rows = a.B * a.W, I = a.I;
  const bf16* ln2 = reinterpret_cast<const bf16*>(a.wptrs[8 * a.L + l]);
  const bf16* wg = reinterpret_cast<const bf16*>(a.wptrs[4 * a.L + l]);
  const bf16* wu = reinterpret_cast<const bf16*>(a.wptrs[5 * a.L + l]);
  row_inv_rms(a, rows, hid, s);
  __syncthreads();
  const XSrc x{a.xres, ln2, hid, 3};
  for (int it = blockIdx.x; it < I / kTileN; it += gridDim.x) {
    int cols[kColGroups];
    for (int c = 0; c < kColGroups; ++c) cols[c] = it * kTileN + 8 * c;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      gemv_tile(wg, I, hid, cols, x, rows, r0, staged, s);
      if (kLora) lora_expand(a, l, 4, cols, rows, r0, s);
      s.gw.gate[threadIdx.x] = bf(s.out[threadIdx.x]);
      gemv_tile(wu, I, hid, cols, x, rows, r0, staged, s);
      if (kLora) lora_expand(a, l, 5, cols, rows, r0, s);
      const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN, r = r0 + m;
      if (r < rows) {
        const float g = s.gw.gate[threadIdx.x];
        const float u = bf(s.out[threadIdx.x]);
        const float silu = bf(g / (1.0f + expf(-g)));
        a.hbuf[(size_t)r * I + it * kTileN + c] = __float2bfloat16(silu * u);
      }
    }
  }
}

// One instantiation per pool format and LoRA on or off, so that each
// variant carries only its own code and register pressure (the fp tick
// without LoRA compiles to the same code as before the variants).
template <bool kQ, bool kLora>
__global__ void __launch_bounds__(kThreads, 1) decode_tick_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int hid = a.H * kHeadDim;
  // the shrink phases: q/k/v, o, gate/up, down (each one input, one K)
  const bool s_qkv = kLora && any_served(a, 0, 3);
  const bool s_o = kLora && any_served(a, 3, 1);
  const bool s_gu = kLora && any_served(a, 4, 2);
  const bool s_d = kLora && any_served(a, 6, 1);
  int staged = -1;
  for (int l = 0; l < a.L; ++l) {
    if (s_qkv) {
      phase_shrink(a, l, 0, 3, XSrc{a.xres, reinterpret_cast<const bf16*>(
                                        a.wptrs[7 * a.L + l]), hid, 0}, s);
      grid.sync();
    }
    staged = -1;               // the residual changed since the last stage
    phase_qkv<kQ, kLora>(a, l, s, staged);
    grid.sync();               // this tick's K/V and q are visible
    if constexpr (!kQ) phase_attention<false, false>(a, l, s);
    else if (a.dequant == 0) phase_attention<true, false>(a, l, s);
    else phase_attention<true, true>(a, l, s);
    grid.sync();
    if (s_o) {
      phase_shrink(a, l, 3, 1, XSrc{a.ao, nullptr, hid, 0}, s);
      grid.sync();
    }
    staged = -1;
    phase_residual<kLora>(a, l, reinterpret_cast<const bf16*>(
                              a.wptrs[3 * a.L + l]), 3,
                          XSrc{a.ao, nullptr, hid, 2}, hid, s, staged);
    grid.sync();
    if (s_gu) {
      phase_shrink(a, l, 4, 2, XSrc{a.xres, reinterpret_cast<const bf16*>(
                                        a.wptrs[8 * a.L + l]), hid, 0}, s);
      grid.sync();
    }
    staged = -1;
    phase_gate_up<kLora>(a, l, s, staged);
    grid.sync();
    if (s_d) {
      phase_shrink(a, l, 6, 1, XSrc{a.hbuf, nullptr, a.I, 0}, s);
      grid.sync();
    }
    staged = -1;
    phase_residual<kLora>(a, l, reinterpret_cast<const bf16*>(
                              a.wptrs[6 * a.L + l]), 6,
                          XSrc{a.hbuf, nullptr, a.I, 4}, a.I, s, staged);
    grid.sync();
  }
}

}  // namespace

// One decode / verify tick over all L layers. Pointers: see Args; `lora_a`
// and `lora_b` are host arrays of the 7 targets' device pointers (null for a
// target not served; both null without LoRA). Shapes: head dim 128; hid =
// H * 128 and I multiples of 256; B * W <= 64; bs a multiple of 8 (at most
// 128 for int8 pools); H a multiple of KV; LoRA rank R <= 16 and NS >=
// ceil(max(hid, I) / 512). The grid is one block per SM; the launch is
// refused when a block does not fit on an SM. Returns cudaGetLastError()
// after the launch, or the error that refused it.
extern "C" int pt_decode_tick(const void* wptrs, const void* pools,
                              const void* tables, const void* pos,
                              const void* cos_rows, const void* sin_rows,
                              void* xres, void* q, void* ao, void* hbuf,
                              void* ktok, void* vtok, const void* lora_a,
                              const void* lora_b, const void* lscale,
                              const void* laidx, void* lpart, int L, int B,
                              int W, int H, int KV, int D, int I, int bs,
                              int M, int quant, int dequant, int R, int NS,
                              float eps, void* stream) {
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
      KV <= 0 || H % KV != 0 || (H * D) % kKStep != 0 || I % kKStep != 0 ||
      bs <= 0 || bs % 8 != 0 || M <= 0 || (quant != 0 && quant != 1) ||
      (dequant != 0 && dequant != 1) ||
      (quant && (bs > kMaxBlock || ktok == nullptr || vtok == nullptr)) ||
      (n_lora && (R <= 0 || R > kMaxRank || NS < (maxk + kShrink - 1) / kShrink ||
                  lscale == nullptr || laidx == nullptr || lpart == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  void (*kernel)(Args) = quant ? (n_lora ? decode_tick_kernel<true, true>
                                         : decode_tick_kernel<true, false>)
                                 : (n_lora ? decode_tick_kernel<false, true>
                                         : decode_tick_kernel<false, false>);
  const size_t smem = sizeof(Smem);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms;   // one block per SM: all co-resident
  Args a;
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
  a.L = L; a.B = B; a.W = W; a.H = H; a.KV = KV; a.I = I; a.bs = bs; a.M = M;
  a.dequant = dequant; a.R = n_lora ? R : 0; a.NS = NS;
  a.eps = eps;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
