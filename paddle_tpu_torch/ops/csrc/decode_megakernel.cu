// Whole-tick decode megakernel for Hopper (sm_90a): every decoder layer of
// one decode (W = 1) or verify (W > 1) tick in ONE persistent cooperative
// launch.
//
// Replaces: paddle_tpu/ops/decode_megakernel.py, `_tick_kernel` (launched by
// `decode_tick`, the `pallas_call` at :845), fp KV pools without LoRA. Per
// layer: RMSNorm, q/k/v products, RoPE, the window's K/V written through the
// block table, paged attention (online softmax, the in-window causal mask),
// o product + residual, RMSNorm, SiLU(g) * u, down product + residual.
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
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Args {
  const long long* wptrs;    // (9, L): wq wk wv wo wg wu wd ln1 ln2
  const long long* pools;    // (2 L): k0 v0 k1 v1 ...
  const int* tables;         // (B, M)
  const int* pos;            // (B,)
  const float* cos_rows;     // (B*W, D/2)
  const float* sin_rows;
  bf16* xres;                // (B*W, hid) in: embedded rows; out: residual
  bf16* q;                   // (B*W, H*D) scratch
  bf16* ao;                  // (B*W, H*D) scratch
  bf16* hbuf;                // (B*W, I) scratch
  int L, B, W, H, KV, I, bs, M;
  float eps;
};

struct Smem {
  float xs[kChunk * kRows];              // staged input rows [k][row]
  union {
    float red[kKGroups * kRows * kTileN];  // partial sums [kgroup][row][col]
    struct {
      float q[kAttnRows * kHeadDim];
      float m[kWarps * kAttnRows];
      float l[kWarps * kAttnRows];
      float o[kWarps * kAttnRows * kHeadDim];
    } at;
  } u;
  float out[kRows * kTileN];             // summed tile
  float gate[kRows * kTileN];            // gate tile of P4
  float inv[kMaxRows];                   // per-row 1/rms
};

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

// ---------------------------------------------------------------- phase 1
__device__ void phase_qkv(const Args& a, int l, Smem& s, int& staged) {
  const int D = kHeadDim, H = a.H, KV = a.KV, hid = H * D;
  const int rows = a.B * a.W;
  const bf16* ln1 = reinterpret_cast<const bf16*>(a.wptrs[7 * a.L + l]);
  const bf16* wq = reinterpret_cast<const bf16*>(a.wptrs[0 * a.L + l]);
  const bf16* wk = reinterpret_cast<const bf16*>(a.wptrs[1 * a.L + l]);
  const bf16* wv = reinterpret_cast<const bf16*>(a.wptrs[2 * a.L + l]);
  bf16* kpool = reinterpret_cast<bf16*>(a.pools[2 * l]);
  bf16* vpool = reinterpret_cast<bf16*>(a.pools[2 * l + 1]);
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
          const int b = r / a.W, pj = __ldg(a.pos + b) + r % a.W;
          if (pj / a.bs < a.M) {
            const int blk = __ldg(a.tables + (size_t)b * a.M + pj / a.bs);
            vpool[((size_t)blk * a.bs + pj % a.bs) * KV * D + cols[0] + c] =
                __float2bfloat16(s.out[m * kTileN + c]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- phase 2
__device__ void phase_attention(const Args& a, int l, Smem& s) {
  const int D = kHeadDim, H = a.H, KV = a.KV, hid = H * D;
  const int rep = H / KV, Wr = a.W * rep;
  const bf16* kpool = reinterpret_cast<const bf16*>(a.pools[2 * l]);
  const bf16* vpool = reinterpret_cast<const bf16*>(a.pools[2 * l + 1]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sqrt_d = sqrtf((float)D);
  const size_t key_stride = (size_t)KV * D;
  for (int it = blockIdx.x; it < a.B * KV; it += gridDim.x) {
    const int b = it / KV, g = it % KV;
    const int p0 = __ldg(a.pos + b);
    const int nb = min((p0 + a.W - 1) / a.bs + 1, a.M);
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
        const bf16* kb = kpool + (size_t)bid * a.bs * key_stride + g * D + lane * 4;
        const bf16* vb = vpool + (size_t)bid * a.bs * key_stride + g * D + lane * 4;
        for (int j0 = 0; j0 < a.bs; j0 += 8) {
          uint2 kr[8], vr[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kr[j] = __ldcg(reinterpret_cast<const uint2*>(kb + (j0 + j) * key_stride));
            vr[j] = __ldcg(reinterpret_cast<const uint2*>(vb + (j0 + j) * key_stride));
          }
          float kf[8][4], vf[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bf16* ke = reinterpret_cast<const bf16*>(&kr[j]);
            const bf16* ve = reinterpret_cast<const bf16*>(&vr[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              kf[j][e] = __bfloat162float(ke[e]);
              vf[j][e] = __bfloat162float(ve[e]);
            }
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
              const float sv = warp_sum(part) / sqrt_d;
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
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, vf[j][e], acc[e]);
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
// out-product + residual: xres[:, cols] = bf16(xres + bf16(x @ w)).
__device__ void phase_residual(const Args& a, const bf16* w, const XSrc& x,
                               int K, Smem& s, int& staged) {
  const int hid = a.H * kHeadDim, rows = a.B * a.W;
  for (int it = blockIdx.x; it < hid / kTileN; it += gridDim.x) {
    int cols[kColGroups];
    for (int c = 0; c < kColGroups; ++c) cols[c] = it * kTileN + 8 * c;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      gemv_tile(w, hid, K, cols, x, rows, r0, staged, s);
      const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN, r = r0 + m;
      if (r < rows) {
        bf16* xp = a.xres + (size_t)r * hid + it * kTileN + c;
        *xp = __float2bfloat16(ldcg_bf(xp) + bf(s.out[m * kTileN + c]));
      }
    }
  }
}

// ---------------------------------------------------------------- phase 4
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
      s.gate[threadIdx.x] = bf(s.out[threadIdx.x]);
      gemv_tile(wu, I, hid, cols, x, rows, r0, staged, s);
      const int m = threadIdx.x / kTileN, c = threadIdx.x % kTileN, r = r0 + m;
      if (r < rows) {
        const float g = s.gate[threadIdx.x];
        const float u = bf(s.out[threadIdx.x]);
        const float silu = bf(g / (1.0f + expf(-g)));
        a.hbuf[(size_t)r * I + it * kTileN + c] = __float2bfloat16(silu * u);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) decode_tick_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int hid = a.H * kHeadDim;
  int staged = -1;
  for (int l = 0; l < a.L; ++l) {
    staged = -1;               // the residual changed since the last stage
    phase_qkv(a, l, s, staged);
    grid.sync();               // this tick's K/V and q are visible
    phase_attention(a, l, s);
    grid.sync();
    staged = -1;
    phase_residual(a, reinterpret_cast<const bf16*>(a.wptrs[3 * a.L + l]),
                   XSrc{a.ao, nullptr, hid, 2}, hid, s, staged);
    grid.sync();
    staged = -1;
    phase_gate_up(a, l, s, staged);
    grid.sync();
    staged = -1;
    phase_residual(a, reinterpret_cast<const bf16*>(a.wptrs[6 * a.L + l]),
                   XSrc{a.hbuf, nullptr, a.I, 4}, a.I, s, staged);
    grid.sync();
  }
}

}  // namespace

// One decode / verify tick over all L layers. Pointers: see Args. Shapes:
// head dim 128; hid = H * 128 and I multiples of 256; B * W <= 64; bs a
// multiple of 8; H a multiple of KV. The grid is one block per SM; the
// launch is refused when a block does not fit on an SM. Returns
// cudaGetLastError() after the launch, or the error that refused it.
extern "C" int pt_decode_tick(const void* wptrs, const void* pools,
                              const void* tables, const void* pos,
                              const void* cos_rows, const void* sin_rows,
                              void* xres, void* q, void* ao, void* hbuf, int L,
                              int B, int W, int H, int KV, int D, int I, int bs,
                              int M, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != kHeadDim || L <= 0 || B <= 0 || W <= 0 || B * W > kMaxRows ||
      KV <= 0 || H % KV != 0 || (H * D) % kKStep != 0 || I % kKStep != 0 ||
      bs <= 0 || bs % 8 != 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(Smem);
  e = cudaFuncSetAttribute(decode_tick_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_tick_kernel,
                                                    kThreads, smem);
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
  a.L = L; a.B = B; a.W = W; a.H = H; a.KV = KV; a.I = I; a.bs = bs; a.M = M;
  a.eps = eps;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_tick_kernel),
                                  dim3(grid), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
