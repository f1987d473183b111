// Paged GQA attention (decode, verify window and chunked prefill) over an fp
// or an int8 block pool, for Hopper (sm_90a).
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
// Bound: bytes. Decode reads every visible K/V row once and does 4 flops per
// element per query row of the group (rep = 4 for Llama-3-8B): about 4 flops
// per byte (8 for the int8 pool) against the card's ~295. A prefill chunk
// (C = 128 behind 384 earlier tokens, 512 rows per KV head) does ~220 flops
// per byte of q, out and K/V: still under the tensor-core line, but far above
// what this version's scalar fp32 arithmetic delivers, so at prefill it is
// bound by its own FMA issue rate for now.
//
// Design. The TPU walked the table on a sequential grid axis with the block
// ids as scalar prefetch; on Hopper blocks run in parallel, so:
//   * one thread block (4 warps) per (tile of R query rows, KV head g, batch
//     row b, context split s). R = 4 when a KV head has at most 4 rows
//     (decode), else 16. A block reads its own table entries.
//   * When (tiles x KV x B) would not fill the card (decode at B = 8 gives
//     64 blocks on 132 SMs), the wrapper splits the context into S parts
//     (flash-decoding): each block writes its unnormalised partial
//     (m, l, acc) to a workspace and a second kernel merges the S parts.
//   * Keys run in chunks of 64 (any block size): the chunk's K/V rows are
//     gathered through the table into shared memory with 16-byte loads
//     (K rows padded by 16 bytes so that lanes reading different keys hit
//     different banks); int8 rows are widened to bf16 on the way (exact),
//     and each key's k- and v-scale is staged beside them. Keys past the
//     tile's causal frontier are never read, which covers the tail entries
//     that point at scratch block 0: whatever scratch holds (even +-1e9, or
//     codes with a huge scale) never reaches an output.
//   * QK: each thread owns one key and R/2 rows (its own dot products, no
//     reduction across lanes); online softmax: one warp per row, one
//     update per 64-key chunk; PV: each lane owns D/32 output columns of 4
//     rows (at R = 4 the 4 warps split the keys and sum at the end).
// Left for later: cp.async/TMA double buffering of the K/V chunk, and
// tensor cores (mma/wgmma) for the prefill tile's QK and PV products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;          // keys per online-softmax step
constexpr float kNegBig = -1e30f;   // running-max start, as the TPU kernel

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

// N consecutive elements at p (aligned to their total size, 8 bytes or a
// multiple of 16) widened to fp32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[u];
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[u * kPer + j] = to_f(e[j]);
    }
  } else {
    static_assert(kBytes == 8, "unsupported row slice");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  }
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
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    o[2 * i] = *reinterpret_cast<uint32_t*>(&lo);
    o[2 * i + 1] = *reinterpret_cast<uint32_t*>(&hi);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Shared-memory layout of one block; every region is a multiple of 16 bytes.
template <typename T, int DPL, int R>
struct Layout {
  static constexpr int D = 32 * DPL;
  static constexpr int kVec = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int kKStride = D + kVec;         // padded K row
  static constexpr size_t k_bytes = size_t(kChunk) * kKStride * sizeof(T);
  static constexpr size_t v_bytes = size_t(kChunk) * D * sizeof(T);
  static constexpr size_t q_bytes = size_t(R) * D * sizeof(T);
  static constexpr size_t s_bytes = size_t(R) * kChunk * sizeof(float);
  static constexpr size_t off_bytes = size_t(kChunk) * sizeof(long long);
  static constexpr size_t row_bytes = 4 * size_t(R) * sizeof(float);
  static constexpr size_t sc_bytes = 2 * size_t(kChunk) * sizeof(float);
  static constexpr size_t total =
      k_bytes + v_bytes + q_bytes + s_bytes + off_bytes + row_bytes + sc_bytes;
  // the end-of-block reduction over warps (R = 4) reuses the K region
  static_assert(size_t(kWarps) * 4 * D * sizeof(float) <= k_bytes ||
                R != 4, "reduction buffer does not fit");
};

// PT: the pools' element type, T (fp pool) or int8_t (codes with scales)
template <typename T, typename PT, int DPL, int R>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const PT* __restrict__ k_pool,
                       const PT* __restrict__ v_pool,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, T* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int W, int H, int KV,
                       int bs, int M, int S, int P) {
  using L = Layout<T, DPL, R>;
  constexpr bool kQuant = !std::is_same<T, PT>::value;
  static_assert(!kQuant || std::is_same<PT, int8_t>::value, "pool type");
  constexpr int D = L::D;
  constexpr int kVec = L::kVec;
  constexpr int kVpr = D / kVec;                     // 16-byte vectors per row
  constexpr int kLoads = kChunk * kVpr / kThreads;   // per thread per chunk
  constexpr int kBatch = kLoads < 8 ? kLoads : 8;
  constexpr int kRpw = R / kWarps;                   // softmax rows per warp
  constexpr int kKSplit = 16 / R;                    // warps sharing PV rows
  static_assert(kLoads % kBatch == 0, "load batching");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::k_bytes);
  T* qs = reinterpret_cast<T*>(smem + L::k_bytes + L::v_bytes);
  float* ss = reinterpret_cast<float*>(smem + L::k_bytes + L::v_bytes +
                                       L::q_bytes);
  long long* koff = reinterpret_cast<long long*>(
      smem + L::k_bytes + L::v_bytes + L::q_bytes + L::s_bytes);
  float* alpha_s = reinterpret_cast<float*>(
      smem + L::k_bytes + L::v_bytes + L::q_bytes + L::s_bytes + L::off_bytes);
  float* m_s = alpha_s + R;
  float* l_s = m_s + R;
  float* ksc = l_s + 2 * R;     // per key of the chunk: k-scale, v-scale
  float* vsc = ksc + kChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.y;
  const int b = blockIdx.z / S, split = blockIdx.z % S;
  const int rep = H / KV, Wr = W * rep;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, Wr - row0);
  const int p0 = pos[b];
  const int frontier = p0 + (row0 + nrows - 1) / rep;  // last key any row sees
  const int key_begin = split * P * bs;
  const int key_end = min(min(M, (split + 1) * P) * bs, frontier + 1);
  const float sqrt_d = sqrtf(static_cast<float>(D));

  // the tile's query rows (zeros past Wr)
  for (int v = tid; v < R * kVpr; v += kThreads) {
    const int r = v / kVpr, off = v % kVpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int rr = row0 + r, w = rr / rep, h = g * rep + rr % rep;
      val = reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * W + w) * H + h) * D)[off];
    }
    reinterpret_cast<uint4*>(qs + r * D)[off] = val;
  }

  float m_run[kRpw], l_run[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    m_run[i] = kNegBig;
    l_run[i] = 0.f;
  }
  const int pv_row0 = (warp / kKSplit) * 4;
  const int kphase = warp % kKSplit;
  const int d0 = lane * DPL;
  float acc[4][DPL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;

  for (int kc = key_begin; kc < key_end; kc += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    if (tid < kChunk) {
      const int kidx = kc + tid;
      long long o = -1;
      float kscale = 0.f, vscale = 0.f;
      if (kidx < key_end) {
        const long long bid = tables[static_cast<size_t>(b) * M + kidx / bs];
        o = ((bid * bs + kidx % bs) * KV + g) * static_cast<long long>(D);
        if constexpr (kQuant) {
          kscale = k_scales[bid * KV + g];
          vscale = v_scales[bid * KV + g];
        }
      }
      koff[tid] = o;
      if constexpr (kQuant) {
        ksc[tid] = kscale;
        vsc[tid] = vscale;
      }
    }
    __syncthreads();
    // gather the chunk's K/V rows through the table (zeros past key_end)
    if constexpr (kQuant) {
      // int8 rows: 16 codes per 16-byte load, widened to bf16
      constexpr int kQpr = D / 16;                   // loads per row
      constexpr int kQLoads = kChunk * kQpr / kThreads;
#pragma unroll
      for (int i = 0; i < kQLoads; ++i) {
        const int v = tid + i * kThreads;
        const int c = v / kQpr, off = v % kQpr;
        const long long o = koff[c];
        uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
        if (o >= 0) {
          kq = reinterpret_cast<const uint4*>(k_pool + o)[off];
          vq = reinterpret_cast<const uint4*>(v_pool + o)[off];
        }
        codes_to_bf16(kq, reinterpret_cast<uint4*>(ks + c * L::kKStride) +
                              2 * off);
        codes_to_bf16(vq, reinterpret_cast<uint4*>(vs + c * D) + 2 * off);
      }
    } else {
#pragma unroll 1
      for (int base = 0; base < kLoads; base += kBatch) {
        uint4 kv[kBatch], vv[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int v = tid + (base + i) * kThreads;
          const long long o = koff[v / kVpr];
          kv[i] = make_uint4(0u, 0u, 0u, 0u);
          vv[i] = kv[i];
          if (o >= 0) {
            kv[i] = reinterpret_cast<const uint4*>(k_pool + o)[v % kVpr];
            vv[i] = reinterpret_cast<const uint4*>(v_pool + o)[v % kVpr];
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int v = tid + (base + i) * kThreads;
          const int c = v / kVpr, off = v % kVpr;
          reinterpret_cast<uint4*>(ks + c * L::kKStride)[off] = kv[i];
          reinterpret_cast<uint4*>(vs + c * D)[off] = vv[i];
        }
      }
    }
    __syncthreads();

    // scores: thread -> key c, rows rb .. rb + R/2 - 1
    {
      const int c = tid % kChunk;
      const int rb = (tid / kChunk) * (R / 2);
      float sc[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) sc[i] = 0.f;
      const T* kr = ks + c * L::kKStride;
#pragma unroll 4
      for (int d = 0; d < D; d += kVec) {
        float kf[kVec];
        load_f<T, kVec>(kr + d, kf);
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          float qf[kVec];
          load_f<T, kVec>(qs + (rb + i) * D + d, qf);
#pragma unroll
          for (int j = 0; j < kVec; ++j) sc[i] += qf[j] * kf[j];
        }
      }
      const int kidx = kc + c;
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int r = rb + i;
        const bool visible = r < nrows && kidx < key_end &&
                             kidx <= p0 + (row0 + r) / rep;
        // int8 pool: the reference's order, scores * k-scale, then / sqrt(D)
        const float s = kQuant ? sc[i] * ksc[c] : sc[i];
        ss[r * kChunk + c] = visible ? s / sqrt_d : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row; p rounded to V's dtype for PV
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      const int r = warp * kRpw + i;
      float* sr = ss + r * kChunk;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(e0 + e1);
      m_run[i] = m_new;
      if constexpr (kQuant) {   // v-scale on fp32 p, after the sum took p
        sr[lane] = to_f(from_f<T>(e0 * vsc[lane]));
        sr[lane + 32] = to_f(from_f<T>(e1 * vsc[lane + 32]));
      } else {
        sr[lane] = to_f(from_f<T>(e0));
        sr[lane + 32] = to_f(from_f<T>(e1));
      }
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // PV: lane -> columns d0 .. d0 + DPL - 1 of rows pv_row0 .. + 3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[pv_row0 + i];
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = kphase; c < kChunk; c += kKSplit) {
      float vf[DPL];
      load_f<T, DPL>(vs + c * D + d0, vf);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(pv_row0 + i) * kChunk + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] += p * vf[j];
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      m_s[warp * kRpw + i] = m_run[i];
      l_s[warp * kRpw + i] = l_run[i];
    }
  }
  // rows this thread finishes, and their columns' values
  constexpr int kFinRows = kKSplit == 1 ? 4 : 1;
  float fin[kFinRows][DPL];
  int fin_row0;
  if constexpr (kKSplit == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPL; ++j) fin[i][j] = acc[i][j];
    fin_row0 = pv_row0;
  } else {
    // R = 4: the 4 warps hold partial sums over their keys; warp w sums row w
    float* red = reinterpret_cast<float*>(smem);   // (warps, 4, D)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPL; ++j) red[(warp * 4 + i) * D + d0 + j] = acc[i][j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * 4 + warp) * D + d0 + j];
      fin[0][j] = v;
    }
    fin_row0 = warp;
  }
  __syncthreads();   // m_s, l_s visible

  const size_t bg = static_cast<size_t>(b) * KV + g;
#pragma unroll
  for (int i = 0; i < kFinRows; ++i) {
    const int r = fin_row0 + i;
    if (r >= nrows) continue;
    const int rr = row0 + r;
    if (S == 1) {
      const int w = rr / rep, h = g * rep + rr % rep;
      T* o = out + ((static_cast<size_t>(b) * W + w) * H + h) * D + d0;
      const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[j] = from_f<T>(fin[i][j] * inv_l);
    } else {
      const size_t prow = (bg * S + split) * Wr + rr;
      float* pa = part_acc + prow * D + d0;
#pragma unroll
      for (int j = 0; j < DPL; ++j) pa[j] = fin[i][j];
      if (lane == 0) {
        part_ml[prow * 2] = m_s[r];
        part_ml[prow * 2 + 1] = l_s[r];
      }
    }
  }
}

// Merge the S context splits: one warp per (b, g, row).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, int B, int W, int H, int KV,
                        int S) {
  constexpr int D = 32 * DPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rep = H / KV, Wr = W * rep;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= static_cast<long long>(B) * KV * Wr) return;
  const int rr = static_cast<int>(row % Wr);
  const long long bg = row / Wr;
  const int g = static_cast<int>(bg % KV), b = static_cast<int>(bg / KV);
  float m_max = kNegBig;
  for (int s = 0; s < S; ++s)
    m_max = fmaxf(m_max, part_ml[((bg * S + s) * Wr + rr) * 2]);
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  const int d0 = lane * DPL;
  for (int s = 0; s < S; ++s) {
    const long long prow = (bg * S + s) * Wr + rr;
    const float wgt = expf(part_ml[prow * 2] - m_max);
    l += part_ml[prow * 2 + 1] * wgt;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] += part_acc[prow * D + d0 + j] * wgt;
  }
  const int w = rr / rep, h = g * rep + rr % rep;
  T* o = out + ((static_cast<size_t>(b) * W + w) * H + h) * D + d0;
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPL; ++j) o[j] = from_f<T>(acc[j] * inv_l);
}

template <typename T, typename PT, int DPL, int R>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* tables, const int* pos, void* out,
           float* part_acc, float* part_ml, int B, int W, int H, int KV,
           int bs, int M, int S, int P, cudaStream_t s) {
  using Lay = Layout<T, DPL, R>;
  static_assert(Lay::total <= 232448, "shared memory");
  static bool attr_set = false;
  if (Lay::total > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, PT, DPL, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Lay::total));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int Wr = W * (H / KV);
  const dim3 grid((Wr + R - 1) / R, KV, B * S);
  paged_attention_kernel<T, PT, DPL, R><<<grid, kThreads, Lay::total, s>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ksc, vsc, tables, pos, static_cast<T*>(out),
      part_acc, part_ml, W, H, KV, bs, M, S, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long rows = static_cast<long long>(B) * KV * Wr;
  paged_attention_combine<T, DPL>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
          part_acc, part_ml, static_cast<T*>(out), B, W, H, KV, S);
  return (int)cudaGetLastError();
}

template <typename T, typename PT, int DPL>
int dispatch_r(const void* q, const void* kp, const void* vp, const float* ks,
               const float* vs, const int* t, const int* p, void* out,
               float* pa, float* pm, int B, int W, int H, int KV, int bs,
               int M, int S, int P, cudaStream_t s) {
  if (W * (H / KV) <= 4)
    return launch<T, PT, DPL, 4>(q, kp, vp, ks, vs, t, p, out, pa, pm, B, W,
                                 H, KV, bs, M, S, P, s);
  return launch<T, PT, DPL, 16>(q, kp, vp, ks, vs, t, p, out, pa, pm, B, W,
                                H, KV, bs, M, S, P, s);
}

bool bad_args(int B, int W, int H, int KV, int D, int N, int bs, int M,
              int S, int P, const void* part_acc, const void* part_ml) {
  return B <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || D != 128 || bs <= 0 ||
         M <= 0 || N <= 0 || S <= 0 || P <= 0 ||
         static_cast<long long>(S) * P < M || KV > 65535 ||
         static_cast<long long>(B) * S > 65535 ||
         (S > 1 && (part_acc == nullptr || part_ml == nullptr));
}

}  // namespace

// bfloat16 only, D = 128 (the served model's; other types and head dims
// are instantiated when a slice needs them). All tensors contiguous; q,
// pools and out 16-byte aligned; H % KV == 0; every table entry a valid
// block id in [0, N). The context splits into S parts of P table entries
// (S * P >= M); with S > 1, part_acc (B, KV, S, W*H/KV, D) and part_ml
// (B, KV, S, W*H/KV, 2) are fp32 workspaces. Returns cudaGetLastError()
// after the launches.
extern "C" int pt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* pos, void* out, void* part_acc,
                                  void* part_ml, int B, int W, int H, int KV,
                                  int D, int N, int bs, int M, int S, int P,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_args(B, W, H, KV, D, N, bs, M, S, P, part_acc, part_ml))
    return (int)cudaErrorInvalidValue;
  return dispatch_r<__nv_bfloat16, __nv_bfloat16, 4>(
      q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(tables),
      static_cast<const int*>(pos), out, static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), B, W, H, KV, bs, M, S, P, s);
}

// The int8 pool: k_pool/v_pool (N, bs, KV, D) int8 codes, 16-byte aligned;
// k_scales/v_scales (N, KV) f32. Otherwise as pt_paged_attention.
extern "C" int pt_paged_attention_int8(
    const void* q, const void* k_pool, const void* k_scales,
    const void* v_pool, const void* v_scales, const void* tables,
    const void* pos, void* out, void* part_acc, void* part_ml, int B, int W,
    int H, int KV, int D, int N, int bs, int M, int S, int P, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_args(B, W, H, KV, D, N, bs, M, S, P, part_acc, part_ml) ||
      k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_r<__nv_bfloat16, int8_t, 4>(
      q, k_pool, v_pool, static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables),
      static_cast<const int*>(pos), out, static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), B, W, H, KV, bs, M, S, P, s);
}
