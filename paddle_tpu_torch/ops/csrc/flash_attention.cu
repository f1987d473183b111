// Causal / GQA flash attention forward for Hopper (sm_90a). The backward
// pair (dQ, dK/dV) is flash_attention_bwd.cu.
//
// Replaces: paddle_tpu/ops/flash_attention.py, the full-K loop kernel
//   _fwd_kernel_loop      launched by _flash_fwd_bhsd_loop   (:488)
// and the streaming kernel the JAX package takes past _FULL_K_MAX = 8192
// keys (:678, dispatch :771-789)
//   _fwd_kernel           launched by _flash_fwd_bhsd_stream (:189)
// The TPU keeps two forms because its loop kernel holds the whole of K/V in
// VMEM, which stops fitting past 8192 keys; they compute one function. The
// kernel below already streams 64-key tiles through shared memory at any
// length, so both forms launch the same entry point; the Python wrappers
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
//
// Bound: operations. At the training shape (B = 2, H = 32, Hkv = 8, S =
// 2048, D = 128, causal) the forward does 2 products of 2*S*S*D/2 flops
// per head (~69 us at the H100 SXM's 989 TFLOP/s bf16 peak, data sheet,
// 700 W) on 84 MB of q, k, v and O (~25 us at its 3.35 TB/s). So the
// products must run on the tensor cores.
//
// Design. The TPU kernel runs a sequential grid and keeps whole K/V blocks
// of up to 8192 rows resident in VMEM; on Hopper blocks run in parallel and
// a block has at most 227 KB of shared memory, so:
//   * one block of 4 warps per (64-row query tile, head, batch); each warp
//     owns 16 query rows, keeps its Q fragments in registers, and loops
//     over 64-key K/V tiles staged in shared memory up to the tile's causal
//     frontier (the TPU kernel's early stop). GQA reads the shared KV head
//     directly: nothing is repeated in memory. The causal tiles with the
//     most keys are launched first.
//   * every product is warp-level mma.sync m16n8k16 (bf16 in, fp32
//     accumulate); the softmax probabilities go from the fp32 accumulator
//     layout straight into the PV product's A operand in registers.
//     Shared-memory rows are padded by 16 bytes (8 bf16), so a row is
//     D + 8 elements: 68 words at D = 128 and 36 at D = 64, both 4
//     (mod 32), so the 8 rows x 4 words of a fragment load hit 32 different
//     banks at either head dim, and the 16-byte tile stores of a
//     quarter-warp cover one 128-byte span of a row.
//   * grid: ceil(Sq / 64) x H x B blocks (768 at ERNIE's B = 32, H = 12,
//     S = 128; 3,072 at S = 512).
//   * a ragged last tile (S not a multiple of 64) is loaded with zeros and
//     masked; nothing needs a fallback.
// Left for later: TMA double buffering of the K/V tiles and wgmma (as the
// backward pair has them); the loop waits on its shared-memory loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // query rows / keys per tile

// a (64 x kD) bf16 tile in shared memory: its padded row, in elements,
// and its size
template <int kD>
struct Tile {
  static constexpr int kStride = kD + 8;
  static constexpr int kElems = kTile * kStride;
};
constexpr float kNegBig = -1e30f;     // running-max start, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(const bf16* lo, const bf16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// rows [row0, row0 + 64) of a (rows x kD) bf16 matrix into a padded shared
// tile; rows at or past `limit` are zeros
template <int kD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int limit, int tid) {
  static_assert(kD == 64 || kD == 128, "head dim 64 or 128");
  constexpr int kRowShift = kD == 128 ? 4 : 3;  // log2 of 16-byte chunks a row
  constexpr int kChunks = kTile << kRowShift;
  // a signed counter (the loop unrolls) and a shift and a mask (a signed /
  // and % cost instructions and registers: at D = 128 the forward then
  // needed 179 registers, 2 blocks an SM, and ran 1.5x as long on an H100)
#pragma unroll
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c >> kRowShift, col = (c & ((1 << kRowShift) - 1)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(g + size_t(row0 + r) * kD + col);
    *reinterpret_cast<uint4*>(s + r * Tile<kD>::kStride + col) = val;
  }
}

// fragment lanes: g = lane / 4 (row group), t = lane % 4
// A operand (16 x 16) of a row-major shared tile at (r0, c0)
template <int kD>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int r0,
                                       int c0, int g, int t) {
  constexpr int kStride = Tile<kD>::kStride;
  const bf16* p = s + (r0 + g) * kStride + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kStride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kStride + 8);
}

// B operand (16 x 8) whose transpose is the shared tile: B[k][n] = s[n0 + n]
// [k0 + k] (keys or query rows of the tile are B's columns)
template <int kD>
__device__ __forceinline__ void frag_b_rows(uint32_t* b, const bf16* s,
                                            int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * Tile<kD>::kStride + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B operand (16 x 8) read straight from the shared tile: B[k][n] = s[k0 + k]
// [n0 + n] (the tile's rows are the reduction dim)
template <int kD>
__device__ __forceinline__ void frag_b_cols(uint32_t* b, const bf16* s,
                                            int k0, int n0, int g, int t) {
  constexpr int kStride = Tile<kD>::kStride;
  const bf16* p = s + (k0 + 2 * t) * kStride + n0 + g;
  b[0] = pair(p, p + kStride);
  b[1] = pair(p + 8 * kStride, p + 9 * kStride);
}

// A operand (16 x 16) from two fp32 accumulator tiles (16 x 8 each, columns
// 0-7 and 8-15 of the A tile), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// number of 64-key tiles the query rows [q0, q0 + 64) need
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal) {
  int n = (Sk + kTile - 1) / kTile;
  if (causal) {
    const int last = min(q0 + kTile, Sq) - 1 + (Sk - Sq);  // last key seen
    n = last < 0 ? 0 : min(n, last / kTile + 1);
  }
  return n;
}

__device__ __forceinline__ bool visible(int key, int row, int Sk, int offs,
                                        int causal) {
  return key < Sk && (!causal || key <= row + offs);
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 int causal, float scale) {
  __shared__ __align__(16) bf16 sK[Tile<kD>::kElems];
  __shared__ __align__(16) bf16 sV[Tile<kD>::kElems];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const bf16* qb = q + size_t(b * H + h) * Sq * kD;
  const bf16* kb = k + size_t(b * Hkv + hk) * Sk * kD;
  const bf16* vb = v + size_t(b * Hkv + hk) * Sk * kD;
  const int offs = Sk - Sq;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<kD>(sK, qb, q0, Sq, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) frag_a<kD>(qf[kc], sK, warp * 16, kc * 16, g, t);
  __syncthreads();

  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int ntiles = key_tiles(q0, Sq, Sk, causal);
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    load_tile<kD>(sK, kb, k0, Sk, tid);
    load_tile<kD>(sV, vb, k0, Sk, tid);
    __syncthreads();
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t bf[2];
        frag_b_rows<kD>(bf, sK, nt * 8, kc * 16, g, t);
        mma(s[nt], qf[kc], bf);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float sv = visible(key, row[e >> 1], Sk, offs, causal)
                             ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nt][e] - m[e >> 1]) * kLog2e);  // 0 if masked
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        uint32_t bf[2];
        frag_b_cols<kD>(bf, sV, kc * 16, nd * 8, g, t);
        mma(acc[nd], pa, bf);
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ls = fmaxf(quad_sum(l[i]), 1e-30f);
    if (row[i] >= Sq) continue;
    const float inv = 1.f / ls;
    bf16* orow = o + (size_t(b * H + h) * Sq + row[i]) * kD;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
    }
    if (t == 0) lse[size_t(b * H + h) * Sq + row[i]] = m[i] + logf(ls);
  }
}


template <int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               float scale, cudaStream_t stream) {
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<kD><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 only, head dim D = 64 or 128. q, O: (B, H, Sq, D); k, v:
// (B, Hkv, Sk, D); lse: fp32 (B, H, Sq); all contiguous and 16-byte
// aligned. Returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue, launching nothing, for another D or a bad
// shape). Row 1 and the streaming row 2 launch this same entry point.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Hkv, int Sq,
                            int Sk, int D, int causal, float scale,
                            void* stream) {
  if (flash_tiles::bad_shape(B, H, Hkv, Sq, Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
