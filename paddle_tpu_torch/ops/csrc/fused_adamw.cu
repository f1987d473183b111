// One-pass Adam(W) update for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused_adamw.py, the Pallas kernel of
// `_make_kernel` launched by `_fused_call` (:167). Semantics, kept: with pf
// the fp32 master weight (or the upcast bf16 parameter, or an fp32
// parameter itself) and g the gradient upcast to fp32,
//   master = pf * (1 - lr * decay)
//   m2 = b1 * m + (1 - b1) * g;  v2 = b2 * v + (1 - b2) * g * g
//   new = master - lr * (m2 / bc1) / (sqrt(v2 / bc2) + eps)
// with lr and the bias corrections 1 / bc = 1 / (1 - beta^step) read from
// a float array on the device, [lr, 1/bc1, 1/bc2] (the TPU kernel's scalar
// block `sc_ref`), which the optimizer builds once a step in fp32 from the
// device learning rate and step count: a CUDA graph replays the launch
// with the same pointer while the values change. wd = 1 - lr * decay is
// computed here from that lr. p (bf16), m, v (fp32) and the master (fp32)
// are written in place. Every product and sum is rounded on its own (no
// fused multiply-add), in the order PyTorch's eager ops evaluate the plain
// version, which reads the same scalars and multiplies by them too.
//
// Bound: bytes. Per element it reads the master (4 B; without one, p, 2 B),
// g (2 B bf16 or 4 B fp32), m and v (4 B each), and writes p, m, v and the
// master: 28 bytes with a bf16 gradient and a master, for ~15 flops —
// memory-bound by two orders of magnitude. The largest tensors on the
// training path are the embedding table and the untied lm-head, 128256 x
// 4096 (525 M elements): 14.7 GB per update, 4.39 ms at the H100 SXM's
// 3.35 TB/s (data sheet, 700 W); an MLP projection, 4096 x 14336, moves
// 1.64 GB in 0.49 ms.
//
// Design: a grid-stride loop over groups of 8 elements, so that every
// access is a 16-byte load or store (8 bf16 or two 4-float vectors) and
// neighbouring threads touch neighbouring addresses; the last n % 8
// elements go one per thread. One launch per tensor, as the TPU kernel, or
// one launch over the whole model's flat (K, 512) state (PT_MT_ADAMW=1,
// the TPU package's `flat_adamw_update`): Llama-3-8B's 8.03e9 elements
// pass 2^31, so every index and the element count are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

struct Hyper {
  float lr, inv_bc1, inv_bc2, b1, omb1, b2, omb2, eps, wd;  // wd = 1 - lr*decay
};

struct Consts {  // the launch's host constants; lr and 1/bc come from `sc`
  float b1, omb1, b2, omb2, eps, decay;
};

// every thread reads the three scalars (one 12-byte line, from L2)
__device__ __forceinline__ Hyper hyper(const float* __restrict__ sc,
                                       const Consts& c) {
  const float lr = sc[0];
  return Hyper{lr, sc[1], sc[2], c.b1, c.omb1, c.b2, c.omb2, c.eps,
               __fsub_rn(1.0f, __fmul_rn(lr, c.decay))};
}

__device__ __forceinline__ void update(float pf, float gf, float& m, float& v,
                                       float& out, const Hyper& h) {
  const float master = __fmul_rn(pf, h.wd);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gf));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gf), gf));
  const float mhat = __fmul_rn(m, h.inv_bc1);
  const float vhat = __fmul_rn(v, h.inv_bc2);
  out = __fsub_rn(master, __fdiv_rn(__fmul_rn(h.lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), h.eps)));
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// P: the parameter's type, bf16 (with or without an fp32 master) or fp32
// (the parameter is its own master: LoRA's factors)
template <typename G, typename P, bool kMaster>
__global__ void __launch_bounds__(256)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             float* __restrict__ master, long long n,
             const float* __restrict__ sc, Consts c) {
  const Hyper h = hyper(sc, c);
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n8; i += stride) {
    const size_t o = size_t(i) * 8;
    float pf[8], gf[8], mf[8], vf[8], out[8];
    if (kMaster) load8(master + o, pf); else load8(p + o, pf);
    load8(g + o, gf);
    load8(m + o, mf);
    load8(v + o, vf);
#pragma unroll
    for (int j = 0; j < 8; ++j) update(pf[j], gf[j], mf[j], vf[j], out[j], h);
    store8(p + o, out);
    store8(m + o, mf);
    store8(v + o, vf);
    if (kMaster) store8(master + o, out);
  }
  const long long tail = n8 * 8 + (long long)blockIdx.x * blockDim.x +
                         threadIdx.x;
  if (tail < n) {
    const float pf = kMaster ? master[tail] : tof(p[tail]);
    const float gf = tof(g[tail]);
    float mf = m[tail], vf = v[tail], out;
    update(pf, gf, mf, vf, out, h);
    put(p + tail, out);
    m[tail] = mf;
    v[tail] = vf;
    if (kMaster) master[tail] = out;
  }
}

template <typename G, typename P>
void launch(void* p, const void* g, void* m, void* v, void* master,
            long long n, const float* sc, const Consts& c, cudaStream_t s) {
  constexpr int kThreads = 256;
  const int blocks = (int)std::max(
      1LL, std::min((n / 8 + kThreads - 1) / kThreads, 132LL * 16));
  if (master) {
    adamw_kernel<G, P, true><<<blocks, kThreads, 0, s>>>(
        static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<float*>(master), n, sc, c);
  } else {
    adamw_kernel<G, P, false><<<blocks, kThreads, 0, s>>>(
        static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
        static_cast<float*>(v), nullptr, n, sc, c);
  }
}

}  // namespace

// p: bfloat16 (p_fp32 = 0) or float32 (p_fp32 = 1, no master); g:
// bfloat16 (g_fp32 = 0) or float32 (g_fp32 = 1); m, v, master (NULL for
// none): float32; all n (64-bit) elements, contiguous, 16-byte
// aligned, updated in place; sc: float32 [lr, 1/(1-b1^step), 1/(1-b2^step)]
// on the device. Returns cudaGetLastError() after the launch.
extern "C" int pt_fused_adamw(void* p, const void* g, void* m, void* v,
                              void* master, long long n, int g_fp32,
                              int p_fp32, const float* sc, float b1, float omb1, float b2,
                              float omb2, float eps, float decay,
                              void* stream) {
  if (n <= 0 || sc == nullptr || (p_fp32 && master))
    return (int)cudaErrorInvalidValue;
  const Consts c{b1, omb1, b2, omb2, eps, decay};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p_fp32) {
    if (g_fp32) launch<float, float>(p, g, m, v, master, n, sc, c, s);
    else launch<bf16, float>(p, g, m, v, master, n, sc, c, s);
  } else {
    if (g_fp32) launch<float, bf16>(p, g, m, v, master, n, sc, c, s);
    else launch<bf16, bf16>(p, g, m, v, master, n, sc, c, s);
  }
  return (int)cudaGetLastError();
}
