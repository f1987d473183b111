// The work plan of the whole-tick decode kernel (decode_megakernel.cu): which
// weight tiles each block streams in each product phase, in what order, how
// the K-split partial sums are reduced, the ring's stages and the shared-
// memory budget, and the grid barriers a tick. Plain C++, so that a host
// compiler can build it into a test harness (tests/test_torch_tick_plan.py);
// under nvcc the functions are __host__ __device__.
//
// A product phase computes out (rows, N) = x (rows, K) @ W (K, N) for one or
// more weights of the layer (Paddle's [in, out] layout):
//   kQKV     q, k and v from the normed residual (K = hidden);
//   kO       o from the attention output (K = hidden);
//   kGateUp  gate and up from the normed residual (K = hidden);
//   kDown    down from SiLU(gate) * up (K = intermediate).
// Its output columns fall into groups of two 64-column blocks, the columns
// one epilogue needs together: a q or k head (the RoPE pairs d, d + 64), a v
// head, 128 columns of o or down, and gate block j beside up block j (SiLU(g)
// * u). A unit is one 64 x 64 bf16 weight tile (8 KB: one TMA box, one ring
// stage), column block c of group g at K step t. K is cut into S slices of
// klen steps; an item is the units of one (slice, group, column block), and
// the phase's units are ordered (slice, group, column block, K step). Block
// b of the grid streams the contiguous units [ub(b), ub(b + 1)): every block
// the same bytes to within one tile. A block's units of one item are a
// fragment; it sums them in registers and writes the fp32 partial to slot
// item + block of a scratch (distinct for every fragment: along the unit
// order each fragment boundary advances the item, the block or both). The
// last fragment to arrive at a group's counter sums the group's fragments
// in a fixed order (column block, slice, block), whatever order they
// arrived in, and runs the epilogue: no floating-point atomics, so a tick
// is deterministic.
//
// The x rows a block multiplies are staged in shared memory, normed and
// rounded to bf16, one K slice at a time as the block's fragments reach it:
// klen is the most K steps of x the slab holds at the largest row tile
// (kMaxRows), whatever the phase's rows, so that the slices, and with
// them each element's order of summation, do not depend on the rows.
#pragma once

#if defined(__CUDACC__)
#define TICK_PLAN_FN __host__ __device__ __forceinline__
#else
#define TICK_PLAN_FN inline
#endif

namespace tick_plan {

constexpr int kHeadDim = 128;     // the one head dim of the kernel
constexpr int kKStep = 64;        // K rows of a unit
constexpr int kColBlock = 64;     // columns of a unit (the wgmma M)
constexpr int kUnitBytes = kKStep * kColBlock * 2;
constexpr int kMaxRows = 64;      // B * W: the wgmma N, 8 to 64
constexpr int kMaxRank = 16;      // LoRA rank
constexpr int kGridAlign = 1024;  // the 128-byte swizzle's atom alignment

// Shared memory of a block. The ring of weight stages (12 x 8 KB = 96 KB
// in flight an SM at the default prefetch depth 2; a launch runs
// kStagesPerDepth x depth of them, depth 1 or 2: a depth of 4 would need
// 24 stages, past a block's 227 KB); a union of the x slab (the product phases), one
// dequantized int8 block-head and the attention merge (the attention
// phase); the LoRA rank rows of an epilogue (two targets, 8 KB), 16 KB
// that at a fragment's end carry one consumer warpgroup's sums to the
// other; the per-row 1/rms, reduction partials, flags and the ring's
// mbarriers; and room to align the base to 1024 bytes.
constexpr int kStages = 12;
constexpr int kStagesPerDepth = 6;
constexpr int kRingBytes = kStages * kUnitBytes;
constexpr int kUnionBytes = 112 * 1024;
constexpr int kLtFloats = 2 * kMaxRows * kMaxRank * 2;
constexpr int kLtBytes = kLtFloats * 4;
constexpr int kMiscBytes = 2048;
constexpr int kSmemBytes =
    kRingBytes + kUnionBytes + kLtBytes + kMiscBytes + kGridAlign;
constexpr int kSmemLimit = 232448;  // 227 KB, a block's most on sm_90
static_assert(kSmemBytes <= kSmemLimit, "the tick's shared memory");

// the ring stages a launch at a prefetch depth runs; 0 for a depth whose
// ring the layout does not hold
TICK_PLAN_FN int ring_stages(int depth) {
  const int n = kStagesPerDepth * depth;
  return depth >= 1 && n <= kStages ? n : 0;
}

enum Phase { kQKV = 0, kO = 1, kGateUp = 2, kDown = 3, kProductPhases = 4 };

TICK_PLAN_FN int cdiv(int a, int b) { return (a + b - 1) / b; }

// the wgmma N that holds `rows` rows of x: 8, 16, 32 or 64
TICK_PLAN_FN int row_tile(int rows) {
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
}

// K steps of x the slab holds at a row tile
TICK_PLAN_FN int slab_steps(int nr) { return kUnionBytes / (nr * 128); }

// the grid barriers of a tick: five a layer (after q/k/v, attention, o,
// gate/up and down), and one more before each served LoRA target set's
// products (its shrink: q/k/v, o, gate/up, down)
TICK_PLAN_FN int barriers(int L, int lora_shrinks) {
  return L * (5 + lora_shrinks);
}

struct Dims {
  int hid;    // hidden size, H * 128
  int kv;     // KV heads
  int inter;  // intermediate size
  int rows;   // B * W
  int ffn;    // the down product's K steps a slice (the geometry's
              // ffn_tile / 64); 0: the slices of the other phases' rule
};

struct PhasePlan {
  int G;          // groups of two column blocks
  int T;          // K steps
  int S;          // K slices
  int klen;       // K steps of a slice; the last may be shorter
  int U;          // units, 2 G T (U * NB < 2^31: fits)
  int NB;         // blocks of the grid
  int nr;         // row tile
};

TICK_PLAN_FN PhasePlan plan(const Dims& d, int phase, int NB) {
  PhasePlan p;
  const int H = d.hid / kHeadDim;
  p.G = phase == kQKV ? H + 2 * d.kv
        : phase == kGateUp ? d.inter / kColBlock
        : d.hid / (2 * kColBlock);
  p.T = (phase == kDown ? d.inter : d.hid) / kKStep;
  p.nr = row_tile(d.rows);
  // the fewest slices that each fit the slab at the largest row tile, at
  // every row count: a phase's slice boundaries depend on K alone, so an
  // output element is summed over the same slices in the same order at 8
  // rows (a decode tick) as at 40 (a verify window): the tick is
  // batch-invariant (the wgmma's N taken not to change an element's sum)
  p.S = cdiv(p.T, slab_steps(row_tile(kMaxRows)));
  p.klen = cdiv(p.T, p.S);
  p.S = cdiv(p.T, p.klen);   // no empty slice
  if (phase == kDown && d.ffn > 0) {
    // ffn_tile: slices of the geometry's width, whatever the rows
    p.klen = d.ffn;
    p.S = cdiv(p.T, p.klen);
  }
  p.U = 2 * p.G * p.T;
  p.NB = NB;
  return p;
}

// K steps of slice s
TICK_PLAN_FN int slice_len(const PhasePlan& p, int s) {
  const int r = p.T - s * p.klen;
  return r < p.klen ? r : p.klen;
}

TICK_PLAN_FN int items(const PhasePlan& p) { return 2 * p.G * p.S; }

// item i = (s G + g) 2 + c: its slice, group and column block
TICK_PLAN_FN int item_slice(const PhasePlan& p, int i) { return i / (2 * p.G); }
TICK_PLAN_FN int item_group(const PhasePlan& p, int i) { return (i / 2) % p.G; }
TICK_PLAN_FN int item_col(int i) { return i % 2; }
TICK_PLAN_FN int item_of(const PhasePlan& p, int s, int g, int c) {
  return (s * p.G + g) * 2 + c;
}

// the first unit of item i, and its units
TICK_PLAN_FN int item_start(const PhasePlan& p, int i) {
  const int s = item_slice(p, i);
  return s * 2 * p.G * p.klen + (i % (2 * p.G)) * slice_len(p, s);
}

// the first unit of block b (b = NB: the end)
TICK_PLAN_FN int block_start(const PhasePlan& p, int b) {
  return p.U * b / p.NB;
}

// the block that streams unit u
TICK_PLAN_FN int block_of(const PhasePlan& p, int u) {
  return ((u + 1) * p.NB - 1) / p.U;
}

// unit u as (item, K step)
TICK_PLAN_FN void unit(const PhasePlan& p, int u, int* item, int* t) {
  const int per = 2 * p.G * p.klen;   // units of a full slice
  int s = u / per;
  if (s > p.S - 1) s = p.S - 1;
  const int r = u - s * per;
  const int len = slice_len(p, s);
  *item = s * 2 * p.G + r / len;
  *t = s * p.klen + r % len;
}

// the next fragment of a block, from unit *u (< end): its item, first K
// step and units; advances *u past it. The walk of the producer and of the
// consumers.
struct Frag {
  int item, t0, n;
};
TICK_PLAN_FN Frag next_frag(const PhasePlan& p, int* u, int end) {
  Frag f;
  unit(p, *u, &f.item, &f.t0);
  const int ie = item_start(p, f.item) + slice_len(p, item_slice(p, f.item));
  const int fe = ie < end ? ie : end;
  f.n = fe - *u;
  *u = fe;
  return f;
}

// the scratch slot of the fragment of item i in block b; slots a phase
TICK_PLAN_FN int slot(int i, int b) { return i + b; }
TICK_PLAN_FN int slots(const PhasePlan& p) { return items(p) + p.NB; }

// the blocks [*b0, *b1] that hold fragments of item i: those of them
// that stream any unit (with more blocks than units some stream none)
TICK_PLAN_FN void item_blocks(const PhasePlan& p, int i, int* b0, int* b1) {
  const int s = item_start(p, i);
  *b0 = block_of(p, s);
  *b1 = block_of(p, s + slice_len(p, item_slice(p, i)) - 1);
}
TICK_PLAN_FN bool streams(const PhasePlan& p, int b) {
  return block_start(p, b + 1) > block_start(p, b);
}

// fragments of item i: the blocks that stream any of its units (with at
// least as many units as blocks, every block streams)
TICK_PLAN_FN int item_frags(const PhasePlan& p, int i) {
  int b0, b1;
  item_blocks(p, i, &b0, &b1);
  if (p.U >= p.NB) return b1 - b0 + 1;
  int n = 0;
  for (int b = b0; b <= b1; ++b) n += streams(p, b) ? 1 : 0;
  return n;
}

// fragments of group g: the arrivals that complete the group's counter
TICK_PLAN_FN int group_frags(const PhasePlan& p, int g) {
  int n = 0;
  for (int s = 0; s < p.S; ++s)
    for (int c = 0; c < 2; ++c) n += item_frags(p, item_of(p, s, g, c));
  return n;
}

// the K steps [*k0, *k1) of slice sl: the x a fragment of it multiplies
TICK_PLAN_FN void slice_steps(const PhasePlan& p, int sl, int* k0, int* k1) {
  *k0 = sl * p.klen;
  *k1 = *k0 + slice_len(p, sl);
}

// weight (0 q, 1 k, 2 v, 3 o, 4 gate, 5 up, 6 down) and first column of
// column block c of group g
TICK_PLAN_FN void columns(const Dims& d, int phase, int g, int c, int* w,
                          int* n0) {
  const int H = d.hid / kHeadDim;
  if (phase == kQKV) {
    const int kind = g < H ? 0 : g < H + d.kv ? 1 : 2;
    const int head = kind == 0 ? g : kind == 1 ? g - H : g - H - d.kv;
    *w = kind;
    *n0 = head * kHeadDim + c * kColBlock;
  } else if (phase == kGateUp) {
    *w = 4 + c;
    *n0 = g * kColBlock;
  } else {
    *w = phase == kO ? 3 : 6;
    *n0 = g * 2 * kColBlock + c * kColBlock;
  }
}

// the most groups of any phase (the counters the kernel needs)
TICK_PLAN_FN int max_groups(const Dims& d) {
  int m = 0;
  for (int ph = 0; ph < kProductPhases; ++ph) {
    const int g = plan(d, ph, 1).G;
    if (g > m) m = g;
  }
  return m;
}

// fp32 floats of the partial-sum scratch: a rows x 64 partial for every
// slot of the largest phase
TICK_PLAN_FN long long scratch_floats(const Dims& d, int NB) {
  long long m = 0;
  for (int ph = 0; ph < kProductPhases; ++ph) {
    const long long n = slots(plan(d, ph, NB));
    if (n > m) m = n;
  }
  return m * d.rows * kColBlock;
}

// the shapes the plan takes: head dim 128 (hid a multiple of 128), the
// intermediate size a multiple of 64, 1 to 64 rows, a down slice (ffn)
// that divides the intermediate size's K steps, and a slice of x within
// the slab
TICK_PLAN_FN bool fits(const Dims& d, int NB) {
  if (d.hid <= 0 || d.hid % kHeadDim || d.inter <= 0 || d.inter % kColBlock ||
      d.kv <= 0 || d.rows < 1 || d.rows > kMaxRows || NB < 1 ||
      d.hid > (1 << 16) || d.inter > (1 << 18) || d.kv > 256 || NB > 4096 ||
      d.ffn < 0 || (d.ffn > 0 && (d.inter / kKStep) % d.ffn))
    return false;
  for (int ph = 0; ph < kProductPhases; ++ph) {
    const PhasePlan p = plan(d, ph, NB);
    // the plan's unit arithmetic stays in 32 bits
    if ((long long)(p.U + 1) * NB >= (1LL << 31)) return false;
    if (p.klen > slab_steps(p.nr)) return false;
  }
  return true;
}

}  // namespace tick_plan
