// The work plan of the paged attention kernel (paged_attention.cu): which
// tiles and splits a launch takes, which keys each block walks, which pages a
// ring stage loads, and which splits the combine pass merges. Plain C++, so
// that a host compiler can build it into a test harness
// (tests/test_torch_paged_tiles.py); under nvcc the functions are
// __host__ __device__.
//
// Terms. A batch row b holds W query tokens at positions pos[b] + w; its
// query heads form KV groups of rep = H / KV heads, and the rows of one
// (b, KV head) are ordered (w, r): row rr sits at position pos[b] + rr /
// rep and sees key j iff j <= pos[b] + rr / rep. Keys are positions in the
// row's context: key j is slot j % bs of the block at table entry j / bs.
//
// The plan. A unit of work is one tile of kRows query rows of one (b, KV
// head) (one wgmma M tile) and one split: a run of `ks` keys from key 0,
// walked in ring stages of kStageKeys keys, so that each row takes as
// many splits as its own length needs. ks (row_split_keys) is at least
// kSplitKeys, more where a launch with half its B rows as long as the
// table would give more units than one wave of blocks; it depends on the
// launch's shapes alone (B, KV, the table's keys, the tiles a row's query
// rows fill: one for every W <= 64 / rep), not on any row's position. So a row's splits, and its rounding, never depend on
// the other rows of the launch (a served request's tokens do not change
// with the batch it shares), and a query's keys fall in the same splits
// in a decode tick as in a verify window (its logits are the same bits).
// Every launch is sized from shapes alone (the grid, the most splits a
// tile can take, the workspace), never from pos: the kernel reads pos on
// the card and derives from it the work there is. The work items (b, tile,
// split) with split < tile_splits(...) are numbered in that order (b
// slowest, split fastest), and work unit L is item L / KV, KV head L % KV.
// The grid is persistent: at most one wave of blocks (work_blocks), block
// i taking units i, i + grid, i + 2 grid, ... up to the launch's last
// (launch_units), its ring running on from one unit to the next.
//
// A stage loads its keys as TMA boxes of `box` keys (a divisor of bs, so a
// box never straddles two blocks of the pool). A box whose first key lies
// past the tile's frontier (the last key its last row sees) is never loaded
// from the pool: the kernel fills its slots with zeros (an out-of-range TMA
// box) and the mask gives those keys p = 0. So the tail table entries,
// which point at scratch block 0, are never read, whatever it holds.
//
// A tile that needs one split writes its output directly; one that needs
// more writes each split's unnormalised (m, l, acc) to a workspace, and the
// combine pass merges exactly those splits.
//
// The schedule (the autotuner's PagedAttentionGeometry) changes none of
// that: `order` renumbers the work units (0 "bgm": KV head fastest, as
// above; 1 "gbm": KV head slowest, so that neighbouring blocks take one
// head's items, batch row after batch row), a permutation of the same
// units (order_unit); the ring's depth changes the shared-memory layout
// (layout) and, with it, the blocks an SM holds,
// but the plan's `wave` (which sizes the splits) is the default layout's,
// so the splits and every sum's order are the default's.
#pragma once

#if defined(__CUDACC__)
#define PAGED_TILES_FN __host__ __device__ __forceinline__
#else
#define PAGED_TILES_FN inline
#endif

namespace paged_tiles {

constexpr int kRows = 64;          // query rows a block: one wgmma M tile
constexpr int kStageKeys = 64;     // keys a ring stage
// the fewest keys a split takes, in decode and prefill alike
constexpr int kSplitKeys = 128;
constexpr int kMaxUnits = 2147483647;  // work unit indices are ints
constexpr int kHeadDim = 128;      // the kernel's one head dim
constexpr int kSmemOptIn = 232448; // the most shared memory a block takes

PAGED_TILES_FN int cdiv(int a, int b) { return (a + b - 1) / b; }
PAGED_TILES_FN int imin(int a, int b) { return a < b ? a : b; }
PAGED_TILES_FN int imax(int a, int b) { return a > b ? a : b; }

// keys a TMA box holds: the largest power of two that divides bs, at most
// a stage (bs a multiple of 8: the TPU kernel's rule, and a box of 8 rows
// of 128 bytes is one 1024-byte swizzle atom)
PAGED_TILES_FN int box_keys(int bs) {
  const int low = bs & -bs;
  return low < kStageKeys ? low : kStageKeys;
}

struct Plan {
  int rows;        // query rows a (b, KV head): W * rep
  int tiles;       // kRows-row tiles a (b, KV head)
  int split_keys;  // the fewest keys a split takes (kStageKeys multiple)
  int splits;      // splits a tile at most: the table's keys / split_keys
  int box;         // keys a TMA box
  long long items; // work items at most: B * tiles * splits
  long long units; // work units at most: items * KV
};

// The plan of one launch, from shapes alone.
PAGED_TILES_FN Plan plan(int B, int W, int H, int KV, int bs, int M) {
  Plan p;
  p.rows = W * (H / KV);
  p.tiles = cdiv(p.rows, kRows);
  p.split_keys = kSplitKeys;
  p.splits = cdiv(M * bs, p.split_keys);
  p.box = box_keys(bs);
  p.items = static_cast<long long>(B) * p.tiles * p.splits;
  p.units = p.items * KV;
  return p;
}

// blocks of a launch: its work units at most, at most `wave` (the blocks
// the card holds at once)
PAGED_TILES_FN int work_blocks(const Plan& p, int wave) {
  const long long w = wave > 0 ? wave : 1;
  return static_cast<int>(p.units < w ? p.units : w);
}

// the shapes the kernel refuses: bs not a positive multiple of 8, a head
// count that does not group, more keys than an int indexes, more work
// units than an int indexes
PAGED_TILES_FN bool bad_shape(int B, int W, int H, int KV, int bs, int M,
                              int N) {
  if (B <= 0 || W <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 ||
      bs % 8 != 0 || M <= 0 || N <= 0)
    return true;
  if (static_cast<long long>(M) * bs >= (1LL << 30) ||
      static_cast<long long>(N) * bs >= (1LL << 30))
    return true;
  const Plan p = plan(B, W, H, KV, bs, M);
  return p.units > kMaxUnits;
}

// the last key any row of the tile sees (its last real row's position),
// kept inside the table: [0, M * bs - 1]
PAGED_TILES_FN int tile_frontier(int pos, int tile, int rows, int rep,
                                 int M, int bs) {
  const int last = imin((tile + 1) * kRows, rows) - 1;
  return imax(0, imin(pos + last / rep, M * bs - 1));
}

// the last key row rr sees (may be below 0 or past the table: the mask
// then hides every key, or none of the table's)
PAGED_TILES_FN int row_frontier(int pos, int rr, int rep) {
  return pos + rr / rep;
}

// splits a tile walks at ks keys a split: those that hold a key up to its
// frontier (from 1 to p.splits, as ks >= p.split_keys)
PAGED_TILES_FN int tile_splits(int frontier, int ks) {
  return frontier / ks + 1;
}

// The keys a split takes at `keys` keys to walk in a launch: the fewest,
// or enough, in whole stages, that the units of every KV head come to about
// `wave` (the blocks the card holds at once)
PAGED_TILES_FN int split_keys_for(long long keys, int KV, const Plan& p,
                                  int wave) {
  const long long w = wave > 0 ? wave : 1;
  const long long per = (keys * KV + w - 1) / w;
  const long long ks = (per + kStageKeys - 1) / kStageKeys * kStageKeys;
  return ks > p.split_keys ? static_cast<int>(ks) : p.split_keys;
}

// The keys a split of a row takes: split_keys_for over the keys a row as
// long as the table (M bs) walks in its tiles, times ceil(B / 2), as if
// half the rows of the launch were that long. A function of the launch's
// shapes alone — not of the row's position — and the same for every W
// whose query rows fill one tile (W rep <= 64: a decode tick and a verify
// window), so a key falls in the same split, at the same place in it, in
// a decode tick as in a verify window: a query's sums round alike in both
// (the splits start at key 0).
PAGED_TILES_FN int row_split_keys(int pos, int B, int KV, int rep, int M,
                                  int bs, const Plan& p, int wave) {
  (void)pos;
  (void)rep;
  const long long keys = static_cast<long long>(p.tiles) * M * bs;
  return split_keys_for(keys * ((B + 1) / 2), KV, p, wave);
}

// splits tile t of a row at position `pos` walks, at its row's keys a split
PAGED_TILES_FN int row_tile_splits(int pos, int t, int B, int KV, int rep,
                                   int M, int bs, const Plan& p, int wave) {
  return tile_splits(tile_frontier(pos, t, p.rows, rep, M, bs),
                     row_split_keys(pos, B, KV, rep, M, bs, p, wave));
}

// the keys [begin, end) that split s of a tile walks
struct Keys {
  int begin, end;
};
PAGED_TILES_FN Keys split_keys(int s, int frontier, int ks) {
  const int b = s * ks;
  return Keys{b, imin(b + ks, frontier + 1)};
}

// ring stages a split walks
PAGED_TILES_FN int split_stages(Keys k) {
  return k.end > k.begin ? cdiv(k.end - k.begin, kStageKeys) : 0;
}

// whether the box of keys [key, key + box) is loaded from the pool (its
// first key is one that some row of the tile sees); its table entry is
// key / bs and its first slot key % bs
PAGED_TILES_FN bool box_loaded(int key, int frontier) {
  return key <= frontier;
}

// The work units of the launch: its items (the tiles' splits at their
// rows' keys a split, summed) times KV (the sequential definition; the
// kernel sums with a warp)
template <typename PosFn>
PAGED_TILES_FN long long launch_units(int B, int KV, int rep, int M, int bs,
                                      const Plan& p, int wave, PosFn pos) {
  long long items = 0;
  for (int b = 0; b < B; ++b)
    for (int t = 0; t < p.tiles; ++t)
      items += row_tile_splits(pos(b), t, B, KV, rep, M, bs, p, wave);
  return items * KV;
}

// Work unit i: its item (b, tile, split) and KV head, from the tiles'
// split counts (the sequential definition; the kernel computes the same
// with a warp scan). Returns false past the last unit.
struct Item {
  int b, tile, split, g;
};
template <typename PosFn>
PAGED_TILES_FN bool item_of(long long i, int B, int KV, int rep, int M,
                            int bs, const Plan& p, int wave, PosFn pos,
                            Item* out) {
  long long item = i / KV;
  for (int b = 0; b < B; ++b)
    for (int t = 0; t < p.tiles; ++t) {
      const int n = row_tile_splits(pos(b), t, B, KV, rep, M, bs, p, wave);
      if (item < n) {
        *out = Item{b, t, static_cast<int>(item), static_cast<int>(i % KV)};
        return true;
      }
      item -= n;
    }
  return false;
}

// whether the tile's blocks write the output themselves (one split), or
// the combine merges splits 0 .. n - 1 of the workspace
PAGED_TILES_FN bool writes_direct(int n) { return n == 1; }

// Unit L of a launch of `units` units in the schedule's order, as its
// number in the plan's own order (KV head fastest): order 0 is the plan's
// numbering, order 1 takes the KV head slowest. A permutation of [0,
// units).
PAGED_TILES_FN long long order_unit(long long L, int KV, long long units,
                                    int order) {
  if (order == 0) return L;
  const long long items = units / KV;
  return (L % items) * KV + L / items;
}

// The shared memory of a block, every region 1024-byte aligned from a
// 1024-aligned base: the Q tile; for an int8 pool the bf16 pair the
// consumers widen each stage's codes into; the ring (fp: K and V bf16
// tiles; int8: K and V codes, 128 bytes a key, then each key's k- and
// v-scale); the barriers (full, empty), and room to align the base.
// `depth` multiplies the ring's stages: 2 (fp) or 3 (int8) at depth 1.
struct Layout {
  int stages;      // ring stages
  int q;           // the Q tile's bytes (at offset 0)
  int conv;        // int8: the widened pair's bytes (at offset q)
  int ring;        // the ring's offset
  int stage;       // a ring stage's bytes
  int scale_off;   // the scales' offset
  int scales;      // a stage's scale bytes
  int bars;        // the barriers' offset
  int bytes;       // the layout's end
  int alloc;       // bytes to allocate: the layout and the base's alignment
};
PAGED_TILES_FN constexpr Layout layout(bool quant, int depth) {
  Layout l{};
  const int tile = kRows * kHeadDim * 2;  // a K or V tile of 64 keys, bf16
  const int codes = kStageKeys * kHeadDim;
  l.stages = (quant ? 3 : 2) * depth;
  l.q = kRows * kHeadDim * 2;
  l.conv = quant ? 2 * tile : 0;
  l.ring = l.q + l.conv;
  l.stage = quant ? 2 * codes : 2 * tile;
  l.scales = quant ? 2 * kStageKeys * 4 : 0;
  l.scale_off = l.ring + l.stages * l.stage;
  l.bars = l.scale_off + l.stages * l.scales;
  l.bytes = l.bars + 8 * 2 * l.stages;
  l.alloc = l.bytes + 1024;
  return l;
}

// whether a block of this layout fits a Hopper SM (the depths the
// autotuner may sweep)
PAGED_TILES_FN constexpr bool layout_fits(bool quant, int depth) {
  return depth >= 1 && layout(quant, depth).alloc <= kSmemOptIn;
}

}  // namespace paged_tiles

#undef PAGED_TILES_FN
