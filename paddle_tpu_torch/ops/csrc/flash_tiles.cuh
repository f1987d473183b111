// Tile schedule of the flash kernels (flash_attention.cu, the forward;
// flash_attention_bwd.cu, the backward pair): which tiles a block visits,
// which of them need the mask, the forward's launch order, and the shapes
// the flash entry points take. Plain C++,
// so that a host compiler can build it into a test harness
// (tests/test_torch_flash_tiles.py); under nvcc the functions are
// __host__ __device__.
//
// Causal masks align bottom-right: query row i sees key j iff
// j <= i + Sk - Sq (and every key without the causal mask). Rows at or past
// Sq and keys at or past Sk lie in a ragged last tile, which TMA fills with
// zeros; they are masked too. Indices stay below 2^31: Sq, Sk < 2^31 / D.
#pragma once

#if defined(__CUDACC__)
#define FLASH_TILES_FN __host__ __device__ __forceinline__
#else
#define FLASH_TILES_FN inline
#endif

namespace flash_tiles {

// rows (queries or keys) a consumer warpgroup owns: one wgmma M tile
constexpr int kWgRows = 64;
// dQ: query rows a block owns (two consumer warpgroups), keys a ring stage
constexpr int kDqRows = 2 * kWgRows;
constexpr int kDqKeys = 64;
// dK/dV: keys a block owns (two consumer warpgroups), query rows a stage
constexpr int kDkvKeys = 2 * kWgRows;
constexpr int kDkvRows = 64;
// forward: query rows a block owns (two consumer warpgroups), keys a ring
// stage (one m64n128 product per warpgroup for S)
constexpr int kFwdRows = 2 * kWgRows;
constexpr int kFwdKeys = 128;

FLASH_TILES_FN int cdiv(int a, int b) { return (a + b - 1) / b; }

// the shapes the flash entry points refuse (the grids' y and z extents
// stop at 65535)
FLASH_TILES_FN bool bad_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 ||
         H % Hkv != 0 || B > 65535 || H > 65535;
}

// dQ and the forward: the number of `bk`-key tiles the query rows
// [q0, q0 + rows) need: up to the causal frontier of their last row (0 if
// no row sees a key, or none lies below Sq)
FLASH_TILES_FN int dq_key_tiles(int q0, int rows, int bk, int Sq, int Sk,
                                int causal) {
  if (q0 >= Sq) return 0;
  const int n = cdiv(Sk, bk);
  if (!causal) return n;
  const int last_row = (q0 + rows < Sq ? q0 + rows : Sq) - 1;
  const int last_key = last_row + (Sk - Sq);
  if (last_key < 0) return 0;
  const int need = last_key / bk + 1;
  return need < n ? need : n;
}

// dK/dV: the first `bq`-row query tile that sees key k0 (the number of
// query tiles, cdiv(Sq, bq), if none does)
FLASH_TILES_FN int dkv_first_qtile(int k0, int bq, int Sq, int Sk,
                                   int causal) {
  if (!causal) return 0;
  const int first_row = k0 - (Sk - Sq);   // the first row that sees k0
  if (first_row >= Sq) return cdiv(Sq, bq);
  return (first_row > 0 ? first_row : 0) / bq;
}

// whether the tile of rows [r0, r0 + nr) x keys [k0, k0 + nk) holds a pair
// that is not visible: a row past Sq, a key past Sk, or (causal) a key past
// a row's frontier, the worst being the last key against the first row
FLASH_TILES_FN bool tile_needs_mask(int r0, int nr, int k0, int nk, int Sq,
                                    int Sk, int causal) {
  if (r0 + nr > Sq || k0 + nk > Sk) return true;
  return causal && k0 + nk - 1 > r0 + (Sk - Sq);
}

// Forward launch order: a 1-D grid of tiles * H * B blocks, each one
// (128-row query tile, query head, batch), in order of falling work, and
// among blocks of equal work those that read one (batch, KV head)'s K/V
// adjacent, its query heads fastest. Under the causal mask the last query
// tile sees the most keys, so the tiles go from the last down, every head
// of every batch at each step; without it every tile has the same work,
// and one (batch, KV head)'s tiles run together, so that their K/V reads
// hit the L2.
struct FwdBlock {
  int q0, h, b;
};

FLASH_TILES_FN int fwd_blocks(int tiles, int H, int B) {
  return tiles * H * B;
}

FLASH_TILES_FN FwdBlock fwd_block(int i, int tiles, int H, int Hkv, int B,
                                  int causal) {
  const int rep = H / Hkv;
  if (causal) {
    const int hb = i / H;
    return FwdBlock{(tiles - 1 - hb / B) * kFwdRows, i % H, hb % B};
  }
  const int gt = i / rep, g = gt / tiles;   // g = b * Hkv + KV head
  return FwdBlock{(gt % tiles) * kFwdRows, (g % Hkv) * rep + i % rep,
                  g / Hkv};
}

}  // namespace flash_tiles

#undef FLASH_TILES_FN
