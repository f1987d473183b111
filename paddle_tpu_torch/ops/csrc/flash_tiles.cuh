// Tile schedule of the flash backward kernels (flash_attention_bwd.cu):
// which tiles a block visits and which of them need the mask, and the
// shapes the flash entry points take. Plain C++,
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

FLASH_TILES_FN int cdiv(int a, int b) { return (a + b - 1) / b; }

// the shapes the flash entry points refuse (the grids' y and z extents
// stop at 65535)
FLASH_TILES_FN bool bad_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 ||
         H % Hkv != 0 || B > 65535 || H > 65535;
}

// dQ: the number of `bk`-key tiles the query rows [q0, q0 + rows) need:
// up to the causal frontier of their last row (0 if no row sees a key)
FLASH_TILES_FN int dq_key_tiles(int q0, int rows, int bk, int Sq, int Sk,
                                int causal) {
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

}  // namespace flash_tiles

#undef FLASH_TILES_FN
