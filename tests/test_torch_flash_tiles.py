"""The tile schedule of the flash backward kernels
(``paddle_tpu_torch/ops/csrc/flash_tiles.cuh``), the part of
``flash_attention_bwd.cu`` a host compiler can build: a small harness
around the header, compiled with ``g++``, prints which tiles each dQ and
dK/dV block visits and which of them it masks; the test holds that against
the port's own mask, ``ops/flash_attention.py::_visible``.

Every visible (row, key) pair must lie in a visited tile, the first and last
visited tiles must hold a visible pair (the frontier is tight), and a tile
must run the mask exactly when it holds a pair that is not visible (a key
past the causal frontier, a row past Sq or a key past Sk). The grid covers
Sq < Sk and Sq > Sk (rows that see no key), ragged edges at 64 and 128, and
S up to 32768, with the kernels' tile sizes and another split."""
import shutil
import subprocess

import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include "flash_tiles.cuh"
namespace ft = flash_tiles;

// sizes                        -> the kernels' tile sizes
// dq  Sq Sk causal rows keys   -> per block: q0 nk, then a 0/1 mask flag
//                                 per (warpgroup, key tile)
// dkv Sq Sk causal keys rows   -> per block: k0 first, then a flag per
//                                 (warpgroup, query tile from first on)
int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "sizes")) {
    printf("%d %d %d %d %d\n", ft::kWgRows, ft::kDqRows, ft::kDqKeys,
           ft::kDkvKeys, ft::kDkvRows);
    return 0;
  }
  if (argc != 7) return 2;
  const int Sq = atoi(argv[2]), Sk = atoi(argv[3]), causal = atoi(argv[4]);
  const int block = atoi(argv[5]), stage = atoi(argv[6]);
  const int wg = ft::kWgRows;
  if (!strcmp(argv[1], "dq")) {
    for (int q0 = 0; q0 < Sq; q0 += block) {
      const int nk = ft::dq_key_tiles(q0, block, stage, Sq, Sk, causal);
      printf("%d %d ", q0, nk);
      for (int w = 0; w < block / wg; ++w)
        for (int j = 0; j < nk; ++j)
          putchar('0' + ft::tile_needs_mask(q0 + w * wg, wg, j * stage,
                                            stage, Sq, Sk, causal));
      putchar('\n');
    }
  } else {
    const int nq = ft::cdiv(Sq, stage);
    for (int k0 = 0; k0 < Sk; k0 += block) {
      const int first = ft::dkv_first_qtile(k0, stage, Sq, Sk, causal);
      printf("%d %d ", k0, first);
      for (int w = 0; w < block / wg; ++w)
        for (int qt = first; qt < nq; ++qt)
          putchar('0' + ft::tile_needs_mask(qt * stage, stage, k0 + w * wg,
                                            wg, Sq, Sk, causal));
      putchar('\n');
    }
  }
  return 0;
}
"""

# (Sq, Sk): square, ragged at 64 and 128, Sq < Sk (bottom-right alignment),
# Sq > Sk (the first rows see no key), one tile, and the long-context
# lengths (the stream rows' ragged case, 16384 and 32768)
SHAPES = [(64, 64), (1, 1), (63, 65), (128, 128), (130, 130), (200, 200),
          (200, 130), (130, 200), (300, 1000), (1000, 300), (2048, 2048),
          (8192 + 64, 16384 + 64), (16384, 16384), (32768, 32768)]
# (dQ rows a block, keys a stage), (dK/dV keys a block, rows a stage): the
# kernels' sizes, read from the header, and a second split
SPLITS = ["kernels", (64, 128, 64, 128)]
T = 64   # the tables' granularity: every tile is a multiple of 64


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the tile-schedule harness")
    d = tmp_path_factory.mktemp("flash_tiles")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    f"-I{_build.CSRC}", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(*args):
        out = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True).stdout
        return [line.split() for line in out.splitlines()]
    return run


def _tables(Sq, Sk, causal):
    """(any, full) bool (ceil(Sq/64), ceil(Sk/64)): whether a 64 x 64 tile
    holds a visible pair, and whether all of its 64 x 64 pairs are visible
    (a tile past Sq or Sk never is), from ``_visible``."""
    nr, nk = -(-Sq // T), -(-Sk // T)
    any_ = torch.zeros(nr, nk, dtype=torch.bool)
    full = torch.zeros(nr, nk, dtype=torch.bool)
    for t in range(nr):
        q0, q1 = t * T, min(t * T + T, Sq)
        vis = (tfa._visible(q0, q1, Sq, Sk, "cpu") if causal
               else torch.ones(q1 - q0, Sk, dtype=torch.bool))
        pad = torch.zeros(T, nk * T, dtype=torch.bool)
        pad[:q1 - q0, :Sk] = vis
        tiles = pad.reshape(T, nk, T)
        any_[t] = tiles.any(2).any(0)
        full[t] = tiles.all(2).all(0)
    return any_, full


def _split(harness, split):
    if split == "kernels":
        return tuple(int(x) for x in harness("sizes")[0][1:])
    return split


def test_the_kernels_tile_sizes(harness):
    """Each consumer warpgroup owns one wgmma M tile of 64 rows; a block
    two of them."""
    wg, dq_rows, dq_keys, dkv_keys, dkv_rows = map(int, harness("sizes")[0])
    assert wg == 64 and dq_rows == dkv_keys == 2 * wg
    assert dq_keys % 64 == 0 and dkv_rows % 64 == 0


@pytest.mark.parametrize("split", SPLITS, ids=["kernels", "alt"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"Sq{s[0]}_Sk{s[1]}")
def test_tiles_cover_visible_pairs_and_mask_exactly(harness, shape, causal,
                                                    split):
    Sq, Sk = shape
    dq_rows, dq_keys, dkv_keys, dkv_rows = _split(harness, split)
    any_, full = _tables(Sq, Sk, causal)
    nr, nk = any_.shape
    wg = 64

    # dQ: a block of dq_rows query rows walks key tiles 0 .. n - 1
    blocks = harness("dq", Sq, Sk, int(causal), dq_rows, dq_keys)
    assert [int(b[0]) for b in blocks] == list(range(0, Sq, dq_rows))
    for b in blocks:
        q0, n = int(b[0]), int(b[1])
        flags = b[2] if len(b) > 2 else ""
        rt = slice(q0 // T, min((q0 + dq_rows) // T, nr))
        seen = any_[rt].any(0)                 # key tiles of 64 with a pair
        visited = min(n * dq_keys // T, nk)
        assert not seen[visited:].any(), (q0, n, "a visible key is skipped")
        if seen.any():
            assert n > 0 and seen[(n - 1) * dq_keys // T:visited].any(), \
                (q0, n, "the last key tile holds no visible pair")
        else:
            assert n == 0, (q0, n)
        assert len(flags) == dq_rows // wg * n
        for w in range(dq_rows // wg):
            r = q0 // T + w
            for j in range(n):
                ks = slice(j * dq_keys // T, (j + 1) * dq_keys // T)
                whole = r < nr and ks.stop <= nk and bool(full[r, ks].all())
                assert flags[w * n + j] == ("0" if whole else "1"), \
                    (q0, w, j, flags[w * n + j])

    # dK/dV: a block of dkv_keys keys walks query tiles first .. nq - 1
    nq = -(-Sq // dkv_rows)
    blocks = harness("dkv", Sq, Sk, int(causal), dkv_keys, dkv_rows)
    assert [int(b[0]) for b in blocks] == list(range(0, Sk, dkv_keys))
    for b in blocks:
        k0, first = int(b[0]), int(b[1])
        flags = b[2] if len(b) > 2 else ""
        kt = slice(k0 // T, min((k0 + dkv_keys) // T, nk))
        seen = any_[:, kt].any(1)              # query tiles of 64 with a pair
        assert not seen[:first * dkv_rows // T].any(), \
            (k0, first, "a visible row is skipped")
        if seen.any():
            assert first < nq and \
                seen[first * dkv_rows // T:(first + 1) * dkv_rows // T].any(), \
                (k0, first, "the first query tile holds no visible pair")
        else:
            assert first == nq, (k0, first)
        per = nq - first
        assert len(flags) == dkv_keys // wg * per
        for w in range(dkv_keys // wg):
            c = k0 // T + w
            for i, qt in enumerate(range(first, nq)):
                rs = slice(qt * dkv_rows // T, (qt + 1) * dkv_rows // T)
                whole = c < nk and rs.stop <= nr and bool(full[rs, c].all())
                assert flags[w * per + i] == ("0" if whole else "1"), \
                    (k0, w, qt, flags[w * per + i])
