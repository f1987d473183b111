"""The tile schedule of the flash kernels
(``paddle_tpu_torch/ops/csrc/flash_tiles.cuh``), the part of
``flash_attention.cu`` and ``flash_attention_bwd.cu`` a host compiler can
build: a small harness around the header, compiled with ``g++``, prints
which tiles each forward, dQ and dK/dV block visits and which of them it
masks, and the forward's launch order; the test holds that against the
port's own mask, ``ops/flash_attention.py::_visible``.

Every visible (row, key) pair must lie in a visited tile, the first and last
visited tiles must hold a visible pair (the frontier is tight), and a tile
must run the mask exactly when it holds a pair that is not visible (a key
past the causal frontier, a row past Sq or a key past Sk). The forward's
frontier is tight for each of its two warpgroups, and its launch order
visits every (query tile, head, batch) once, by falling work. The
grid covers Sq < Sk down to one query row and Sq > Sk (rows that see no
key), ragged edges at 64 and 128 (129 across the forward's 128-row block),
and S up to 32768, with the kernels' tile sizes and another split."""
import functools
import shutil
import subprocess

import numpy as np
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
// fwd_sizes                    -> the forward's rows a block, keys a stage
// dq  Sq Sk causal rows keys   -> per block: q0 nk, then a 0/1 mask flag
//                                 per (warpgroup, key tile)
// dkv Sq Sk causal keys rows   -> per block: k0 first, then a flag per
//                                 (warpgroup, query tile from first on)
// fwd Sq Sk causal             -> per block: q0 nk, then per warpgroup its
//                                 tiles nw and a flag per key tile below nw
// order tiles H Hkv B causal   -> the grid's blocks, then (q0 h b) per
//                                 block in launch order
int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "sizes")) {
    printf("%d %d %d %d %d\n", ft::kWgRows, ft::kDqRows, ft::kDqKeys,
           ft::kDkvKeys, ft::kDkvRows);
    return 0;
  }
  if (argc == 2 && !strcmp(argv[1], "fwd_sizes")) {
    printf("%d %d\n", ft::kFwdRows, ft::kFwdKeys);
    return 0;
  }
  if (argc == 5 && !strcmp(argv[1], "fwd")) {
    const int Sq = atoi(argv[2]), Sk = atoi(argv[3]), causal = atoi(argv[4]);
    const int wg = ft::kWgRows, bk = ft::kFwdKeys;
    for (int q0 = 0; q0 < Sq; q0 += ft::kFwdRows) {
      printf("%d %d", q0, ft::dq_key_tiles(q0, ft::kFwdRows, bk, Sq, Sk,
                                           causal));
      for (int w = 0; w < ft::kFwdRows / wg; ++w) {
        const int r0 = q0 + w * wg;
        const int nw = ft::dq_key_tiles(r0, wg, bk, Sq, Sk, causal);
        printf(" %d ", nw);
        putchar('.');   // so that a warpgroup with no tile prints a field
        for (int j = 0; j < nw; ++j)
          putchar('0' + ft::tile_needs_mask(r0, wg, j * bk, bk, Sq, Sk,
                                            causal));
      }
      putchar('\n');
    }
    return 0;
  }
  if (argc == 7 && !strcmp(argv[1], "order")) {
    const int tiles = atoi(argv[2]), H = atoi(argv[3]), Hkv = atoi(argv[4]);
    const int B = atoi(argv[5]), causal = atoi(argv[6]);
    const int n = ft::fwd_blocks(tiles, H, B);
    printf("%d\n", n);
    for (int i = 0; i < n; ++i) {
      const ft::FwdBlock b = ft::fwd_block(i, tiles, H, Hkv, B, causal);
      printf("%d %d %d\n", b.q0, b.h, b.b);
    }
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

# (Sq, Sk): square, ragged at 64 and 128, Sq < Sk (bottom-right alignment,
# down to a single query row), Sq > Sk (the first rows see no key), one
# tile, 129 across the forward's 128-row block, and the long-context
# lengths (the stream rows' ragged case, 16384 and 32768)
SHAPES = [(64, 64), (1, 1), (63, 65), (128, 128), (130, 130), (200, 200),
          (200, 130), (130, 200), (300, 1000), (1000, 300), (2048, 2048),
          (8192 + 64, 16384 + 64), (16384, 16384), (32768, 32768),
          (1, 1000), (129, 129)]
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


@functools.lru_cache(maxsize=None)
def _tables(Sq, Sk, causal):
    """(any, full) bool (ceil(Sq/64), ceil(Sk/64)) numpy arrays: whether a
    64 x 64 tile holds a visible pair, and whether all of its 64 x 64
    pairs are visible (a tile past Sq or Sk never is), from ``_visible``
    at each tile's first and last rows. The causal frontier only moves
    right down the rows: the tile's last row sees every key any of its
    rows sees, its first row only keys that all of them see. Each
    (Sq, Sk, causal) is built once for all the tests that read it."""
    nr, nk = -(-Sq // T), -(-Sk // T)
    any_ = np.zeros((nr, nk), dtype=bool)
    full = np.zeros((nr, nk), dtype=bool)
    for t in range(nr):
        q0, q1 = t * T, min(t * T + T, Sq)
        edge = []
        for r in (q0, q1 - 1):                 # the first and last rows
            vis = (tfa._visible(r, r + 1, Sq, Sk, "cpu")[0] if causal
                   else torch.ones(Sk, dtype=torch.bool))
            pad = np.zeros(nk * T, dtype=bool)
            pad[:Sk] = vis.numpy()
            edge.append(pad.reshape(nk, T))
        any_[t] = edge[1].any(1)
        # a tile with rows past Sq holds pairs that are not visible
        full[t] = edge[0].all(1) & (q1 - q0 == T)
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


def test_the_forward_tile_sizes(harness):
    """A forward block is two consumer warpgroups of 64 rows; a stage
    holds whole 64-key tiles."""
    rows, keys = map(int, harness("fwd_sizes")[0])
    assert rows == 128 and keys % 64 == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"Sq{s[0]}_Sk{s[1]}")
def test_forward_tiles_cover_visible_pairs_and_mask_exactly(harness, shape,
                                                            causal):
    """Each forward warpgroup computes key tiles 0 .. nw - 1 of its 64
    rows: every visible pair lies below its frontier, its last tile holds
    one (nw = 0 where its rows see none or lie past Sq), and it masks a
    tile exactly when the tile hides a pair; the block streams as many
    tiles as its busiest warpgroup needs."""
    Sq, Sk = shape
    rows, keys = map(int, harness("fwd_sizes")[0])
    any_, full = _tables(Sq, Sk, causal)
    nr, nk = any_.shape
    wg = 64
    blocks = harness("fwd", Sq, Sk, int(causal))
    assert [int(b[0]) for b in blocks] == list(range(0, Sq, rows))
    for b in blocks:
        q0, n = int(b[0]), int(b[1])
        groups = [(int(b[2 + 2 * w]), b[3 + 2 * w][1:])
                  for w in range(rows // wg)]
        assert n == max(nw for nw, _ in groups), (q0, n, groups)
        for w, (nw, flags) in enumerate(groups):
            r = q0 // T + w                       # the warpgroup's 64 rows
            assert len(flags) == nw
            if r >= nr:
                assert nw == 0, (q0, w, nw, "rows past Sq compute")
                continue
            seen = any_[r]                        # 64-key tiles with a pair
            visited = min(nw * keys // T, nk)
            assert not seen[visited:].any(), (q0, w, nw, "a key is skipped")
            if seen.any():
                assert nw > 0 and seen[(nw - 1) * keys // T:visited].any(), \
                    (q0, w, nw, "the last key tile holds no visible pair")
            else:
                assert nw == 0, (q0, w, nw)
            for j in range(nw):
                ks = slice(j * keys // T, (j + 1) * keys // T)
                whole = ks.stop <= nk and bool(full[r, ks].all())
                assert flags[j] == ("0" if whole else "1"), (q0, w, j)


# (query tiles, H, Hkv, B): the training grid (GQA 4), S = 8192, Sq = 384,
# long context at S = 16384 and 32768, ERNIE at S = 512 and 128 (MHA,
# B = 32), one tile of MQA, a single head of three batches, and a small
# grid of two KV heads
ORDERS = [(16, 32, 8, 2), (64, 32, 8, 1), (3, 32, 8, 2), (128, 32, 8, 1),
          (256, 32, 8, 1), (4, 12, 12, 32), (1, 12, 12, 32), (1, 4, 1, 3),
          (3, 1, 1, 3), (3, 4, 2, 2)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("grid", ORDERS, ids=lambda g: "_".join(map(str, g)))
def test_forward_launch_order_visits_every_block_once(harness, grid, causal):
    """The forward's grid visits each (query tile, head, batch) once, in
    order of falling work: causal, the query tiles from the heaviest (the
    last) down, each tile's step taking every head of every batch, heads
    fastest; without the mask, one (batch, KV head)'s blocks adjacent, its
    query heads fastest, then its tiles."""
    tiles, H, Hkv, B = grid
    out = harness("order", tiles, H, Hkv, B, int(causal))
    seq = [tuple(map(int, line)) for line in out[1:]]
    assert len(seq) == int(out[0][0]) == tiles * H * B
    rep = H // Hkv
    if causal:
        want = [((tiles - 1 - t) * 128, h, b) for t in range(tiles)
                for b in range(B) for h in range(H)]
    else:
        want = [(t * 128, kv * rep + r, b) for b in range(B)
                for kv in range(Hkv) for t in range(tiles)
                for r in range(rep)]
    assert seq == want
