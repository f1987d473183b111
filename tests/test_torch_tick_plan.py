"""The whole-tick decode kernel's work plan (``ops/csrc/tick_plan.cuh``),
built with g++ into a harness: every weight tile of every product phase
streamed exactly once, byte shares that differ by at most one tile, the
producer's walk equal to the consumers' fragments, each block's x inside
the slab, the K-split reduction's slots and arrival counts, the shared-
memory budget and the barriers a tick; and a CPU model of the K-split sum
in the plan's order against a plain matmul."""
import shutil
import subprocess

import numpy as np
import pytest

from paddle_tpu_torch.ops import _build

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <tuple>
#include <vector>
#include "tick_plan.cuh"
namespace tp = tick_plan;

// the weights' (K, N) of a layer: q k v o gate up down
static void wdims(const tp::Dims& d, int w, int* K, int* N) {
  const int kvd = d.kv * tp::kHeadDim;
  const int Ks[7] = {d.hid, d.hid, d.hid, d.hid, d.hid, d.hid, d.inter};
  const int Ns[7] = {d.hid, kvd, kvd, d.hid, d.inter, d.inter, d.hid};
  *K = Ks[w];
  *N = Ns[w];
}

int main(int argc, char** argv) {
  const char* cmd = argv[1];
  if (!strcmp(cmd, "budget")) {
    printf("%d %d %d %d %d %d\n", tp::kSmemBytes, tp::kSmemLimit, tp::kStages,
           tp::kUnitBytes, tp::kRingBytes, tp::kUnionBytes);
    return 0;
  }
  if (!strcmp(cmd, "barriers")) {
    printf("%d\n", tp::barriers(atoi(argv[2]), atoi(argv[3])));
    return 0;
  }
  const tp::Dims d{atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), atoi(argv[5])};
  const int NB = atoi(argv[6]);
  if (!strcmp(cmd, "fits")) {
    printf("%d\n", tp::fits(d, NB) ? 1 : 0);
    return 0;
  }
  if (!strcmp(cmd, "sizes")) {
    printf("%lld %d\n", tp::scratch_floats(d, NB), tp::max_groups(d));
    return 0;
  }
  if (!strcmp(cmd, "check")) {
    // per phase: G T S klen nr, tile faults (a tile streamed other than
    // once, or outside the weight), walk mismatches (producer against
    // consumers, or a fragment outside its slice), the fewest and most
    // units a block, the most K steps of x staged at once and the slab's K
    // steps, slot faults (a fragment's
    // slot shared or out of range), count faults (a group's fragments
    // other than group_frags), order faults (the reduction's walk of a
    // group visiting other than its fragments, once each)
    for (int ph = 0; ph < tp::kProductPhases; ++ph) {
      const tp::PhasePlan p = tp::plan(d, ph, NB);
      std::map<std::tuple<int, int, int>, int> seen;
      std::set<int> slots_used;
      std::map<int, std::set<std::pair<int, int>>> group_frags;
      long long tile_faults = 0, walk = 0, slot_faults = 0;
      long long umin = -1, umax = 0;
      int kmax = 0;
      for (int b = 0; b < NB; ++b) {
        const int u0 = tp::block_start(p, b), u1 = tp::block_start(p, b + 1);
        const long long n = u1 - u0;
        if (umin < 0 || n < umin) umin = n;
        if (n > umax) umax = n;
        std::vector<std::pair<int, int>> prod, cons;
        for (int u = u0; u < u1; ++u) {
          int item, t, w, n0, K, N;
          tp::unit(p, u, &item, &t);
          if (tp::block_of(p, u) != b) ++walk;
          prod.push_back({item, t});
          tp::columns(d, ph, tp::item_group(p, item), tp::item_col(item), &w, &n0);
          wdims(d, w, &K, &N);
          if (n0 < 0 || n0 + tp::kColBlock > N || t < 0 ||
              (t + 1) * tp::kKStep > K)
            ++tile_faults;
          ++seen[{w, n0, t}];
        }
        int u = u0;
        while (u < u1) {
          const tp::Frag f = tp::next_frag(p, &u, u1);
          for (int k = 0; k < f.n; ++k) cons.push_back({f.item, f.t0 + k});
          // the fragment's x lies in its slice, which the slab holds
          int k0, k1;
          tp::slice_steps(p, tp::item_slice(p, f.item), &k0, &k1);
          if (k1 - k0 > kmax) kmax = k1 - k0;
          if (f.n < 1 || f.t0 < k0 || f.t0 + f.n > k1) ++walk;
          const int s = tp::slot(f.item, b);
          if (s < 0 || s >= tp::slots(p) || !slots_used.insert(s).second)
            ++slot_faults;
          group_frags[tp::item_group(p, f.item)].insert({f.item, b});
        }
        if (prod != cons) ++walk;
      }
      // every tile of the phase's weights once
      const int ws[4][3] = {{0, 1, 2}, {3, -1, -1}, {4, 5, -1}, {6, -1, -1}};
      long long want = 0;
      for (int i = 0; i < 3; ++i) {
        const int w = ws[ph][i];
        if (w < 0) continue;
        int K, N;
        wdims(d, w, &K, &N);
        want += (long long)(K / tp::kKStep) * (N / tp::kColBlock);
        for (int t = 0; t < K / tp::kKStep; ++t)
          for (int n0 = 0; n0 < N; n0 += tp::kColBlock) {
            auto it = seen.find({w, n0, t});
            if (it == seen.end() || it->second != 1) ++tile_faults;
          }
      }
      if ((long long)seen.size() != want) ++tile_faults;
      long long count_faults = 0, order_faults = 0;
      for (int g = 0; g < p.G; ++g) {
        const auto& fr = group_frags[g];
        if ((int)fr.size() != tp::group_frags(p, g)) ++count_faults;
        std::set<std::pair<int, int>> visit;
        for (int c = 0; c < 2; ++c)
          for (int s = 0; s < p.S; ++s) {
            const int i = tp::item_of(p, s, g, c);
            int b0, b1;
            tp::item_blocks(p, i, &b0, &b1);
            for (int b = b0; b <= b1; ++b)
              if (tp::streams(p, b) && !visit.insert({i, b}).second)
                ++order_faults;
          }
        if (visit != fr) ++order_faults;
      }
      printf("%d %d %d %d %d %lld %lld %lld %lld %d %d %lld %lld %lld\n", p.G,
             p.T, p.S, p.klen, p.nr, tile_faults, walk, umin, umax, kmax,
             tp::slab_steps(p.nr), slot_faults, count_faults, order_faults);
    }
    return 0;
  }
  if (!strcmp(cmd, "frags")) {
    // phase ph: every block's fragments (block item t0 n), then the
    // reduction's walk of every group (group c slice block slot)
    const int ph = atoi(argv[7]);
    const tp::PhasePlan p = tp::plan(d, ph, NB);
    printf("P %d %d %d %d\n", p.G, p.T, p.S, p.klen);
    for (int b = 0; b < NB; ++b) {
      int u = tp::block_start(p, b);
      const int u1 = tp::block_start(p, b + 1);
      while (u < u1) {
        const tp::Frag f = tp::next_frag(p, &u, u1);
        int w, n0;
        tp::columns(d, ph, tp::item_group(p, f.item), tp::item_col(f.item), &w,
                    &n0);
        printf("F %d %d %d %d %d %d\n", b, f.item, f.t0, f.n, w, n0);
      }
    }
    for (int g = 0; g < p.G; ++g)
      for (int c = 0; c < 2; ++c)
        for (int s = 0; s < p.S; ++s) {
          const int i = tp::item_of(p, s, g, c);
          int b0, b1;
          tp::item_blocks(p, i, &b0, &b1);
          for (int b = b0; b <= b1; ++b)
            if (tp::streams(p, b))
              printf("R %d %d %d %d %d\n", g, c, s, b, tp::slot(i, b));
        }
    return 0;
  }
  return 1;
}
"""

LLAMA = (4096, 8, 14336)        # Llama-3-8B: hidden, KV heads, intermediate
SMALL = [(256, 1, 256), (512, 2, 768), (384, 3, 320)]
ROWS = (1, 8, 32, 64)
GRID = 132                      # one block per SM of an H100


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the tick plan harness")
    d = tmp_path_factory.mktemp("tick_plan")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror",
                    f"-I{_build.CSRC}", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(*args):
        out = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True).stdout
        return [line.split() for line in out.splitlines()]
    return run


CHECK_KEYS = ("G", "T", "S", "klen", "nr", "tile_faults", "walk_faults",
              "units_min", "units_max", "x_steps_max", "slab_steps",
              "slot_faults", "count_faults", "order_faults")


def _check(harness, dims, rows, grid=GRID):
    return [dict(zip(CHECK_KEYS, map(int, line)))
            for line in harness("check", *dims, rows, grid)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dims", [LLAMA] + SMALL,
                         ids=["llama3_8b", "small_256", "small_512",
                              "small_384"])
def test_plan_covers_every_tile_once_in_one_walk(harness, dims, rows):
    """Every 64 x 64 tile of every product phase's weights is streamed by
    exactly one block, once; the producer's walk (unit by unit) is the
    consumers' walk (fragment by fragment); every fragment has a slot of
    its own, every group's arrival count is its fragments, and the
    reduction visits each fragment of the group once; each fragment's x
    lies in its K slice, which the slab holds."""
    for ph, c in enumerate(_check(harness, dims, rows)):
        where = f"phase {ph} at {dims}, rows {rows}: {c}"
        assert c["tile_faults"] == 0, where
        assert c["walk_faults"] == 0, where
        assert c["slot_faults"] == 0, where
        assert c["count_faults"] == 0, where
        assert c["order_faults"] == 0, where
        assert c["x_steps_max"] <= c["slab_steps"], where
        assert c["nr"] >= rows and c["nr"] in (8, 16, 32, 64), where


@pytest.mark.parametrize("rows", ROWS)
def test_plan_shares_bytes_evenly(harness, rows):
    """At Llama-3-8B every block streams the same bytes to within one tile
    in every phase (within 10 % of each other); at the small test widths,
    where some blocks get no tile, the shares still differ by one tile at
    most."""
    for ph, c in enumerate(_check(harness, LLAMA, rows)):
        assert c["units_max"] - c["units_min"] <= 1, (ph, c)
        assert c["units_max"] <= 1.1 * c["units_min"], (ph, c)
    for dims in SMALL:
        for ph, c in enumerate(_check(harness, dims, rows)):
            assert c["units_max"] - c["units_min"] <= 1, (dims, ph, c)


def test_plan_budget_and_barriers(harness):
    """The block's shared memory fits the 227 KB an H100 block may have,
    with at least 96 KB of weights in flight; a tick without LoRA has 5
    barriers a layer, and one more a layer for each served shrink."""
    smem, limit, stages, unit, ring, union = map(int, harness("budget")[0])
    assert smem <= limit == 232448
    assert ring == stages * unit >= 96 * 1024
    assert union >= 128 * 128 * 4          # an int8 block-head of bs = 128
    for L in (1, 4, 32):
        assert int(harness("barriers", L, 0)[0][0]) == 5 * L
        assert int(harness("barriers", L, 4)[0][0]) == 9 * L


def test_plan_takes_the_shapes_it_should(harness):
    """Llama-3-8B at 1 to 64 rows is taken; an intermediate size that is
    not a multiple of 64, more than 64 rows, or a hidden size that is not
    a multiple of the head dim are not."""
    for rows in (1, 8, 17, 32, 33, 64):
        assert harness("fits", *LLAMA, rows, GRID)[0] == ["1"]
    assert harness("fits", 4096, 8, 14336 - 64, 8, GRID)[0] == ["1"]
    assert harness("fits", 4096, 8, 14000, 8, GRID)[0] == ["0"]
    assert harness("fits", *LLAMA, 65, GRID)[0] == ["0"]
    assert harness("fits", 4000, 8, 14336, 8, GRID)[0] == ["0"]
    floats, groups = map(int, harness("sizes", *LLAMA, 8, GRID)[0])
    assert groups == 14336 // 64          # gate/up: a group a 64 columns
    assert floats > 0 and floats % (2 * 8 * 64) == 0


@pytest.mark.parametrize("ph", range(4))
def test_plan_k_split_sum_model(harness, ph):
    """A CPU model of one product phase: each block's fragments summed in
    fp32 from the plan's tiles, each warpgroup's half of the units (in
    turn) written to the fragment's slot, and every group reduced in the
    plan's order (column block, slice, block, warpgroup): the result
    equals x @ W to fp32 accuracy, on a small grid that splits K across
    blocks."""
    dims, rows, grid = (256, 1, 384), 8, 7
    lines = harness("frags", *dims, rows, grid, ph)
    G, T, S, klen = map(int, lines[0][1:])
    frags = [tuple(map(int, ln[1:])) for ln in lines if ln[0] == "F"]
    reds = [tuple(map(int, ln[1:])) for ln in lines if ln[0] == "R"]
    hid, kv, inter = dims
    K = inter if ph == 3 else hid
    rng = np.random.RandomState(ph)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    kvd = kv * 128
    Ns = {0: [hid, kvd, kvd], 1: [hid], 2: [inter, inter], 3: [hid]}[ph]
    first = {0: 0, 1: 3, 2: 4, 3: 6}[ph]
    W = {first + i: rng.standard_normal((K, n)).astype(np.float32)
         for i, n in enumerate(Ns)}
    slots = {}
    last_b, j = -1, 0           # a block's units in order: warpgroup j % 2
    for b, item, t0, n, w, n0 in frags:
        if b != last_b:
            last_b, j = b, 0
        acc = np.zeros((2, rows, 64), np.float32)
        for k in range(n):
            t = t0 + k
            ks = slice(64 * t, 64 * t + 64)
            acc[j % 2] += x[:, ks] @ W[w][ks, n0:n0 + 64]
            j += 1
        for wg in range(2):
            slots[(item + b, wg)] = acc[wg]
    assert len({s for s, _ in slots}) == len(frags)
    got = {}
    for g, c, s, b, slot in reds:
        v = got.setdefault((g, c), np.zeros((rows, 64), np.float32))
        v += slots[(slot, 0)]
        v += slots[(slot, 1)]
    assert len(got) == 2 * G
    ref = {w: x.astype(np.float64) @ Wt.astype(np.float64)
           for w, Wt in W.items()}
    for b, item, t0, n, w, n0 in frags:
        g, c = (item // 2) % G, item % 2
        np.testing.assert_allclose(got[(g, c)], ref[w][:, n0:n0 + 64],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dims", [LLAMA] + SMALL,
                         ids=["llama3_8b", "small_256", "small_512",
                              "small_384"])
def test_plan_slices_do_not_depend_on_rows(harness, dims):
    """Batch invariance of the tick: at every row count 1..64 each product
    phase has the K slices (S, klen) of the largest row tile, so an output
    element is summed over the same slices in the same order at 8 rows (a
    decode tick) as at 40 (a verify window), 14-step slices at most (the
    slab at 64 rows); the blocks' fragments (item, first K step, units)
    are the same walk at 1, 8, 40 and 64 rows."""
    def tick_slices(K):
        # the fewest slices of at most the slab's K steps at 64 rows
        T = -(-K // 64)
        S = -(-T // (112 * 1024 // (64 * 128)))
        klen = -(-T // S)
        return [(k0, min(K, k0 + klen * 64))
                for k0 in range(0, T * 64, klen * 64)]

    plans = {rows: [(c["G"], c["T"], c["S"], c["klen"])
                    for c in _check(harness, dims, rows)]
             for rows in range(1, 65)}
    assert len({tuple(p) for p in plans.values()}) == 1, plans
    for ph, (G, T, S, klen) in enumerate(plans[1]):
        K = dims[2] if ph == 3 else dims[0]
        assert tick_slices(K) == [(64 * s * klen, min(K, 64 * (s + 1) * klen))
                                  for s in range(S)], (ph, K)
    for ph in range(4):
        walks = {rows: [ln for ln in harness("frags", *dims, rows, GRID, ph)]
                 for rows in (1, 8, 40, 64)}
        assert walks[1] == walks[8] == walks[40] == walks[64], (dims, ph)
