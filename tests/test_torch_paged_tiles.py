"""The work plan of the paged attention kernel
(``paddle_tpu_torch/ops/csrc/paged_tiles.cuh``), the part of
``paged_attention.cu`` a host compiler can build: a small harness around the
header, compiled with ``g++``, prints the launch plan (the persistent grid,
the launch's work units and each row's keys a split, sized from that row's
keys to about one wave were half the rows as long) and, for every work
unit, its item (batch row, tile, split, KV head), the keys it walks and,
stage by stage, which TMA boxes it loads from the pool.

Held here, for every case and two waves: every visible (row, key) pair is
covered exactly once across a row's splits; no box past a tile's causal
frontier is loaded (so the tail entries on scratch block 0 are never
read); the combine pass reads exactly the splits that were written (a tile
of one split writes its output directly), never more than the workspace
holds; the work units are numbered in order and every grid stays in
range; a row's splits are the same whatever the other rows hold. Cases:
decode rows of ragged lengths (1 to 2048 keys), verify windows of 2-8
tokens, prefill chunks at start 0, 384 and 1920,
block sizes 8, 16 and 32, tables up to 136 entries wide, and group sizes
that do not divide the 64-row tile.

Then a CPU model in PyTorch of the kernel's arithmetic over the plan (the
boxes it loads, zeros for the ones it does not, stages of 64 keys, the
online softmax in the log2 domain, the splits' merge), in fp32, against the
JAX ``paged_attention`` (its jnp reference, and its Pallas kernel in
interpret mode once), with a scratch block poisoned with +-1e9."""
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import ops as jops
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import _build

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "paged_tiles.cuh"
namespace pt = paged_tiles;

// plan B W H KV bs M         -> rows tiles split_keys splits box items
//                               units kRows kStageKeys bad
// blocks B W H KV bs M wave pos...
//   -> "G blocks units" (the grid, the launch's work units), per row "R ks"
//   (its keys a split), then per work unit up to the plan's most, "I i"
//   (none) or
//   "A i b tile split g frontier n begin end stages direct"; for KV head
//   0 then per stage "S key0" and per box "X key loaded entry slot"
int main(int argc, char** argv) {
  if (argc < 8) return 2;
  const int B = atoi(argv[2]), W = atoi(argv[3]), H = atoi(argv[4]);
  const int KV = atoi(argv[5]), bs = atoi(argv[6]), M = atoi(argv[7]);
  const pt::Plan p = pt::plan(B, W, H, KV, bs, M);
  if (!strcmp(argv[1], "plan")) {
    printf("%d %d %d %d %d %lld %lld %d %d %d\n", p.rows, p.tiles,
           p.split_keys, p.splits, p.box, p.items, p.units,
           pt::kRows, pt::kStageKeys,
           pt::bad_shape(B, W, H, KV, bs, M, 1) ? 1 : 0);
    return 0;
  }
  if (strcmp(argv[1], "blocks") || argc != 9 + B) return 2;
  const int wave = atoi(argv[8]);
  std::vector<int> pos(B);
  for (int b = 0; b < B; ++b) pos[b] = atoi(argv[9 + b]);
  const int rep = H / KV;
  auto posf = [&](int b) { return pos[b]; };
  printf("G %d %lld\n", pt::work_blocks(p, wave),
         pt::launch_units(B, KV, rep, M, bs, p, wave, posf));
  for (int b = 0; b < B; ++b)
    printf("R %d\n", pt::row_split_keys(pos[b], B, KV, rep, M, bs, p, wave));
  for (long long i = 0; i < p.units; ++i) {
    pt::Item it;
    if (!pt::item_of(i, B, KV, rep, M, bs, p, wave, posf, &it)) {
      printf("I %lld\n", i);
      continue;
    }
    const int fr = pt::tile_frontier(pos[it.b], it.tile, p.rows, rep, M, bs);
    const int ks = pt::row_split_keys(pos[it.b], B, KV, rep, M, bs, p, wave);
    if (pt::row_tile_splits(pos[it.b], it.tile, B, KV, rep, M, bs, p, wave) !=
        pt::tile_splits(fr, ks))
      return 3;
    const int n = pt::tile_splits(fr, ks);
    const pt::Keys k = pt::split_keys(it.split, fr, ks);
    const int ns = pt::split_stages(k);
    printf("A %lld %d %d %d %d %d %d %d %d %d %d\n", i, it.b, it.tile,
           it.split, it.g, fr, n, k.begin, k.end, ns,
           pt::writes_direct(n) ? 1 : 0);
    if (it.g != 0) continue;
    for (int j = 0; j < ns; ++j) {
      const int key0 = k.begin + j * pt::kStageKeys;
      printf("S %d\n", key0);
      for (int x = 0; x < pt::kStageKeys / p.box; ++x) {
        const int key = key0 + x * p.box;
        printf("X %d %d %d %d\n", key, pt::box_loaded(key, fr) ? 1 : 0,
               key / bs, key % bs);
      }
    }
  }
  return 0;
}
"""

ROWS, STAGE = 64, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return plan_harness(tmp_path_factory.mktemp("paged_tiles"))


def plan_harness(d):
    """Build the harness in directory ``d``; returns run(*args) -> lines
    of fields (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the paged-attention plan harness")
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


def get_plan(harness, B, W, H, KV, bs, M):
    keys = ("rows", "tiles", "split_keys", "splits", "box", "items",
            "units", "kRows", "kStageKeys", "bad")
    return dict(zip(keys, map(int, harness("plan", B, W, H, KV, bs, M)[0])))


# blocks the H100 holds at once at two an SM: the launch's wave
WAVE = 264


def blocks(harness, W, H, KV, bs, M, pos, wave=WAVE):
    """The launch: ((grid, work units, each row's keys a split), the units
    with work as dicts, the unit indices past them)."""
    lines = harness("blocks", len(pos), W, H, KV, bs, M, wave, *pos)
    active, idle = [], []
    launch, ks = None, []
    for ln in lines:
        if ln[0] == "G":
            launch = tuple(map(int, ln[1:]))
        elif ln[0] == "R":
            ks.append(int(ln[1]))
        elif ln[0] == "I":
            idle.append(int(ln[1]))
        elif ln[0] == "A":
            f = list(map(int, ln[1:]))
            active.append(dict(i=f[0], b=f[1], tile=f[2], split=f[3],
                               g=f[4], frontier=f[5], n=f[6], begin=f[7],
                               end=f[8], stages=f[9], direct=f[10],
                               boxes=[]))
        elif ln[0] == "S":
            active[-1]["boxes"].append((int(ln[1]), []))
        else:
            active[-1]["boxes"][-1][1].append(tuple(map(int, ln[1:])))
    return launch + (ks,), active, idle


def _frontier(pos, tile, rows, rep, M, bs):
    last = min((tile + 1) * ROWS, rows) - 1
    return max(0, min(pos + last // rep, M * bs - 1))


def _split_keys(plan, pos, B, rep, KV, M, bs, wave):
    """The keys a split of a row takes, from the keys a row as long as
    the table walks in its tiles (not the row's ``pos``): the fewest (128),
    or enough in whole stages for about one wave of units in a launch with
    half its ``B`` rows that long."""
    keys = (B + 1) // 2 * plan["tiles"] * M * bs
    per = -(-keys * KV // wave)
    return max(plan["split_keys"], -(-per // STAGE) * STAGE)


# (name, W, H, KV, bs, M, pos): decode rows of ragged lengths (1 to 2048
# keys, the served table of 136 entries), with one long row among short
# ones and all rows long; verify windows of 2-8 tokens; prefill chunks of
# 128 at start 0, 384 and 1920 (the last chunk at max_len 2048); block
# sizes 8 and 32; group sizes 1 and 3 (3 does not divide the 64-row tile)
CASES = [
    ("decode_ragged", 1, 32, 8, 16, 136,
     [1000, 511, 512, 255, 37, 700, 128, 5]),
    ("decode_one_to_2048", 1, 32, 8, 16, 136,
     [0, 1, 63, 64, 127, 128, 1023, 2047]),
    ("decode_all_long", 1, 32, 8, 16, 136, [2047] * 8),
    ("decode_one_long", 1, 32, 8, 16, 136, [2047, 3, 17, 0, 9, 31, 1, 64]),
    ("verify_w2", 2, 32, 8, 16, 136, [0, 126, 127, 1500]),
    ("verify_w4", 4, 32, 8, 16, 136, [0, 125, 700, 2044]),
    ("verify_w8", 8, 32, 8, 16, 136, [3, 248, 1017, 2040]),
    ("prefill_0", 128, 32, 8, 16, 136, [0]),
    ("prefill_384", 128, 32, 8, 16, 136, [384]),
    ("prefill_1920", 128, 32, 8, 16, 136, [1920]),
    ("decode_bs8", 1, 32, 8, 8, 136, [1000, 7, 8, 1079]),
    ("prefill_bs8", 128, 32, 8, 8, 136, [384]),
    ("decode_bs32", 1, 32, 8, 32, 68, [2047, 31, 32, 500]),
    ("prefill_bs32", 128, 32, 8, 32, 68, [1920]),
    ("verify_rep3", 5, 12, 4, 16, 136, [63, 900]),
    ("prefill_rep3", 40, 12, 4, 16, 136, [200]),
    ("decode_mha", 1, 8, 8, 16, 40, [0, 300, 639]),
]


def _case_ids(c):
    return c[0]


@pytest.mark.parametrize("wave", [WAVE, 40], ids=["wave", "small_wave"])
@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_plan_covers_each_visible_pair_once(harness, case, wave):
    _, W, H, KV, bs, M, pos = case
    B = len(pos)
    rep = H // KV
    p = get_plan(harness, B, W, H, KV, bs, M)
    assert p["bad"] == 0
    assert p["rows"] == W * rep and p["tiles"] == -(-p["rows"] // ROWS)
    assert p["split_keys"] == 128 and p["kStageKeys"] == STAGE
    assert (p["splits"] - 1) * p["split_keys"] < M * bs <= \
        p["splits"] * p["split_keys"]
    assert bs % p["box"] == 0 and STAGE % p["box"] == 0
    (grid, units, ks), active, idle = blocks(harness, W, H, KV, bs, M, pos,
                                             wave)
    assert p["units"] == p["items"] * KV == \
        B * p["tiles"] * p["splits"] * KV < 2 ** 31
    # a row's split keys from its own keys: about one wave of units were
    # half the rows as long, never fewer than the plan's (so the
    # workspace's splits always suffice)
    assert ks == [_split_keys(p, x, B, rep, KV, M, bs, wave) for x in pos]
    assert all(k % STAGE == 0 and k >= p["split_keys"] for k in ks)
    big = [b for b in range(B) if ks[b] > p["split_keys"]]
    assert sum(a["b"] in big for a in active) <= \
        len(big) * (-(-wave // ((B + 1) // 2)) + p["tiles"] * KV)
    # a persistent grid of at most one wave, sized from shapes alone; the
    # launch's units with work are 0 .. units - 1, block i taking units
    # i, i + grid, ...
    assert grid == min(p["units"], wave)
    assert [a["i"] for a in active] == list(range(units))
    assert idle == list(range(units, p["units"]))
    # items in (b, tile, split) order, each KV head once, neighbours in
    # the grid
    items = [(a["b"], a["tile"], a["split"]) for a in active[::KV]]
    assert items == sorted(items)
    for n, a in enumerate(active):
        assert a["g"] == n % KV
        assert (a["b"], a["tile"], a["split"]) == items[n // KV]
    for b in range(B):
        for tile in range(p["tiles"]):
            mine = [a for a in active if a["b"] == b and a["tile"] == tile
                    and a["g"] == 0]
            frontier = _frontier(pos[b], tile, p["rows"], rep, M, bs)
            n = frontier // ks[b] + 1
            # the splits written are exactly 0 .. n - 1, within the
            # workspace's p["splits"], which the combine reads (a tile of
            # one split writes its output directly)
            assert n <= p["splits"]
            assert [a["split"] for a in mine] == list(range(n))
            for a in mine:
                assert a["frontier"] == frontier and a["n"] == n
                assert a["direct"] == (n == 1)
            # every key up to the frontier lies in exactly one loaded box
            # of one split; no box past it is loaded; no table entry past
            # the frontier's is read
            covered = np.zeros(M * bs, np.int64)
            for a in mine:
                assert a["begin"] == a["split"] * ks[b]
                assert a["end"] == min(a["begin"] + ks[b], frontier + 1)
                assert a["stages"] == -(-(a["end"] - a["begin"]) // STAGE)
                assert len(a["boxes"]) == a["stages"]
                for j, (key0, bxs) in enumerate(a["boxes"]):
                    assert key0 == a["begin"] + j * STAGE
                    assert [x[0] for x in bxs] == list(
                        range(key0, key0 + STAGE, p["box"]))
                    for key, loaded, entry, slot in bxs:
                        assert loaded == (key <= frontier)
                        if loaded:
                            assert entry == key // bs < M
                            assert entry <= frontier // bs
                            assert slot + p["box"] <= bs   # one pool block
                            covered[key:key + p["box"]] += 1
            assert (covered[:frontier + 1] == 1).all(), (b, tile)


def _row_work(active, b):
    return [(a["tile"], a["split"], a["g"], a["frontier"], a["n"],
             a["begin"], a["end"]) for a in active if a["b"] == b]


@pytest.mark.parametrize("case", [c for c in CASES if len(c[6]) > 1],
                         ids=_case_ids)
def test_a_rows_splits_do_not_depend_on_the_other_rows(harness, case):
    """A row's keys a split, splits and keys walked are the same whatever
    the other rows of the launch hold (none, all as short as can be, all
    at the table's end): its sums, and so a served request's tokens, do
    not change with the batch it shares."""
    _, W, H, KV, bs, M, pos = case
    (_, _, ks), active, _ = blocks(harness, W, H, KV, bs, M, pos)
    last = M * bs - W
    for b in range(len(pos)):
        mine = _row_work(active, b)
        assert mine
        for fill in (0, last):
            other = [fill] * len(pos)
            other[b] = pos[b]
            (_, _, ks2), active2, _ = blocks(harness, W, H, KV, bs, M, other)
            assert ks2[b] == ks[b] and _row_work(active2, b) == mine, \
                (b, fill)


@pytest.mark.parametrize("pos0", [0, 250, 1052, 1055, 2043])
def test_a_keys_split_does_not_depend_on_the_window(harness, pos0):
    """A verify window of W = 5 tokens a row and the 5 decode ticks that
    score the same queries (the served batch's shapes): every query's keys
    a split, and the split each of its keys falls in, are the same, so its
    sums round alike in both (a split size that followed the row's keys
    changed at 1056 keys between a window and its ticks)."""
    B, H, KV, bs, M = 8, 32, 8, 16, 136
    pos = [pos0 + 7 * b for b in range(B)]
    (_, _, ks_w), _, _ = blocks(harness, 5, H, KV, bs, M, pos)
    for j in range(5):
        (_, _, ks_d), _, _ = blocks(harness, 1, H, KV, bs, M,
                                    [p + j for p in pos])
        assert ks_d == ks_w, (j, ks_d, ks_w)


@pytest.mark.parametrize("bs,bad", [(8, 0), (16, 0), (24, 0), (4, 1),
                                    (12, 1), (0, 1)])
def test_plan_refuses_block_sizes_off_the_rule(harness, bs, bad):
    """bs a positive multiple of 8 (the TPU kernel's rule on hardware);
    24 takes boxes of 8 keys."""
    p = get_plan(harness, 2, 1, 32, 8, bs, 8)
    assert p["bad"] == bad
    if not bad:
        assert p["box"] == min(bs & -bs, 64)


@pytest.mark.parametrize("bs", [4, 12, 20])
def test_wrapper_refuses_block_sizes_off_the_rule(bs):
    """The wrappers' shared shape check names the rule before any launch
    (the int8 wrapper checks shapes before the device)."""
    from paddle_tpu_torch.ops.paged_attention_cuda import \
        paged_attention_int8_cuda

    z = torch.zeros
    pool = z(4, bs, 2, 128, dtype=torch.int8)
    before = paged_attention_int8_cuda.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        paged_attention_int8_cuda(z(2, 1, 8, 128, dtype=torch.bfloat16), pool,
                                  z(4, 2), pool.clone(), z(4, 2),
                                  z(2, 3, dtype=torch.int32),
                                  z(2, dtype=torch.int32))
    assert paged_attention_int8_cuda.launches == before


# ------------------------------------------------------------ CPU model
LOG2E = 1.4426950408889634


def _model(q, kp, vp, tables, pos, active, plan, ksc_=None, vsc_=None):
    """The kernel's arithmetic over the plan, in fp32: per block (KV head
    0's boxes stand for every head: the plan does not depend on it), the
    loaded boxes' keys (zeros for the others), 64-key stages, the online
    softmax in the log2 domain with the row masks, then the direct write
    or the merge of the splits a tile wrote."""
    B, W, H, D = q.shape
    KV = kp.shape[2]
    rep = H // KV
    rows = plan["rows"]
    sl2 = LOG2E / np.sqrt(D)
    out = torch.zeros(B, W, H, D)
    parts = {}
    qg = q.reshape(B, W, KV, rep, D).permute(0, 2, 1, 3, 4).reshape(
        B, KV, rows, D)
    for a in active:
        if a["g"] != 0:
            continue
        b, tile = a["b"], a["tile"]
        r0, r1 = tile * ROWS, min((tile + 1) * ROWS, rows)
        rr = torch.arange(r0, r1)
        row_front = pos[b] + rr // rep
        for g in range(KV):
            qt = qg[b, g, r0:r1]
            m = torch.full((r1 - r0,), -1e30 * LOG2E)
            l = torch.zeros(r1 - r0)
            acc = torch.zeros(r1 - r0, D)
            for key0, bxs in a["boxes"]:
                kt = torch.zeros(STAGE, D)
                vt = torch.zeros(STAGE, D)
                ksc = torch.zeros(STAGE)
                vsc = torch.zeros(STAGE)
                for key, loaded, entry, slot in bxs:
                    if not loaded:
                        continue
                    o = key - key0
                    page = int(tables[b, entry])
                    n = plan["box"]
                    kt[o:o + n] = kp[page, slot:slot + n, g]
                    vt[o:o + n] = vp[page, slot:slot + n, g]
                    if ksc_ is not None:
                        ksc[o:o + n] = ksc_[page, g]
                        vsc[o:o + n] = vsc_[page, g]
                keys = key0 + torch.arange(STAGE)
                f = ksc * sl2 if ksc_ is not None else torch.full((STAGE,),
                                                                  sl2)
                x = (qt @ kt.T) * f[None]
                x = torch.where(keys[None] <= row_front[:, None], x,
                                torch.tensor(-np.inf))
                mi = torch.maximum(m, x.max(1).values)
                alpha = torch.exp2(m - mi)
                pr = torch.exp2(x - mi[:, None])
                l = l * alpha + pr.sum(1)
                if ksc_ is not None:
                    pr = pr * vsc[None]
                acc = acc * alpha[:, None] + pr @ vt
                m = mi
            if a["direct"]:
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                for i, r in enumerate(rr.tolist()):
                    out[b, r // rep, g * rep + r % rep] = o[i]
            else:
                parts[(b, g, tile, a["split"])] = (m, l, acc)
    merged = {}
    for (b, g, tile, s), v in parts.items():
        merged.setdefault((b, g, tile), []).append((s, v))
    for (b, g, tile), sv in merged.items():
        sv.sort(key=lambda x: x[0])
        ms = torch.stack([v[0] for _, v in sv])
        mx = ms.max(0).values
        wgt = torch.exp2(ms - mx[None])
        l = (torch.stack([v[1] for _, v in sv]) * wgt).sum(0)
        acc = (torch.stack([v[2] for _, v in sv]) * wgt[..., None]).sum(0)
        o = acc / torch.clamp(l, min=1e-30)[:, None]
        r0 = tile * ROWS
        for i in range(o.shape[0]):
            r = r0 + i
            out[b, r // rep, g * rep + r % rep] = o[i]
    return out


def _model_case(seed, W, pos, H=8, KV=2, D=32, bs=8, quant=False):
    rng = np.random.default_rng(seed)
    B = len(pos)
    need = [(p + W - 1) // bs + 1 for p in pos]
    M = max(need) + 3
    N = sum(need) + 4
    kp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    kp[0], vp[0] = 1e9, -1e9                       # scratch, poisoned
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    took = 0
    for b in range(B):
        tables[b, :need[b]] = free[took:took + need[b]]
        took += need[b]
    pos = np.array(pos, np.int32)
    if not quant:
        return q, kp, vp, tables, pos, None, None
    kq = np.clip(np.round(kp * 40), -127, 127).astype(np.int8)
    vq = np.clip(np.round(vp * 40), -127, 127).astype(np.int8)
    ks = (0.02 + 0.01 * rng.random((N, KV))).astype(np.float32)
    vs = (0.02 + 0.01 * rng.random((N, KV))).astype(np.float32)
    kq[0], vq[0] = 127, -127                       # full codes ...
    ks[0], vs[0] = 1e9, 1e9                        # ... at a huge scale
    return q, kq, vq, tables, pos, ks, vs


# the online softmax over stages and the merge vs XLA's two-pass softmax:
# fp32 values that differ only in summation order and exp2 vs exp
TOL = dict(rtol=2e-5, atol=2e-5)

# (name, W, pos): decode over 1-5 splits of 128 keys, a verify window of
# 16 rows over 1-5, a prefill chunk of 2 tiles over 3
MODEL_CASES = [("decode", 1, [600, 5, 300]), ("verify", 4, [520, 17]),
               ("prefill", 24, [290])]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_ids)
def test_split_and_merge_model_matches_jax(harness, case, quant):
    name, W, pos = case
    H, KV, bs = 8, 2, 8
    q, kp, vp, tables, posv, ks, vs = _model_case(1, W, pos, H=H, KV=KV,
                                                  bs=bs, quant=quant)
    B, M = tables.shape
    plan = get_plan(harness, B, W, H, KV, bs, M)
    _, active, _ = blocks(harness, W, H, KV, bs, M, pos)
    assert any(not a["direct"] for a in active)   # a merge is exercised
    t = [torch.from_numpy(x) for x in (q, kp, vp, tables, posv)]
    if quant:
        out = _model(t[0], t[1].float(), t[2].float(), t[3], pos, active,
                     plan, torch.from_numpy(ks), torch.from_numpy(vs))
        ref = np.asarray(jpa.paged_verify_attention_q(
            *(jnp.asarray(x) for x in (q, kp, ks, vp, vs, tables, posv))))
    else:
        out = _model(*t[:4], pos, active, plan)
        ref = np.asarray(jpa.paged_verify_attention(
            *(jnp.asarray(x) for x in (q, kp, vp, tables, posv))))
    assert np.isfinite(out.numpy()).all()          # scratch never read
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_split_and_merge_model_matches_the_pallas_kernel(harness):
    """Once against the TPU kernel itself, in interpret mode."""
    W, pos = 1, [600, 5, 300]
    H, KV, bs = 8, 2, 8
    q, kp, vp, tables, posv, _, _ = _model_case(2, W, pos, H=H, KV=KV,
                                                bs=bs)
    B, M = tables.shape
    plan = get_plan(harness, B, W, H, KV, bs, M)
    _, active, _ = blocks(harness, W, H, KV, bs, M, pos)
    assert any(not a["direct"] for a in active)
    out = _model(*(torch.from_numpy(x) for x in (q, kp, vp, tables)), pos,
                 active, plan)
    jops.set_kernel_mode("pallas")
    try:
        pallas = np.asarray(jpa.paged_verify_attention(
            *(jnp.asarray(x) for x in (q, kp, vp, tables, posv))))
    finally:
        jops.set_kernel_mode("auto")
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)
