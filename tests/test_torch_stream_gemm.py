"""The launch plan of the weight-streaming products
(``paddle_tpu_torch/ops/csrc/stream_tiles.cuh``): the part of
``w8_matmul.cu`` and ``fused_lora.cu`` a host compiler can build. A small
harness around the header, compiled with ``g++``, prints the plan of a
product, the K slices of the fused LoRA kernel's first launch and the
elements each block of a cluster finishes; the tests hold them for every
decode and prefill shape of the int8 matmul (Llama-3-8B's projections and
lm-head) and of the seven LoRA targets, at M in {1, 8, 16, 40, 64, 128},
on three SM counts, and for ragged K.

A plan must cover K exactly once in whole K steps, with no empty split, a
cluster of at most 8 blocks and a grid inside its extents. The reduction
of a cluster's partial sums is modelled on the CPU: each element is summed
over the blocks in rank order by the one block that owns it, so the result
does not depend on the order in which the blocks finish (an arrival-order
sum, what atomics would give, does)."""
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.lora import target_dims
from paddle_tpu_torch.models.llama import llama3_8b_config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_lora_cuda, int8_cuda
from paddle_tpu_torch.ops import launch_counts, reset_launch_counts

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include "stream_tiles.cuh"
namespace st = stream_tiles;

// one query a line on stdin, one answer a line on stdout:
// sizes                -> kKStep kColBlock kMaxCluster kMaxGrid kLoraChunk
//                         kMaxSlices kMaxRank
// plan M K N sms       -> tok wg splits ks col_tiles tok_tiles bad_plan
// slices K R          -> slices slice_rows
// range items C        -> b e of ranks 0 .. C - 1
int main() {
  char op[16];
  while (scanf("%15s", op) == 1) {
    if (!strcmp(op, "sizes")) {
      printf("%d %d %d %d %d %d %d\n", st::kKStep, st::kColBlock,
             st::kMaxCluster, st::kMaxGrid, st::kLoraChunk, st::kMaxSlices,
             st::kMaxRank);
    } else if (!strcmp(op, "plan")) {
      int M, K, N, sms;
      if (scanf("%d %d %d %d", &M, &K, &N, &sms) != 4) return 2;
      const st::Plan p = st::plan(M, K, N, sms);
      printf("%d %d %d %d %d %d %d\n", p.tok, p.wg, p.splits, p.ks,
             p.col_tiles, p.tok_tiles, int(st::bad_plan(p)));
    } else if (!strcmp(op, "slices")) {
      int K, R;
      if (scanf("%d %d", &K, &R) != 2) return 2;
      const int s = st::lora_slices(K, R);
      printf("%d %d\n", s, st::lora_slice_rows(K, s));
    } else if (!strcmp(op, "range")) {
      int items, C;
      if (scanf("%d %d", &items, &C) != 2) return 2;
      for (int r = 0; r < C; ++r) {
        int b, e;
        st::reduce_range(items, C, r, &b, &e);
        printf("%d %d ", b, e);
      }
      printf("\n");
    } else {
      return 2;
    }
    fflush(stdout);
  }
  return 0;
}
"""

CFG = llama3_8b_config()
# (K, N) of the int8 matmul's decode shapes: the projections and lm-head
W8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, CFG.vocab_size)]
# (K, N) of the seven LoRA targets
LORA_SHAPES = sorted(set(target_dims(CFG).values()))
ROWS = [1, 8, 16, 40, 64, 128]
# an H100 SXM, an H100 PCIe, and a small card
SMS = [132, 114, 16]
# ragged K: not a multiple of the 64-row K step (the LoRA kernel takes
# K % 32), and K shorter than one step
RAGGED = [(4096 + 32, 1024), (96, 4096), (32, 128), (14336 + 32, 4096),
          (4096 + 64, 14336)]


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
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stream-plan harness")
    d = tmp_path_factory.mktemp("stream_tiles")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    f"-I{_build.CSRC}", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(queries):
        text = "".join(" ".join(map(str, q)) + "\n" for q in queries)
        out = subprocess.run([str(exe)], input=text, check=True,
                             capture_output=True, text=True).stdout
        lines = [list(map(int, ln.split())) for ln in out.splitlines()]
        assert len(lines) == len(queries)
        return lines
    return run


def _sizes(harness):
    keys = ("k_step", "col_block", "max_cluster", "max_grid", "lora_chunk",
            "max_slices", "max_rank")
    return dict(zip(keys, harness([("sizes",)])[0]))


def test_the_headers_sizes_match_the_wrappers(harness):
    """The wrappers' constants are the header's: the LoRA workspace holds
    the most slices, the rank limit agrees, every plan's instantiation
    exists, and the largest token tile holds the wrapper's tile rows."""
    s = _sizes(harness)
    assert s["k_step"] == 64 and s["col_block"] == 64
    assert s["max_cluster"] == 8
    assert fused_lora_cuda.MAX_SLICES == s["max_slices"]
    assert fused_lora_cuda.MAX_RANK == s["max_rank"]
    assert fused_lora_cuda.K_STEP % 8 == 0          # TMA: 16-byte rows of x
    assert fused_lora_cuda.BLOCK_N % (2 * s["col_block"]) == 0
    tok, *_ = harness([("plan", int8_cuda.TILE_ROWS, 4096, 4096, 132)])[0]
    assert tok == int8_cuda.TILE_ROWS


def _cases():
    out = []
    for (K, N), M, sms in itertools.product(W8_SHAPES + LORA_SHAPES + RAGGED,
                                            ROWS, SMS):
        out.append((M, K, N, sms))
    return sorted(set(out))


CASES = _cases()


@pytest.mark.parametrize("sms", SMS)
def test_plans_cover_k_once_in_whole_steps(harness, sms):
    """For every shape and row count: the splits cover K's steps exactly
    once (the last split may be short, none is empty), the cluster holds at
    most 8 blocks, the column and token tiles cover N and M, and the grid
    stays inside its extents; each plan names an instantiated kernel."""
    s = _sizes(harness)
    cases = [c for c in CASES if c[3] == sms]
    plans = harness([("plan",) + c for c in cases])
    for (M, K, N, _), (tok, wg, splits, ks, ct, tt, bad) in zip(cases, plans):
        steps = -(-K // s["k_step"])
        assert (tok, wg) in int8_cuda.CONFIGS, (M, K, N)
        assert tok >= min(M, 128) and tt == -(-M // tok)
        assert 1 <= splits <= s["max_cluster"] and ks >= 1
        assert splits * ks >= steps > (splits - 1) * ks, (M, K, N, splits, ks)
        assert ct * wg * s["col_block"] >= N > (ct - 1) * wg * s["col_block"]
        assert ct <= s["max_grid"] and tt <= s["max_grid"] and not bad
        # the blocks of one token tile about fill the card twice (two
        # blocks fit an SM at a decode token tile), or the column tiles
        # alone already do
        blocks = splits * ct * tt
        assert blocks <= max(2 * sms * tt, ct * tt), (M, K, N, blocks)


def test_the_serving_plans(harness):
    """The plans of the main path on an H100 SXM (132 SMs): the MLP's wide
    projections and the lm-head take 128-column tiles, the others 64; the
    K splits aim at two blocks an SM at one token tile, at 8 rows as at
    128 (the split does not depend on the rows)."""
    got = {}
    for M in (8, 128):
        for K, N in W8_SHAPES:
            got[(M, K, N)] = tuple(harness([("plan", M, K, N, 132)])[0][:4])
    assert got[(8, 4096, 1024)] == (8, 1, 8, 8)
    assert got[(8, 4096, 4096)] == (8, 1, 4, 16)
    assert got[(8, 4096, 14336)] == (8, 2, 2, 32)
    assert got[(8, 14336, 4096)] == (8, 1, 4, 56)
    assert got[(8, 4096, 128256)] == (8, 2, 1, 64)
    assert got[(128, 4096, 14336)] == (128, 2, 2, 32)
    assert got[(128, 14336, 4096)] == (128, 1, 4, 56)


def _todays_split(M, K, N, sms):
    """The K split of the plan before it was made row-invariant: at a
    decode token tile 2 sms / (column tiles x token tiles), at 128 rows
    sms / (...)."""
    steps = -(-K // 64)
    tok = 8 if M <= 8 else 16 if M <= 16 else 128
    tt = -(-M // tok)
    wg = 2 if 4 * -(-N // 128) * tt >= 3 * sms else 1
    ct = -(-N // (wg * 64))
    s = max(1, min((2 if tok <= 16 else 1) * sms // (ct * tt), 8, steps))
    ks = -(-steps // s)
    return -(-steps // ks), ks


# row counts past one token tile: a server's max_batch x (k + 1) (32 x 5
# = 160) and larger batches, in several 128-row tiles
MANY_ROWS = (129, 160, 256, 384, 385, 512, 1000, 4096)


@pytest.mark.parametrize("sms", SMS)
def test_k_split_does_not_depend_on_rows(harness, sms):
    """Batch invariance of the streaming products: at every M in 1..128
    and in MANY_ROWS the plan's splits, ``ks`` and column tile are those
    of M = 8 for each Llama-3-8B shape (so a row is summed over the same K
    ranges in a decode tick of 8 rows as in a verify window of 40 or 160,
    and an int8 tile's warpgroups share its stages alike); the decode
    plans (M <= 16) are unchanged from the plan before the repair; and the
    Python twin's K slices (``stream_matmul.k_slices``) are the header's."""
    from paddle_tpu_torch.ops.stream_matmul import k_slices

    shapes = W8_SHAPES + LORA_SHAPES + RAGGED
    queries = [("plan", M, K, N, sms) for K, N in shapes
               for M in list(range(1, 129)) + list(MANY_ROWS)]
    plans = harness(queries)
    by_shape = {}
    for (_, M, K, N, _), (tok, wg, splits, ks, ct, tt, bad) in zip(queries,
                                                                   plans):
        assert tt == -(-M // 128) if M > 128 else tt == 1
        assert not bad
        by_shape.setdefault((K, N), set()).add((wg, splits, ks, ct))
        if M <= 16:
            assert (splits, ks) == _todays_split(M, K, N, sms), (M, K, N)
        if M == 8:
            want = [(k0, min(K, k0 + ks * 64))
                    for k0 in range(0, splits * ks * 64, ks * 64)]
            want = [r for r in want if r[0] < K]
            assert k_slices(K, N, sms) == want, (K, N)
    for key, got in by_shape.items():
        assert len(got) == 1, (key, got)


@pytest.mark.parametrize("S,E", [(1, 8), (1, 1), (128, 1), (4, 8), (300, 2),
                                 (16, 16)])
@pytest.mark.parametrize("R", [1, 4, 8, 16, 64])
def test_lora_slices_cover_k_once(harness, S, E, R):
    """The first launch's K slices: whole 64-row chunks, covering K once
    with no empty slice, at most the workspace's 32, and at most 512 / R
    (the second launch sums each row's xa over them); a function of K and
    R alone, whatever the entries (E) and their rows (S)."""
    s = _sizes(harness)
    Ks = sorted({K for K, _ in LORA_SHAPES} | {K for K, _ in RAGGED})
    queries = [("slices", K, R) for K in Ks]
    for (_, K, _), (n, rows) in zip(queries, harness(queries)):
        assert 1 <= n <= s["max_slices"], (K, n)
        assert rows % s["lora_chunk"] == 0
        assert n * rows >= K > (n - 1) * rows, (K, n, rows)
        assert n == 1 or n * R <= 512, (K, n)
        assert E * S >= 1


def test_the_serving_slices(harness):
    """Decode (8 entries of 1 row, rank 8) and a prefill chunk (1 entry of
    128 rows) split K into 32 slices."""
    q = [("slices", 4096, 8), ("slices", 14336, 8)]
    assert harness(q) == [[32, 128], [32, 448]]


@pytest.mark.parametrize("C", [1, 2, 3, 4, 7, 8])
def test_reduce_ranges_partition_the_tile(harness, C):
    """The ranks of a cluster finish contiguous ranges of the tile's
    elements that cover it once, in rank order."""
    items_list = [1, 2, 7, 8, 64, 256, 8 * 32, 128 * 32, 128 * 16]
    answers = harness([("range", n, C) for n in items_list])
    for items, flat in zip(items_list, answers):
        ranges = list(zip(flat[::2], flat[1::2]))
        assert len(ranges) == C
        assert ranges[0][0] == 0 and ranges[-1][1] == items
        for (b, e), (b2, _) in zip(ranges, ranges[1:]):
            assert b <= e == b2


def _cluster_sum(partials, owner_ranges, arrivals):
    """The kernel's reduction of a cluster's fp32 partial tiles: the blocks
    finish in the order ``arrivals`` (each writes its partial to its own
    shared memory, then all meet at the cluster barrier); afterwards the
    owner of each element adds the blocks' partials in rank order."""
    C = len(partials)
    smem = [None] * C
    for r in arrivals:
        smem[r] = partials[r].copy()
    out = np.empty_like(partials[0])
    for b, e in owner_ranges:
        acc = smem[0][b:e].copy()
        for r in range(1, C):
            acc = acc + smem[r][b:e]
        out[b:e] = acc
    return out


def _arrival_sum(partials, arrivals):
    """What float atomics would give: the partials added as they arrive."""
    acc = np.zeros_like(partials[0])
    for r in arrivals:
        acc = acc + partials[r]
    return acc


@pytest.mark.parametrize("C", [2, 3, 4, 8])
def test_the_reduction_does_not_depend_on_arrival_order(harness, C):
    """With partial sums of mixed magnitude (fp32 addition is not
    associative) the kernel's rank-order reduction gives the same bits for
    every order in which the cluster's blocks finish; an arrival-order sum
    does not."""
    rng = np.random.default_rng(C)
    items = 8 * 32                                  # an 8-row tile, 128 cols
    partials = [(rng.standard_normal(items) * 10.0 ** rng.integers(-3, 4))
                .astype(np.float32) for _ in range(C)]
    flat = harness([("range", items, C)])[0]
    owners = list(zip(flat[::2], flat[1::2]))
    orders = list(itertools.permutations(range(C)))
    orders = [orders[i] for i in rng.choice(len(orders),
                                            size=min(24, len(orders)),
                                            replace=False)]
    ref = _cluster_sum(partials, owners, tuple(range(C)))
    for order in orders:
        assert np.array_equal(_cluster_sum(partials, owners, order), ref)
    # two addends commute; from three on the arrival order shows
    sums = {_arrival_sum(partials, o).tobytes() for o in orders}
    assert len(sums) > 1 or C == 2
    exact = np.sum(np.stack(partials).astype(np.float64), axis=0)
    np.testing.assert_allclose(ref, exact, rtol=0,
                               atol=C * 2.0 ** -23 *
                               np.abs(np.stack(partials)).sum(0).max())


def test_w8_cuda_wrapper_refuses_cpu_tensors():
    """The int8 wrappers take CUDA tensors only: a CPU tensor raises and
    counts no launch (the dispatch gives CPU tensors the plain twin). They
    take any row count (past 128 rows the kernel runs several token
    tiles): 160 rows are refused for the device, not for their number;
    no rows are refused for their number."""
    from paddle_tpu_torch.ops.int8_cuda import w8_matmul_cuda
    from paddle_tpu_torch.ops.stream_matmul_cuda import stream_matmul_cuda

    x = torch.zeros(8, 128, dtype=torch.bfloat16)
    wq = torch.zeros(128, 128, dtype=torch.int8)
    w = torch.zeros(128, 128, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        w8_matmul_cuda(x, wq, torch.ones(128))
    x160 = torch.zeros(160, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        w8_matmul_cuda(x160, wq, torch.ones(128))
    with pytest.raises(ValueError, match="CUDA"):
        stream_matmul_cuda(x160, w)
    with pytest.raises(ValueError, match="M=0"):
        w8_matmul_cuda(x[:0], wq, torch.ones(128))
    with pytest.raises(ValueError, match="M=0"):
        stream_matmul_cuda(x[:0], w)
    assert launch_counts()["w8_matmul"] == 0
    assert launch_counts()["stream_matmul"] == 0
