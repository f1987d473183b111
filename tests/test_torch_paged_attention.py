"""Paged attention and paged K/V writes in the PyTorch port
(paddle_tpu_torch/ops/paged_attention.py) against the JAX package: its
Pallas kernel in interpret mode and its jnp reference, on the CPU in fp32,
with the same numpy inputs — decode (W=1), verify windows (W=4) and the
prefill chunk behind earlier chunks, each with a poisoned scratch block."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import ops as jops
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import paged_attention as tpa

# online softmax (Pallas) and torch's einsum/softmax vs XLA's: fp32 values
# that differ only in summation order
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    jops.set_kernel_mode("auto")
    tops.set_kernel_mode("auto")


def _paged_case(seed=0, B=3, W=4, H=8, KV=2, D=64, N=16, bs=8,
                pos=(10, 17, 24), poison=True):
    """Block 0 is the (poisoned) scratch block; row positions sit mid-block,
    at a block boundary, and straddle blocks at W>1; tail table entries stay
    on scratch."""
    rng = np.random.default_rng(seed)
    M = max((p + W - 1) // bs + 1 for p in pos) + 1
    kp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    if poison:
        kp[0] = 1e9
        vp[0] = -1e9
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    took = 0
    for b in range(B):
        nblk = (pos[b] + W - 1) // bs + 1
        tables[b, :nblk] = free[took:took + nblk]
        took += nblk
    return q, kp, vp, tables, np.array(pos, np.int32)


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _jax_both(fn, *args):
    """(jnp reference, Pallas interpret) outputs of a JAX op."""
    ref = np.asarray(fn(*_jax(*args)))
    jops.set_kernel_mode("pallas")
    pallas = np.asarray(fn(*_jax(*args)))
    jops.set_kernel_mode("auto")
    return ref, pallas


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4), (4, 1)])
def test_verify_window_matches_jax(W, heads):
    H, KV = heads
    q, kp, vp, tables, pos = _paged_case(W=W, H=H, KV=KV)
    ref, pallas = _jax_both(jpa.paged_verify_attention, q, kp, vp, tables,
                            pos)
    out = tpa.paged_verify_attention(*_torch(q, kp, vp, tables, pos))
    out = out.numpy()
    assert np.isfinite(out).all()           # scratch poison held off
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_decode_matches_jax():
    q, kp, vp, tables, pos = _paged_case(W=1, pos=(7, 8, 31))
    ref, pallas = _jax_both(jpa.paged_decode_attention, q, kp, vp, tables,
                            pos)
    out = tpa.paged_decode_attention(*_torch(q, kp, vp, tables, pos)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


@pytest.mark.parametrize("start", [0, 16])
def test_prefill_chunk_behind_earlier_chunks_matches_jax(start):
    q, kp, vp, tables, _ = _paged_case(B=1, W=8, pos=(23,))
    tbl = tables[0]
    ref = np.asarray(jpa.paged_prefill_attention(*_jax(q, kp, vp, tbl),
                                                 jnp.int32(start)))
    jops.set_kernel_mode("pallas")
    pallas = np.asarray(jpa.paged_prefill_attention(*_jax(q, kp, vp, tbl),
                                                    jnp.int32(start)))
    jops.set_kernel_mode("auto")
    out = tpa.paged_prefill_attention(*_torch(q, kp, vp, tbl), start).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_gather_block_kv_is_exact():
    _, kp, _, tables, _ = _paged_case()
    ref = np.asarray(jpa.gather_block_kv(*_jax(kp, tables)))
    out = tpa.gather_block_kv(*_torch(kp, tables)).numpy()
    np.testing.assert_array_equal(out, ref)
    one = tpa.gather_block_kv(*_torch(kp, tables[1])).numpy()
    np.testing.assert_array_equal(one, ref[1:2])


def test_write_decode_kv_matches_jax_exactly_and_in_place():
    """Rows on distinct blocks plus one idle row parked on scratch (zeroed
    table, pos 0): the port's in-place scatter leaves exactly the pools the
    JAX functional scatter returns."""
    rng = np.random.default_rng(3)
    N, bs, KV, D, B, M = 12, 4, 2, 16, 4, 5
    kp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, D)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [1, 7]
    tables[2, :4] = [3, 4, 6, 8]
    pos = np.array([9, 4, 15, 0], np.int32)          # row 3 idle -> scratch
    jk, jv = jpa.write_decode_kv(*_jax(kp, vp, k, v, tables, pos))
    tk, tv, *rest = _torch(kp.copy(), vp.copy(), k, v, tables, pos)
    ok, ov = tpa.write_decode_kv(tk, tv, *rest)
    assert ok is tk and ov is tv                      # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), kp)


@pytest.mark.parametrize("start", [0, 8])
def test_write_chunk_kv_matches_jax_exactly(start):
    rng = np.random.default_rng(4)
    N, bs, KV, D, C = 10, 4, 2, 16, 8
    kp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    k = rng.standard_normal((C, KV, D)).astype(np.float32)
    v = rng.standard_normal((C, KV, D)).astype(np.float32)
    table = np.array([3, 8, 1, 6, 0, 0], np.int32)
    jk, jv = jpa.write_chunk_kv(*_jax(kp, vp, k, v, table), jnp.int32(start))
    tk, tv, tkk, tvv, ttab = _torch(kp, vp, k, v, table)
    tpa.write_chunk_kv(tk, tv, tkk, tvv, ttab, start)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_chunk_kv_refuses_unaligned_or_overflowing_chunks():
    kp = torch.zeros(4, 4, 1, 8)
    k = torch.ones(8, 1, 8)
    with pytest.raises(ValueError, match="multiples"):
        tpa.write_chunk_kv(kp, kp.clone(), k, k, torch.arange(4), 2)
    with pytest.raises(ValueError, match="no room"):
        tpa.write_chunk_kv(kp, kp.clone(), k, k,
                           torch.arange(3, dtype=torch.int32), 8)


@pytest.fixture(scope="module")
def plan_harness(tmp_path_factory):
    from tests.test_torch_paged_tiles import get_plan, plan_harness

    run = plan_harness(tmp_path_factory.mktemp("paged_plan"))
    return lambda *shape: get_plan(run, *shape)


@pytest.mark.parametrize("B,Wr,KV,M,want", [
    (8, 4, 8, 136, (17, 128)),    # Llama-3-8B decode at B=8
    (1, 512, 8, 136, (17, 128)),  # prefill chunk 128: 8 tiles of 64 rows
    (1, 4, 8, 3, (1, 128)),       # never more splits than the table needs
    (2, 16, 2, 40, (5, 128))])    # a verify window of 16 rows
def test_context_splits_cover_the_table_once(plan_harness, B, Wr, KV, M,
                                             want):
    """The kernel's plan (``csrc/paged_tiles.cuh``) splits a table of M
    entries of 16 keys into (splits, keys a split) at the fewest keys a
    split takes, from shapes alone: every key in one split (a launch's
    splits are as long or longer, so never more of them)."""
    p = plan_harness(B, Wr // 4, 4 * KV, KV, 16, M)
    S, keys = p["splits"], p["split_keys"]
    assert (S, keys) == want
    assert S * keys >= M * 16 and (S - 1) * keys < M * 16


def test_cuda_wrapper_refuses_cpu_tensors():
    """No silent CPU fallback inside the kernel wrapper."""
    from paddle_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    q, kp, vp, tables, pos = _torch(*_paged_case(W=1))
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, kp, vp, tables, pos)
    tpa.paged_verify_attention(q, kp, vp, tables, pos)
    assert tops.launch_counts()["paged_attention"] == 0
