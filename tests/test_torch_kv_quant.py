"""The int8 KV pool in the PyTorch port (``ops/paged_attention.py`` int8
half, ``GenerationServer(kv_quant="int8", pool_bytes=)``) against the JAX
package on the CPU in fp32: block quantization and the quantizing writes
bitwise, the fused-dequant attention against JAX's Pallas kernel
(interpret mode) and its jnp reference with a poisoned scratch block, and
the int8 server's greedy tokens against the JAX int8 server's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference.serving import (GenerationServer,
                                                kv_block_bytes)
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa

# online softmax (Pallas) and torch's einsum/softmax vs XLA's: fp32 values
# that differ only in summation order
TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")


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


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _quant_case(seed=0, B=3, W=4, H=8, KV=2, D=64, N=16, bs=8,
                pos=(10, 17, 24)):
    """int8 pools quantized from random K/V; scratch block 0 poisoned with
    full codes at a huge scale; tail table entries on scratch."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jpa.quantize_block_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jpa.quantize_block_kv(jnp.asarray(v)))
    kq, vq, ks, vs = kq.copy(), vq.copy(), ks.copy(), vs.copy()
    kq[0], vq[0] = 127, -127
    ks[0], vs[0] = 1e9, 1e9
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    M = max((p + W - 1) // bs + 1 for p in pos) + 1
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    took = 0
    for b in range(B):
        nblk = (pos[b] + W - 1) // bs + 1
        tables[b, :nblk] = free[took:took + nblk]
        took += nblk
    return q, kq, ks, vq, vs, tables, np.array(pos, np.int32)


def test_quantize_block_kv_is_bitwise_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 4, 2, 16)).astype(np.float32)
    x[2] = 0.0                                  # all-zero block: scale floor
    jq, js = jpa.quantize_block_kv(jnp.asarray(x))
    tq, ts = tpa.quantize_block_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpa.dequantize_block_kv(tq, ts).numpy(),
        np.asarray(jpa.dequantize_block_kv(jq, js)))


def test_insert_token_keeps_codes_until_an_outlier_rescales():
    """A token inside every head's absmax leaves the scale unchanged and the
    other codes bit for bit; a late outlier raises the scale and re-codes
    the block — each exactly as JAX does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 4, 2, 16)).astype(np.float32)
    x[1, 2] = x[3, 0] = 0.0         # the slots written below hold no absmax
    tq, ts = tpa.quantize_block_kv(torch.from_numpy(x))
    q0, s0 = tq.clone(), ts.clone()
    bid = np.array([1, 3], np.int32)
    off = np.array([2, 0], np.int32)
    small = (0.01 * rng.standard_normal((2, 2, 16))).astype(np.float32)
    jq, js = jpa._insert_token_q(jnp.asarray(tq.numpy()),
                                 jnp.asarray(ts.numpy()), jnp.asarray(small),
                                 jnp.asarray(bid), jnp.asarray(off))
    tpa._insert_token_q(tq, ts, *_t(small, bid, off))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ts.numpy(), s0.numpy())   # scale unchanged
    keep = np.ones((4, 4), bool)
    keep[1, 2] = keep[3, 0] = False
    np.testing.assert_array_equal(tq.numpy()[keep], q0.numpy()[keep])
    big = np.full((2, 2, 16), 50.0, np.float32)             # late outlier
    jq, js = jpa._insert_token_q(jnp.asarray(tq.numpy()),
                                 jnp.asarray(ts.numpy()), jnp.asarray(big),
                                 jnp.asarray(bid), jnp.asarray(off))
    tpa._insert_token_q(tq, ts, *_t(big, bid, off))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy()[bid] > s0.numpy()[bid]).all()


@pytest.mark.parametrize("W", [1, 3])
def test_write_window_kv_q_is_bitwise_jax_and_in_place(W):
    rng = np.random.default_rng(3)
    N, bs, KV, D, B, M = 12, 4, 2, 16, 4, 5
    kq, ks = (a.numpy() for a in tpa.quantize_block_kv(
        torch.from_numpy(rng.standard_normal((N, bs, KV, D))
                         .astype(np.float32))))
    vq, vs = (a.numpy() for a in tpa.quantize_block_kv(
        torch.from_numpy(rng.standard_normal((N, bs, KV, D))
                         .astype(np.float32))))
    k = rng.standard_normal((B, W, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, W, KV, D)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [1, 7]
    tables[2, :4] = [3, 4, 6, 8]
    pos = np.array([6, 3, 13, 0], np.int32)          # row 3 idle -> scratch
    want = jpa.write_window_kv_q(*_j(kq, ks, vq, vs, k, v, tables, pos))
    got = _t(kq, ks, vq, vs)
    out = tpa.write_window_kv_q(*got, *_t(k, v, tables, pos))
    assert all(a is b for a, b in zip(out, got))      # updated in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if W == 1:
        want = jpa.write_decode_kv_q(*_j(kq, ks, vq, vs, k[:, 0], v[:, 0],
                                         tables, pos))
        got = _t(kq, ks, vq, vs)
        tpa.write_decode_kv_q(*got, *_t(k[:, 0], v[:, 0], tables, pos))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("start", [0, 8])
def test_write_chunk_kv_q_is_bitwise_jax(start):
    rng = np.random.default_rng(4)
    N, bs, KV, D, C = 10, 4, 2, 16, 8
    kq = np.zeros((N, bs, KV, D), np.int8)
    ks = np.zeros((N, KV), np.float32)
    k = rng.standard_normal((C, KV, D)).astype(np.float32)
    v = rng.standard_normal((C, KV, D)).astype(np.float32)
    table = np.array([3, 8, 1, 6, 0, 0], np.int32)
    want = jpa.write_chunk_kv_q(*_j(kq, ks, kq, ks, k, v, table),
                                jnp.int32(start))
    got = _t(kq, ks, kq, ks)
    tpa.write_chunk_kv_q(*got, *_t(k, v, table), start)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="multiples"):
        tpa.write_chunk_kv_q(*got, *_t(k, v, table), 2)


def test_gather_block_scales_is_exact():
    _, _, ks, _, _, tables, _ = _quant_case()
    want = np.asarray(jpa.gather_block_scales(*_j(ks, tables), 8))
    got = tpa.gather_block_scales(*_t(ks, tables), 8).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_both(fn, *args):
    """(jnp reference, Pallas interpret) outputs of a JAX op."""
    ref = np.asarray(fn(*_j(*args)))
    jops.set_kernel_mode("pallas")
    pallas = np.asarray(fn(*_j(*args)))
    jops.set_kernel_mode("auto")
    return ref, pallas


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4)])
def test_verify_attention_q_matches_jax(W, heads):
    """The plain twin (v-scale on fp32 p, the Pallas kernel's order) against
    the Pallas kernel and the jnp reference (v-scale after the cast; the
    same in fp32)."""
    H, KV = heads
    args = _quant_case(W=W, H=H, KV=KV)
    ref, pallas = _jax_both(jpa.paged_verify_attention_q, *args)
    out = tpa.paged_verify_attention_q(*_t(*args)).numpy()
    assert np.isfinite(out).all()           # scratch poison held off
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)
    if W == 1:
        dec = tpa.paged_decode_attention_q(*_t(*args)).numpy()
        np.testing.assert_array_equal(dec, out)


@pytest.mark.parametrize("start", [0, 16])
def test_prefill_attention_q_behind_earlier_chunks_matches_jax(start):
    q, kq, ks, vq, vs, tables, _ = _quant_case(B=1, W=8, pos=(23,))
    tbl = tables[0]
    args = (q, kq, ks, vq, vs, tbl)
    ref = np.asarray(jpa.paged_prefill_attention_q(*_j(*args),
                                                   jnp.int32(start)))
    jops.set_kernel_mode("pallas")
    pallas = np.asarray(jpa.paged_prefill_attention_q(*_j(*args),
                                                      jnp.int32(start)))
    jops.set_kernel_mode("auto")
    out = tpa.paged_prefill_attention_q(*_t(*args), start).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_int8_cuda_wrapper_refuses_cpu_tensors():
    from paddle_tpu_torch.ops.paged_attention_cuda import \
        paged_attention_int8_cuda

    args = _t(*_quant_case(W=1, D=128))
    args[0] = args[0].to(torch.bfloat16)         # the kernel's q dtype
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_int8_cuda(*args)
    tpa.paged_verify_attention_q(*args)
    assert tops.launch_counts()["paged_attention_int8"] == 0


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def test_int8_server_greedy_tokens_match_jax(models):
    """6 requests through 2 slots with multi-chunk prompts, a repeated
    prompt (prefix hits on int8 blocks) and slots refilled mid-flight."""
    jm, tm = models
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 128, (13,)).tolist()
    prompts = [rng.randint(1, 128, (n,)).tolist() for n in (5, 12, 20)]
    prompts += [shared, rng.randint(1, 128, (7,)).tolist(), shared]
    news = [8, 5, 7, 6, 8, 6]
    kw = dict(max_batch=2, max_len=64, block_size=4, prefill_chunk=8,
              kv_quant="int8")
    js = JServer(jm, cache="paged", **kw)
    jr = [js.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    jo = js.run()
    ts = GenerationServer(tm, cache="paged", device="cpu", **kw)
    tr = [ts.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    to = ts.run()
    assert [to[r] for r in tr] == [jo[r] for r in jr]
    st = ts.kv_stats()
    assert st["kv_quant"] == "int8" and st["blocks_in_use"] == 0
    assert st["prefix_hit_blocks"] == (len(shared) - 1) // 4
    pools = ts._exec.pools[0]
    assert [p.dtype for p in pools] == [torch.int8, torch.float32] * 2


def test_pool_bytes_budget_gives_about_2x_blocks(models):
    _, tm = models
    cfg = tm.cfg
    budget = 40 * kv_block_bytes(cfg, 8, "none")
    fp = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                          max_len=64,
                          block_size=8, pool_bytes=budget)
    q = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                         max_len=64,
                         block_size=8, kv_quant="int8", pool_bytes=budget)
    assert fp.alloc.num_blocks == 40
    # fp32 model: ~3.9x; a bf16 model ~2x
    assert q.alloc.num_blocks >= 1.8 * fp.alloc.num_blocks
    bf16 = LlamaConfig(**{**SMALL, "dtype": "bfloat16"})
    ratio = kv_block_bytes(bf16, 16, "none") / kv_block_bytes(bf16, 16,
                                                              "int8")
    assert 1.9 < ratio <= 2.0


def test_kv_quant_ctor_validation(models):
    _, tm = models
    with pytest.raises(ValueError, match="kv_quant"):
        GenerationServer(tm, cache="paged", device="cpu", max_len=64,
                         kv_quant="fp8")
    with pytest.raises(ValueError, match="not both"):
        GenerationServer(tm, cache="paged", device="cpu", max_len=64,
                         num_blocks=8,
                         pool_bytes=1 << 20)
    srv = GenerationServer(tm, cache="paged", device="cpu", max_len=64,
                           kv_quant="int8")
    assert srv.alloc.kv_quant == "int8"
