"""The port's serving slice as a whole against the JAX package, on the CPU
in fp32: a JAX ``LlamaForCausalLM`` (GQA) carried across with
``params_from_jax``; the paged prefill chunk and decode step agree in hidden
states and logits, and greedy ``GenerationServer(cache="paged")`` tokens
are identical to the JAX server's on the same requests. Also the ported
host-side pieces (block allocator, sampling) against their JAX originals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference.paged_cache import BlockAllocator as JAlloc
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.inference.paged_cache import BlockAllocator
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.convert import param_shapes, params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
# fp32 models; torch and XLA sum in other orders
TOL = dict(rtol=1e-4, atol=1e-5)


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
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm, state


def test_params_from_jax_carries_every_parameter(models):
    _, tm, state = models
    sd = tm.state_dict()
    assert set(sd) == set(state) == set(param_shapes(tm.cfg))
    for name, arr in state.items():
        np.testing.assert_array_equal(sd[name].numpy(), arr)
    bad = dict(state)
    bad.pop("lm_head.weight")
    with pytest.raises(KeyError):
        params_from_jax(bad, tm.cfg)


def test_paged_prefill_chunks_and_decode_match_jax(models):
    """Two prefill chunks (the second behind the first, right-padded) then
    two batched decode ticks with an idle row parked on scratch."""
    jm, tm, _ = models
    rng = np.random.default_rng(0)
    N, bs, KV, D = 12, 4, 2, 16
    C, n = 8, 13                                   # prompt 13 = 8 + 5 pad
    prompt = rng.integers(1, 128, n).astype(np.int32)
    table = np.array([3, 7, 1, 9, 5, 0, 0, 0], np.int32)
    jpools = [(Tensor(jnp.zeros((N, bs, KV, D), jnp.float32)),
               Tensor(jnp.zeros((N, bs, KV, D), jnp.float32)))
              for _ in range(2)]
    tpools = [(torch.zeros(N, bs, KV, D), torch.zeros(N, bs, KV, D))
              for _ in range(2)]
    for start in (0, C):
        chunk = np.zeros((1, C), np.int32)
        part = prompt[start:start + C]
        chunk[0, :len(part)] = part
        jh, jpools = jm.model.paged_prefill_chunk(
            Tensor(jnp.asarray(chunk)), jpools, jnp.asarray(table),
            jnp.int32(start))
        th, _ = tm.model.paged_prefill_chunk(
            torch.from_numpy(chunk).long(), tpools, torch.from_numpy(table),
            start)
        valid = len(part)
        np.testing.assert_allclose(th.numpy()[:, :valid],
                                   np.asarray(jh.value)[:, :valid], **TOL)
        np.testing.assert_allclose(tm.head(th).numpy()[:, :valid],
                                   np.asarray(jm.lm_head(jh).value)[:, :valid],
                                   **TOL)
    tables = np.stack([table, np.zeros_like(table)])   # row 1 idle
    tok = np.array([[int(prompt[-1])], [0]], np.int32)
    for t in range(2):
        pos = np.array([n + t, 0], np.int32)
        jh, jpools = jm.model.paged_decode_step(
            Tensor(jnp.asarray(tok)), jpools, jnp.asarray(tables),
            jnp.asarray(pos))
        th, _ = tm.model.paged_decode_step(
            torch.from_numpy(tok).long(), tpools, torch.from_numpy(tables),
            torch.from_numpy(pos))
        jl = np.asarray(jm.lm_head(jh).value)
        tl = tm.head(th).numpy()
        np.testing.assert_allclose(th.numpy()[0], np.asarray(jh.value)[0],
                                   **TOL)
        np.testing.assert_allclose(tl[0], jl[0], **TOL)
        tok = np.array([[int(np.argmax(jl[0, 0]))], [0]], np.int32)
    # the K/V both sides wrote to the live blocks agree
    live = table[:5]
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy()[live],
                                   np.asarray(jk.value)[live], **TOL)
        np.testing.assert_allclose(tv.numpy()[live],
                                   np.asarray(jv.value)[live], **TOL)


def _serve_both(models, prompts, max_new, **kw):
    jm, tm, _ = models
    js = JServer(jm, cache="paged", **kw)
    jr = [js.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    jo = js.run()
    ts = GenerationServer(tm, cache="paged", device="cpu", **kw)
    tr = [ts.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    to = ts.run()
    return [jo[r] for r in jr], [to[r] for r in tr], ts


def test_greedy_serving_tokens_identical_to_jax_under_churn(models):
    """6 requests through 2 slots: multi-chunk prompts (20 > chunk 8), some
    ending mid-block, and slots refilled mid-flight."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, (n,)).tolist()
               for n in (5, 12, 7, 3, 12, 20)]
    news = [8, 5, 8, 6, 8, 7]
    jax_out, torch_out, ts = _serve_both(
        models, prompts, news, max_batch=2, max_len=64, block_size=4,
        prefill_chunk=8)
    assert torch_out == jax_out
    for p, m, out in zip(prompts, news, torch_out):
        assert out[:len(p)] == p and len(out) == len(p) + m
    assert ts.kv_stats()["blocks_in_use"] == 0
    st = ts.throughput_stats()
    assert st["prefill_tokens"] == sum(map(len, prompts))
    assert st["decode_tokens"] == sum(m - 1 for m in news)


def test_greedy_serving_with_prefix_hits_and_eos_matches_jax(models):
    """A repeated prompt reuses its cached full blocks, and an eos taken from
    an earlier run truncates a request — both exactly as the JAX server."""
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, (17,)).tolist()
    prompts = [shared, rng.randint(1, 128, (9,)).tolist(), shared]
    _, torch_out, _ = _serve_both(models, prompts, [6, 6, 6], max_batch=2,
                                  max_len=48, block_size=4, prefill_chunk=8)
    eos = torch_out[0][len(shared) + 2]
    jax_out, torch_out, ts = _serve_both(
        models, prompts, [6, 6, 6], max_batch=2, max_len=48, block_size=4,
        prefill_chunk=8, eos_token_id=eos)
    assert torch_out == jax_out
    assert len(torch_out[0]) < len(shared) + 6        # eos truncated it
    assert ts.kv_stats()["prefix_hit_blocks"] == (len(shared) - 1) // 4


def test_sampled_slot_leaves_greedy_slot_unchanged(models):
    _, tm, _ = models
    rng = np.random.RandomState(3)
    pg, ps = (rng.randint(1, 128, 6).tolist() for _ in range(2))
    alone = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                             max_len=64,
                             block_size=4, prefill_chunk=8)
    rg = alone.submit(pg, max_new_tokens=6)
    want = alone.run()[rg]
    srv = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                           max_len=64,
                           block_size=4, prefill_chunk=8, seed=11)
    rg = srv.submit(pg, max_new_tokens=6)
    rs = srv.submit(ps, max_new_tokens=6, temperature=0.9, top_k=20,
                    top_p=0.9)
    out = srv.run()
    assert out[rg] == want
    assert len(out[rs]) == 12 and all(0 <= t < 128 for t in out[rs][6:])


def test_block_allocator_matches_jax_allocator():
    """The copied allocator hands out, shares, caches and evicts blocks
    exactly as the JAX package's on one op sequence."""
    a, b = JAlloc(8, 4), BlockAllocator(8, 4)
    toks = list(range(1, 14))
    for al in (a, b):
        al.trace = []
        t1 = [al.alloc() for _ in range(3)]
        for i, h in enumerate(al.chain_hashes(toks)[:3]):
            al.register(t1[i], h)
        al.trace.append(list(t1))
        for bid in t1:
            al.free(bid)
        al.trace.append(al.probe_prefix(toks))
        # 4 free blocks, then the coldest cached prefix block is evicted
        al.trace.append([al.alloc() for _ in range(5)])
        al.trace.append(al.match_prefix(toks))      # chain broken: no hit
        al.trace.append([al.alloc() for _ in range(2)])
        al.trace.append({k: al.stats()[k] for k in (
            "blocks_in_use", "blocks_cached", "blocks_free", "evictions",
            "prefix_hit_blocks", "fresh_allocs", "peak_blocks_in_use")})
    assert a.trace == b.trace
    for al in (a, b):
        with pytest.raises(RuntimeError, match="exhausted"):
            al.alloc()


def test_sampling_filters_match_jax():
    rng = np.random.default_rng(9)
    lg = rng.standard_normal((4, 50)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    ks = np.array([0, 5, 0, 12], np.int32)
    ps = np.array([0.0, 0.0, 0.8, 0.6], np.float32)
    want = np.asarray(jgen.filtered_logits_rows(
        jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(ks),
        jnp.asarray(ps)))
    got = tgen.filtered_logits_rows(*(torch.from_numpy(a)
                                      for a in (lg, temps, ks, ps)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    t = torch.from_numpy(lg)
    greedy = tgen.next_token(t, g, 0.0, 0)
    np.testing.assert_array_equal(greedy.numpy(), lg.argmax(-1))
    # top-k 1 leaves one token: sampling must pick the argmax
    np.testing.assert_array_equal(tgen.next_token(t, g, 0.8, 1).numpy(),
                                  lg.argmax(-1))
    rows = tgen.sample_token_rows(t, g, torch.from_numpy(temps),
                                  torch.ones(4, dtype=torch.int32),
                                  torch.zeros(4))
    np.testing.assert_array_equal(rows.numpy(), lg.argmax(-1))


def test_next_token_top_k_past_vocab_keeps_every_token():
    """top_k larger than the vocabulary keeps every token, as the JAX
    ``next_token``'s clamped index does: with one seed, top_k = 20 draws
    what top_k = V = 8 and no top-k filter draw, on both sides."""
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((2, 8)).astype(np.float32) * 2
    key = jax.random.PRNGKey(0)
    jtok = {k: np.asarray(jgen.next_token(jnp.asarray(lg), key, 0.9, k)[0])
            for k in (20, 8, 0)}
    np.testing.assert_array_equal(jtok[20], jtok[8])
    np.testing.assert_array_equal(jtok[20], jtok[0])
    ttok = {k: tgen.next_token(torch.from_numpy(lg),
                               torch.Generator().manual_seed(5), 0.9,
                               k).numpy() for k in (20, 8, 0)}
    np.testing.assert_array_equal(ttok[20], ttok[8])
    np.testing.assert_array_equal(ttok[20], ttok[0])
    assert ttok[20].dtype == np.int32 and ttok[20].shape == (2,)


def test_sampled_request_with_top_k_past_vocab_completes(models):
    """A sampled request whose top_k exceeds the vocabulary is served to
    its full length (it raised at its first token before)."""
    _, tm, _ = models
    srv = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                           max_len=64,
                           block_size=4, prefill_chunk=8, seed=2)
    prompt = list(range(1, 7))
    rid = srv.submit(prompt, max_new_tokens=5, temperature=0.8,
                     top_k=1000)
    out = srv.run()[rid]
    assert out[:6] == prompt and len(out) == 11
    assert all(0 <= t < SMALL["vocab_size"] for t in out[6:])
