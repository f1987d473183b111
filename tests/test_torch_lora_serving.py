"""Multi-tenant LoRA serving in the PyTorch port (``nn/lora.py``,
``inference/lora.py``, ``GenerationServer(lora=...)``) against the JAX
package on the CPU in fp32: the fused LoRA matmul's plain twin against
JAX's Pallas ``fused_lora_matmul`` (interpret mode), the adapter pool's
page lifecycle against JAX's on one script, and heterogeneous-adapter
serving token-exact against each adapter's merged model served alone (and
against the JAX server's tokens) for an fp and an int8 KV pool. Also the
prefix cache across adapters: the JAX server shares a prompt block's K/V
between adapters (a fault of the reference, shown here); the port keys
blocks by adapter and stays exact."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.inference import AdapterRegistry as JRegistry
from paddle_tpu.inference import GenerationServer as JServer
from paddle_tpu.inference import LoRAConfig as JLoRAConfig
from paddle_tpu.inference.lora import AdapterPool as JPool
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn import lora as jlora
from paddle_tpu.ops.paged_attention_pallas import fused_lora_matmul
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference.lora import (LORA_TARGETS, AdapterPool,
                                             AdapterRegistry, LoRAConfig,
                                             adapter_page_bytes, target_dims)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import lora as tlora
from paddle_tpu_torch.ops.stream_matmul import stream_matmul

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
# fp32: the same products summed in another order
TOL = dict(rtol=1e-5, atol=1e-5)
_TGT_MODS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
SERVE = dict(max_len=64, block_size=4, prefill_chunk=8)


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


def _adapter_weights(cfg, rank, seed, sd=(0.02, 0.05)):
    rng = np.random.RandomState(seed)
    dims = target_dims(cfg)
    w = {}
    for layer in range(cfg.num_hidden_layers):
        for t in LORA_TARGETS:
            fi, fo = dims[t]
            w[(layer, t)] = (
                rng.normal(0, sd[0], (fi, rank)).astype(np.float32),
                rng.normal(0, sd[1], (rank, fo)).astype(np.float32))
    return w


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _merged(tm, weights, rank, alpha):
    """The port model with each target's ``(alpha / rank) · A @ B`` folded
    into its weight."""
    m = copy.deepcopy(tm)
    s = alpha / rank
    with torch.no_grad():
        for (layer, t), (A, B) in weights.items():
            mod = m.model.layers[layer]
            for part in _TGT_MODS[t].split("."):
                mod = getattr(mod, part)
            mod.weight += torch.from_numpy(s * (A @ B))
    return m


def _registries(entries):
    """The same adapters registered with the JAX and the port registry."""
    jr, tr = JRegistry(), AdapterRegistry()
    for name, w, rank, alpha in entries:
        jr.register(name, w, rank=rank, alpha=alpha)
        tr.register(name, w, rank=rank, alpha=alpha)
    return jr, tr


@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("S", [1, 5])
def test_lora_matmul_plain_matches_pallas_fused_lora(rank, S):
    """Batch of 3: two adapter rows with rank ``rank`` padded to max_rank 4
    and one null row (zero factors, s = 0), which comes out exactly as the
    decode path's plain projection."""
    rng = np.random.default_rng(rank + S)
    E, IN, OUT, R = 3, 64, 96, 4
    x = rng.standard_normal((E, S, IN)).astype(np.float32)
    w = (rng.standard_normal((IN, OUT)) * 0.05).astype(np.float32)
    A = np.zeros((E, IN, R), np.float32)
    B = np.zeros((E, R, OUT), np.float32)
    A[:2, :, :rank] = rng.standard_normal((2, IN, rank)) * 0.1
    B[:2, :rank] = rng.standard_normal((2, rank, OUT)) * 0.1
    s = np.array([2.0, 0.5, 0.0], np.float32)
    jops.set_kernel_mode("pallas")
    want = np.asarray(fused_lora_matmul(*(jnp.asarray(a)
                                          for a in (x, w, A, B, s))))
    jops.set_kernel_mode("auto")
    t = [torch.from_numpy(a) for a in (x, w, A, B, s)]
    got = tlora.lora_matmul(t[0], t[1], tuple(t[2:]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the null row is the decode path's plain projection (the batch-
    # invariant streaming product, whose K slices the twin sums)
    plain = torch.matmul(t[0], t[1])
    np.testing.assert_array_equal(
        got[2].numpy(), stream_matmul(t[0], t[1])[2].numpy())
    np.testing.assert_array_equal(tlora.lora_matmul(t[0], t[1], None).numpy(),
                                  plain.numpy())
    # the delta alone, as JAX's bgmv
    jd = np.asarray(jlora.bgmv(paddle.to_tensor(x),
                               tuple(jnp.asarray(a) for a in (A, B, s)))
                    .value)
    np.testing.assert_allclose(tlora.bgmv(t[0], tuple(t[2:])).numpy(), jd,
                               **TOL)


def test_adapter_pool_lifecycle_matches_jax(models):
    """acquire / release / LRU retention / pin / eviction under pressure /
    re-registration, one script on both pools; then the gathered factors
    and their in-place pool form agree."""
    jm, tm = models
    entries = [(f"a{i}", _adapter_weights(tm.cfg, 2 + i % 2, seed=20 + i),
                2 + i % 2, 4.0) for i in range(4)]
    jr, tr = _registries(entries)
    jp = JPool(jm.cfg, JLoRAConfig(jr, max_live_adapters=2, max_rank=4))
    tp = AdapterPool(tm.cfg, LoRAConfig(tr, max_live_adapters=2, max_rank=4),
                     device="cpu")
    assert tp.page_bytes == jp.page_bytes == adapter_page_bytes(tm.cfg, 4)

    def script(p, reg):
        out = []
        p0, p1 = p.acquire("a0"), p.acquire("a1")
        out.append((p0, p1, p.can_acquire("a2")))        # both pages live
        p.release(p0)
        p.release(p1)                                    # cached, a0 coldest
        out.append((p.acquire("a0"), p.hits))            # warm hit
        p.release(p0)
        p.pin("a1")
        p2 = p.acquire("a2")                             # evicts a0, not a1
        out.append((p2, p.is_resident("a0"), p.is_resident("a1")))
        out.append(p.can_acquire("a3"))                  # a2 live, a1 pinned
        with pytest.raises(RuntimeError, match="exhausted"):
            p.acquire("a3")
        p.unpin("a1")
        p.release(p2)
        p.warm(["a2"])                                   # a2 evicts last
        p3 = p.acquire("a3")
        out.append((p3, p.is_resident("a1"), p.is_resident("a2")))
        reg.unregister("a2")
        reg.register("a2", entries[0][1], rank=2, alpha=8.0)
        out.append((p.acquire("a2"), p.uploads))         # stale page: upload
        st = p.stats()
        out.append({k: st[k] for k in ("adapter_hits", "adapter_uploads",
                                       "adapter_evictions",
                                       "adapters_resident")})
        return out

    assert script(tp, tr) == script(jp, jr)
    idx = np.array([2, 0, 1], np.int32)
    want = jp.gather_rows(jp.device_tensors(), jnp.asarray(idx))
    got = tp.gather_rows(torch.from_numpy(idx))
    pooled = tp.layer_factors(torch.from_numpy(idx))
    for layer in range(tm.cfg.num_hidden_layers):
        for t in LORA_TARGETS:
            for g, w_, p_ in zip(got[layer][t], want[layer][t],
                                 pooled[layer][t].gather()):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
                np.testing.assert_array_equal(p_.numpy(), g.numpy())


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_multi_adapter_batch_matches_merged_models_and_jax(models, kv_quant):
    """Two adapters of different rank plus an adapterless row decoding in
    one batch: each emits exactly the tokens of its merged model served
    alone, and the same tokens as the JAX server."""
    jm, tm = models
    w1 = _adapter_weights(tm.cfg, 4, seed=1)
    w2 = _adapter_weights(tm.cfg, 2, seed=2)
    jr, tr = _registries([("a1", w1, 4, 8.0), ("a2", w2, 2, 2.0)])
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, (n,)).tolist() for n in (6, 4, 9)]
    adapters = ["a1", "a2", None]
    kw = dict(max_batch=3, kv_quant=kv_quant, **SERVE)
    srv = GenerationServer(tm, cache="paged", device="cpu",
                           lora=LoRAConfig(tr, max_live_adapters=4,
                                           max_rank=4), **kw)
    rids = [srv.submit(p, max_new_tokens=8, adapter=a)
            for p, a in zip(prompts, adapters)]
    out = srv.run()
    js = JServer(jm, cache="paged",
                 lora=JLoRAConfig(jr, max_live_adapters=4, max_rank=4), **kw)
    jrids = [js.submit(p, max_new_tokens=8, adapter=a)
             for p, a in zip(prompts, adapters)]
    jout = js.run()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    for rid, w, meta, p in ((rids[0], w1, (4, 8.0), prompts[0]),
                            (rids[1], w2, (2, 2.0), prompts[1]),
                            (rids[2], None, None, prompts[2])):
        ref_model = tm if w is None else _merged(tm, w, *meta)
        ref = GenerationServer(ref_model, cache="paged", device="cpu",
                               max_batch=1,
                               kv_quant=kv_quant, **SERVE)
        rr = ref.submit(p, max_new_tokens=8)
        assert out[rid] == ref.run()[rr], (kv_quant, meta)
    assert srv.alloc.blocks_in_use == 0
    assert srv._lora.alloc.blocks_in_use == 0
    assert srv.adapter_stats()["adapter_uploads"] == 2


def _shared_prompt_case(tm):
    """Two adapters (all seven targets, k and v included) with deltas large
    enough to move greedy tokens, and a prompt of two full blocks plus one
    token (the last-token rule leaves two blocks to share)."""
    w1 = _adapter_weights(tm.cfg, 4, seed=11, sd=(0.1, 0.1))
    w2 = _adapter_weights(tm.cfg, 4, seed=12, sd=(0.1, 0.1))
    prompt = np.random.RandomState(9).randint(1, 128, (9,)).tolist()
    return w1, w2, prompt


def _serve_in_turn(srv, prompt, names):
    out = []
    for name in names:
        rid = srv.submit(prompt, max_new_tokens=8, adapter=name)
        out.append(srv.run()[rid])
    return out


def test_reference_fault_jax_prefix_cache_shares_blocks_across_adapters(
        models):
    """The JAX server hashes prompt tokens only: the second request reuses
    K/V that the first computed under another adapter, and its tokens
    differ from its own merged model's."""
    jm, tm = models
    w1, w2, prompt = _shared_prompt_case(tm)
    jr, _ = _registries([("a1", w1, 4, 8.0), ("a2", w2, 4, 8.0)])
    js = JServer(jm, cache="paged", max_batch=1,
                 lora=JLoRAConfig(jr, max_live_adapters=2, max_rank=4),
                 **SERVE)
    _, second = _serve_in_turn(js, prompt, ["a1", "a2"])
    assert js.alloc.stats()["prefix_hit_blocks"] == 2   # shared across a1/a2
    ref = GenerationServer(_merged(tm, w2, 4, 8.0), cache="paged",
                           device="cpu",
                           max_batch=1, **SERVE)
    rr = ref.submit(prompt, max_new_tokens=8)
    want = ref.run()[rr]
    assert second != want


def test_port_prefix_cache_keys_blocks_by_adapter(models):
    """The port seeds each request's block chain with its adapter: a1 then
    a2 on one prompt share nothing, a2 again hits its own blocks, and every
    answer is its merged model's."""
    _, tm = models
    w1, w2, prompt = _shared_prompt_case(tm)
    _, tr = _registries([("a1", w1, 4, 8.0), ("a2", w2, 4, 8.0)])
    srv = GenerationServer(tm, cache="paged", device="cpu", max_batch=1,
                           lora=LoRAConfig(tr, max_live_adapters=2,
                                           max_rank=4), **SERVE)
    first, second = _serve_in_turn(srv, prompt, ["a1", "a2"])
    assert srv.kv_stats()["prefix_hit_blocks"] == 0
    third, plain = _serve_in_turn(srv, prompt, ["a2", None])
    assert srv.kv_stats()["prefix_hit_blocks"] == 2     # a2's own blocks
    for got, w in ((first, w1), (second, w2), (third, w2)):
        ref = GenerationServer(_merged(tm, w, 4, 8.0), cache="paged",
                               device="cpu",
                               max_batch=1, **SERVE)
        rr = ref.submit(prompt, max_new_tokens=8)
        assert got == ref.run()[rr]
    ref = GenerationServer(tm, cache="paged", device="cpu", max_batch=1,
                           **SERVE)
    rr = ref.submit(prompt, max_new_tokens=8)
    assert plain == ref.run()[rr]


def test_submit_adapter_validation(models):
    _, tm = models
    plain = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                             **SERVE)
    with pytest.raises(ValueError, match="lora=LoRAConfig"):
        plain.submit([1, 2, 3], max_new_tokens=4, adapter="a1")
    reg = AdapterRegistry()
    reg.register("ok", _adapter_weights(tm.cfg, 2, seed=1), rank=2,
                 alpha=4.0)
    reg.register("fat", _adapter_weights(tm.cfg, 8, seed=2), rank=8,
                 alpha=8.0)
    bad = _adapter_weights(tm.cfg, 2, seed=3)
    A, B = bad[(0, "q")]
    bad[(0, "q")] = (A[:-1], B)          # wrong in_features
    reg.register("misshapen", bad, rank=2, alpha=4.0)
    srv = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                           lora=LoRAConfig(reg, max_live_adapters=2,
                                           max_rank=4), **SERVE)
    with pytest.raises(ValueError, match="unknown adapter"):
        srv.submit([1, 2, 3], max_new_tokens=4, adapter="nope")
    with pytest.raises(ValueError, match="exceeds the pool's max_rank"):
        srv.submit([1, 2, 3], max_new_tokens=4, adapter="fat")
    with pytest.raises(ValueError, match="shape"):
        srv.submit([1, 2, 3], max_new_tokens=4, adapter="misshapen")
    assert len(srv._sched) == 0
    rid = srv.submit([1, 2, 3], max_new_tokens=4, adapter="ok")
    assert len(srv.run()[rid]) == 7
    with pytest.raises(ValueError, match="max_rank"):
        LoRAConfig(reg, max_rank=0).validate()


def test_int8_weights_with_lora_raise(models):
    """As in the JAX package, LoRA is served over fp base weights only."""
    _, tm = models
    q = copy.deepcopy(tm).quantize_int8()
    reg = AdapterRegistry()
    w = _adapter_weights(tm.cfg, 2, seed=1)
    reg.register("a", w, rank=2, alpha=4.0)
    with pytest.raises(NotImplementedError, match="int8"):
        GenerationServer(q, cache="paged", device="cpu", lora=LoRAConfig(reg),
                         **SERVE)
    pool = AdapterPool(tm.cfg, LoRAConfig(reg, max_rank=2), device="cpu")
    page = torch.tensor([pool.acquire("a")], dtype=torch.int32)
    lora = pool.layer_factors(page)
    x = torch.zeros(1, 1, tm.cfg.hidden_size)
    with pytest.raises(NotImplementedError, match="int8"):
        q.model.layers[0].mlp(x, lora[0])
    with pytest.raises(NotImplementedError, match="int8"):
        q.model.layers[0].self_attn._qkv(x, 1, 1, lora[0])


def test_fused_lora_cuda_wrapper_refuses_cpu_tensors():
    from paddle_tpu_torch.ops.fused_lora_cuda import fused_lora_matmul_cuda

    x = torch.zeros(2, 1, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 128, dtype=torch.bfloat16)
    a = torch.zeros(3, 1, 64, 4)
    b = torch.zeros(3, 1, 4, 128)
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fused_lora_matmul_cuda(x, w, a, b, torch.zeros(3), 0,
                               torch.zeros(2, dtype=torch.int32))
    assert tops.launch_counts()["fused_lora_matmul"] == 0
