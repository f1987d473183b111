"""Speculative decoding on the port's paged server against the JAX
package, on the CPU in fp32 (2 layers, narrow widths, JAX weights carried
over with ``params_from_jax``): the verify forward
(``paged_verify_step``) in logits and pools over fp and int8-KV pools, with
and without LoRA, and at W = 1 the decode step; then
``GenerationServer(spec=SpecConfig(...))`` greedy tokens equal to the JAX
speculative server's and to the port's plain server's under slot churn
and mixed ``draft_k`` — the n-gram drafter at ``tick_window`` 1 and 2,
the whole-tick kernel's plain twin, the draft-model drafter, the
``max_len`` boundary, int8 weights, int8 KV pools and LoRA — with the
gate's plain windows and the draft counts equal to JAX's; sampled rows
beside greedy ones; ``submit(draft_k=)`` checked as in JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import AdapterRegistry as JRegistry
from paddle_tpu.inference import LoRAConfig as JLoRAConfig
from paddle_tpu.inference.lora import AdapterPool as JAdapterPool
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.inference.speculative import SpecConfig as JSpec
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.lora import (AdapterPool, AdapterRegistry,
                                             LoRAConfig, target_dims)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
DRAFT = dict(SMALL, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1)
SERVE = dict(max_batch=2, max_len=64, block_size=4, prefill_chunk=8)
# fp32 on both sides; torch and XLA sum in other orders
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


@pytest.fixture(autouse=True)
def _restore_kernel_modes():
    yield
    ops.set_kernel_mode("auto")
    jops.set_kernel_mode("auto")


def _pair(cfg_kw, seed, int8=False):
    paddle.seed(seed)
    jm = JModel(JConfig(**cfg_kw, use_flash_attention=False))
    if int8:
        jm.quantize_int8()
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**cfg_kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    if int8:
        tm.quantize_int8()
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(SMALL, 7)


@pytest.fixture(scope="module")
def drafts():
    return _pair(DRAFT, 11)


def _lora_configs(cfg):
    """The same two adapters in a JAX and a port registry."""
    jr, tr = JRegistry(), AdapterRegistry()
    for i, (name, rank, alpha) in enumerate((("a1", 4, 8.0),
                                             ("a2", 2, 4.0))):
        rng = np.random.RandomState(3 + i)
        w = {(layer, t): (rng.normal(0, 0.02, (fi, rank)).astype(np.float32),
                          rng.normal(0, 0.05, (rank, fo)).astype(np.float32))
             for layer in range(cfg.num_hidden_layers)
             for t, (fi, fo) in target_dims(cfg).items()}
        jr.register(name, w, rank=rank, alpha=alpha)
        tr.register(name, w, rank=rank, alpha=alpha)
    return (JLoRAConfig(jr, max_live_adapters=2, max_rank=4),
            LoRAConfig(tr, max_live_adapters=2, max_rank=4))


# --------------------------------------------------------------------------- #
# The verify forward
# --------------------------------------------------------------------------- #


def _verify_case(cfg, quant, seed=0, N=14, bs=4):
    """Random pools (int8: quantized random blocks), three rows at
    mixed depths whose windows cross a block boundary, a window of 4
    tokens a row."""
    rng = np.random.default_rng(seed)
    KV, D = cfg.num_key_value_heads, cfg.head_dim
    pools = []
    for _ in range(cfg.num_hidden_layers):
        k = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
        v = rng.standard_normal((N, bs, KV, D)).astype(np.float32)
        if quant:
            kq, ks = tpa.quantize_block_kv(torch.from_numpy(k))
            vq, vs = tpa.quantize_block_kv(torch.from_numpy(v))
            pools.append(tuple(t.numpy() for t in (kq, ks, vq, vs)))
        else:
            pools.append((k, v))
    pos = np.array([6, 11, 2], np.int32)
    tables = np.zeros((3, 6), np.int32)
    free = rng.permutation(np.arange(1, N))
    took = 0
    for b, p in enumerate(pos):
        n = (p + 3) // bs + 1
        tables[b, :n] = free[took:took + n]
        took += n
    window = rng.integers(1, cfg.vocab_size, (3, 4)).astype(np.int32)
    return pools, tables, pos, window


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8kv"])
def test_paged_verify_step_matches_jax(models, quant, lora):
    """Hidden states, logits and every pool entry after one verify window
    equal JAX's within TOL (int8: the codes and scales the window
    rewrote); with LoRA each row on its own adapter page."""
    jm, tm = models
    pools, tables, pos, window = _verify_case(tm.cfg, quant)
    jl = tl = None
    if lora:
        jcfg, tcfg = _lora_configs(tm.cfg)
        jp, tp = JAdapterPool(tm.cfg, jcfg), AdapterPool(tm.cfg, tcfg,
                                                         device="cpu")
        pages = [jp.acquire("a1"), 0, jp.acquire("a2")]
        assert pages == [tp.acquire("a1"), 0, tp.acquire("a2")]
        idx = np.array(pages, np.int32)
        jl = jp.gather_rows(jp.device_tensors(), jnp.asarray(idx))
        tl = tp.layer_factors(torch.from_numpy(idx))
    jpools = [tuple(Tensor(jnp.asarray(a)) for a in p) for p in pools]
    tpools = [tuple(torch.from_numpy(a.copy()) for a in p) for p in pools]
    jh, jnew = jm.model.paged_verify_step(
        Tensor(jnp.asarray(window)), jpools, jnp.asarray(tables),
        jnp.asarray(pos), lora=jl)
    with torch.no_grad():
        th, _ = tm.model.paged_verify_step(
            torch.from_numpy(window), tpools, torch.from_numpy(tables),
            torch.from_numpy(pos), tl)
        tlog = tm.head(th).numpy()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh.value), **TOL)
    np.testing.assert_allclose(tlog, np.asarray(jm.lm_head(jh).value), **TOL)
    for jp_, tp_ in zip(jnew, tpools):
        for a, b in zip(jp_, tp_):
            a = np.asarray(a.value)
            if a.dtype == np.int8:
                # a code on a half step may round either way
                assert np.abs(b.numpy().astype(int) - a.astype(int)).max() \
                    <= 1
            else:
                np.testing.assert_allclose(b.numpy(), a, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8kv"])
def test_verify_window_equals_its_decode_ticks(models, quant):
    """At W = 1 the verify step is the decode step, bit for bit, over
    either pool. Over fp pools a window of W tokens scores what W single
    decode ticks on a copy of the pools score (the tokens fed the same);
    over int8 pools it cannot: the window's later tokens requantize a
    shared block before its earlier queries read it."""
    _, tm = models
    pools, tables, pos, window = _verify_case(tm.cfg, quant, seed=1)
    tt, tpos = torch.from_numpy(tables), torch.from_numpy(pos)

    def copies():
        return [tuple(torch.from_numpy(a.copy()) for a in p) for p in pools]

    with torch.no_grad():
        one, one_d = copies(), copies()
        h1, _ = tm.model.paged_verify_step(torch.from_numpy(window[:, :1]),
                                           one, tt, tpos)
        d1, _ = tm.model.paged_decode_step(torch.from_numpy(window[:, :1]),
                                           one_d, tt, tpos)
        assert torch.equal(h1, d1)
        for a, b in zip(one, one_d):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        if quant:
            return
        win, dec = copies(), copies()
        hw, _ = tm.model.paged_verify_step(torch.from_numpy(window), win, tt,
                                           tpos)
        hd = torch.cat([tm.model.paged_decode_step(
            torch.from_numpy(window[:, j:j + 1]), dec, tt, tpos + j)[0]
            for j in range(window.shape[1])], 1)
    np.testing.assert_allclose(hw.numpy(), hd.numpy(), **TOL)
    for a, b in zip(win, dec):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# The speculative server
# --------------------------------------------------------------------------- #


def _motif(rng, n, period=5):
    m = rng.randint(1, 100, period).tolist()
    return (m * (n // period + 1))[:n]


def _churn_traffic():
    """8 requests through 2 slots: repetitive and random prompts, multi
    chunk prefill, mixed draft budgets."""
    rng = np.random.RandomState(3)
    prompts = [_motif(rng, n) for n in (11, 24, 7)] + \
        [rng.randint(1, 128, n).tolist() for n in (5, 19, 12)] + \
        [_motif(rng, 16, period=3), [9, 9, 9, 9]]
    kws = [{}, {"draft_k": 0}, {"draft_k": 1}, {}, {"draft_k": 2}, {}, {},
           {"draft_k": 0}]
    return prompts, kws


def _run(cls, model, prompts, kws=None, new=10, **kw):
    srv = cls(model, cache="paged", **{**SERVE, **kw})
    kws = kws or [{}] * len(prompts)
    rids = [srv.submit(p, max_new_tokens=n, **k)
            for p, k, n in zip(prompts, kws,
                               new if isinstance(new, list)
                               else [new] * len(prompts))]
    out = srv.run()
    return [out[r] for r in rids], srv


def _plain(tm, prompts, new=10, **kw):
    return _run(GenerationServer, tm, prompts, new=new, device="cpu",
                **kw)[0]


@pytest.mark.parametrize("window", [1, 2])
def test_spec_greedy_tokens_equal_jax_and_plain_under_churn(models, window):
    jm, tm = models
    prompts, kws = _churn_traffic()
    got, srv = _run(GenerationServer, tm, prompts, kws, device="cpu",
                    tick_window=window, spec=SpecConfig(k=3))
    want, jsrv = _run(JServer, jm, prompts, kws, tick_window=window,
                      spec=JSpec(k=3))
    assert got == want
    assert got == _plain(tm, prompts)
    assert srv.spec_metrics() == jsrv.spec_metrics()
    sm = srv.spec_metrics()
    assert sm["draft_tokens_proposed"] > 0
    assert sm["draft_tokens_accepted"] <= sm["draft_tokens_proposed"]
    assert srv.kv_stats()["blocks_in_use"] == 0
    st = srv.throughput_stats()
    assert st["verify_windows"] == window * st["verify_trips"] > 0
    assert st["verify_tokens"] + st["decode_tokens"] == sum(
        len(t) - len(p) - 1 for t, p in zip(got, prompts))


def test_spec_megakernel_twin_greedy_tokens_equal_jax(models):
    """``kernels="megakernel"``: each verify window is one whole-tick pass
    at W = k+1 (its plain twin here); tokens equal JAX's speculative
    server's and the port's plain server's."""
    jm, tm = models
    prompts, kws = _churn_traffic()
    got, srv = _run(GenerationServer, tm, prompts, kws, device="cpu",
                    tick_window=2, kernels="megakernel",
                    spec=SpecConfig(k=3))
    assert srv._exec.megakernel
    want, jsrv = _run(JServer, jm, prompts, kws, tick_window=2,
                      spec=JSpec(k=3))
    assert got == want
    assert got == _plain(tm, prompts)
    assert srv.spec_metrics() == jsrv.spec_metrics()


def test_draft_model_drafter_greedy_tokens_equal_jax(models, drafts):
    """The draft-model drafter (host round trip a window, tick_window 1):
    tokens equal JAX's and the plain server's, and so do the draft counts;
    a tick_window over 1 is refused as in JAX."""
    jm, tm = models
    jd, td = drafts
    prompts, kws = _churn_traffic()
    prompts, kws = prompts[:5], kws[:5]
    got, srv = _run(GenerationServer, tm, prompts, kws, new=6,
                    device="cpu",
                    spec=SpecConfig(k=2, drafter="model", draft_model=td))
    want, jsrv = _run(JServer, jm, prompts, kws, new=6,
                      spec=JSpec(k=2, drafter="model", draft_model=jd))
    assert got == want
    assert got == _plain(tm, prompts, new=6)
    assert srv.spec_metrics() == jsrv.spec_metrics()
    assert srv.spec_metrics()["draft_tokens_proposed"] > 0
    with pytest.raises(ValueError, match="fusible"):
        GenerationServer(tm, cache="paged", device="cpu", tick_window=2,
                         **SERVE,
                         spec=SpecConfig(k=2, drafter="model",
                                         draft_model=td))


def test_spec_max_len_boundary_equals_jax(models):
    """Requests that fill max_len exactly: the surplus windows clamp at
    max_len - 1 and the tokens equal JAX's and the plain server's."""
    jm, tm = models
    rng = np.random.RandomState(6)
    prompts = [_motif(rng, 8), rng.randint(1, 128, 6).tolist()]
    new = [24, 26]
    kw = dict(max_len=32, tick_window=2)
    got, _ = _run(GenerationServer, tm, prompts, new=new, device="cpu",
                  spec=SpecConfig(k=3), **kw)
    want, _ = _run(JServer, jm, prompts, new=new, spec=JSpec(k=3), **kw)
    assert got == want
    assert got == _plain(tm, prompts, new=new, max_len=32)
    assert [len(t) for t in got] == [32, 32]


def test_spec_gate_windows_and_counts_equal_jax(models):
    """Drafter-hostile traffic trips the gate (plain windows counted);
    cooldown 0 disables it; the turbo tier on friendly traffic; every
    tokens list and every counter equals JAX's."""
    jm, tm = models
    rng = np.random.RandomState(8)
    hostile = [rng.randint(1, 128, n).tolist() for n in (9, 14, 6, 11)]
    friendly = [_motif(rng, n) for n in (15, 10, 21, 8)]
    cases = [(hostile, dict(k=3, gate_low=2.0, gate_cooldown=2,
                            gate_ticks=4)),
             (hostile, dict(k=3, gate_cooldown=0)),
             (friendly, dict(k=3, gate_cooldown=2, gate_ticks=4,
                             turbo_windows=4))]
    metrics = []
    for prompts, sc in cases:
        got, srv = _run(GenerationServer, tm, prompts, new=12,
                        device="cpu", tick_window=2, spec=SpecConfig(**sc))
        want, jsrv = _run(JServer, jm, prompts, new=12, tick_window=2,
                          spec=JSpec(**sc))
        assert got == want
        assert got == _plain(tm, prompts, new=12)
        assert srv.spec_metrics() == jsrv.spec_metrics()
        metrics.append(srv.spec_metrics())
    assert metrics[0]["gated_plain_windows"] > 0
    assert metrics[1]["gated_plain_windows"] == 0


@pytest.mark.parametrize("variant", ["int8_weights", "int8_kv", "lora"])
def test_spec_greedy_tokens_equal_jax_per_variant(models, variant):
    """int8 weights (their verify rows number B·(k+1): the dequantize-once
    product, as in JAX), int8 KV pools, and LoRA adapters per request:
    tokens equal JAX's speculative server's."""
    jm, tm = models
    prompts, kws = _churn_traffic()
    prompts, kws = prompts[:6], kws[:6]
    jkw, tkw = {}, {}
    if variant == "int8_weights":
        jm, tm = _pair(SMALL, 7, int8=True)
    if variant == "int8_kv":
        jkw["kv_quant"] = tkw["kv_quant"] = "int8"
    if variant == "lora":
        jkw["lora"], tkw["lora"] = _lora_configs(tm.cfg)
        for i, k in enumerate(kws):
            kws[i] = dict(k, adapter=[None, "a1", "a2"][i % 3])
    got, srv = _run(GenerationServer, tm, prompts, kws, device="cpu",
                    tick_window=2, spec=SpecConfig(k=3), **tkw)
    want, jsrv = _run(JServer, jm, prompts, kws, tick_window=2,
                      spec=JSpec(k=3), **jkw)
    assert got == want
    assert srv.spec_metrics() == jsrv.spec_metrics()


def test_spec_sampled_rows_beside_greedy_rows(models):
    """A greedy request sharing verify windows with sampled ones keeps the
    plain server's tokens; the sampled requests finish with their lengths
    and valid ids; one seed gives the same tokens twice."""
    _, tm = models
    rng = np.random.RandomState(4)
    pg = _motif(rng, 13)
    ps = [rng.randint(1, 128, 9).tolist(), _motif(rng, 12)]
    want = _plain(tm, [pg], new=8)[0]
    runs = []
    for _ in range(2):
        srv = GenerationServer(tm, cache="paged", device="cpu", tick_window=2,
                               seed=5,
                               spec=SpecConfig(k=2), **SERVE)
        rg = srv.submit(pg, max_new_tokens=8)
        rs = [srv.submit(p, max_new_tokens=8, temperature=0.9, top_k=12,
                         top_p=0.9) for p in ps]
        out = srv.run()
        assert out[rg] == want
        for r, p in zip(rs, ps):
            assert len(out[r]) == len(p) + 8
            assert all(0 <= t < 128 for t in out[r][len(p):])
        runs.append([out[r] for r in rs])
    assert runs[0] == runs[1]


def test_submit_draft_k_checked_as_jax(models):
    jm, tm = models
    plain = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
    jplain = JServer(jm, cache="paged", **SERVE)
    spec = GenerationServer(tm, cache="paged", device="cpu",
                            spec=SpecConfig(k=3), **SERVE)
    jspec = JServer(jm, cache="paged", spec=JSpec(k=3), **SERVE)
    for srv, js, bad in ((plain, jplain, 1), (spec, jspec, -1),
                         (spec, jspec, True), (spec, jspec, 1.0),
                         (spec, jspec, 4)):
        with pytest.raises(ValueError) as te:
            srv.submit([1, 2, 3], max_new_tokens=2, draft_k=bad)
        with pytest.raises(ValueError) as je:
            js.submit([1, 2, 3], max_new_tokens=2, draft_k=bad)
        assert str(te.value) == str(je.value)
    # draft_k keeps JAX's position, before priority, tenant, ttl_s, adapter
    rid = spec.submit([1, 2, 3], 4, 0.0, 0, 0.0, 2)
    assert spec._sched.peek().req.draft_k == 2
    assert len(spec.run()[rid]) == 7
    # priority, tenant and ttl_s reach the scheduler's entry, as in JAX
    for name, value in (("priority", 0), ("tenant", "t"), ("ttl_s", 1.0)):
        ents = []
        for srv in (spec, jspec):
            r = srv.submit([1, 2, 3], max_new_tokens=2, **{name: value})
            ent = next(e for e in srv._sched.waiting() if e.rid == r)
            ents.append((ent.priority, ent.tenant, ent.deadline is not None))
            assert srv.cancel(r)
        assert ents[0] == ents[1], (name, ents)
    assert spec.spec_metrics()["draft_tokens_proposed"] >= 0
    assert plain.spec_metrics() == jplain.spec_metrics() == {}


def test_spec_construction_checks(models):
    """spec= needs the paged cache; its config is validated; the table's
    scratch slack covers a trip's windows and a gated trip's ticks."""
    _, tm = models
    with pytest.raises(ValueError, match="paged"):
        GenerationServer(tm, device="cpu", cache="dense", spec=SpecConfig())
    with pytest.raises(ValueError, match="spec.k"):
        GenerationServer(tm, cache="paged", device="cpu",
                         spec=SpecConfig(k=0), **SERVE)
    srv = GenerationServer(tm, cache="paged", device="cpu", tick_window=3,
                           spec=SpecConfig(k=4, gate_ticks=20,
                                           turbo_windows=5), **SERVE)
    bs = SERVE["block_size"]
    entries = -(-SERVE["max_len"] // bs)
    assert srv._table_width == entries + max(2, -(-5 * 5 // bs),
                                             -(-20 // bs))


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing, it is
    only counted; a registered generator is recorded."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, gen):
        self.generators.append(gen)


def test_spec_programs_are_graphs_under_their_keys(models, monkeypatch):
    """On the CUDA graph API's stubs (a capture runs the body eagerly):
    a fused trip is captured once per ``("spec_scan", greedy, S)``, a
    verify window per ``("spec_verify", greedy)``, each later pass a
    replay counted under "spec"; a sampled key's graph draws from the
    server's generator; the capture's warm-up sees zeroed inputs."""
    import contextlib

    stream = type("Stream", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    _, tm = models
    srv = GenerationServer(tm, cache="paged", device="cpu", tick_window=2,
                           spec=SpecConfig(k=3), **SERVE)
    ex = srv._exec
    ex.graphs = True
    B, TW = SERVE["max_batch"], srv._table_width
    seen = []
    orig = ex._spec_scan

    def spy(*a):
        seen.append(int(ex._dec["ctx"].abs().sum()))
        return orig(*a)

    ex._spec_scan = spy
    i32 = dict(dtype=torch.int32)
    ctx = torch.randint(1, 128, (B, SERVE["max_len"]), **i32)
    tables = torch.zeros(B, TW, **i32)
    tables[:, :4] = torch.arange(1, 9, **i32).reshape(B, 4)
    pos, kcaps, ones = (torch.full((B,), 5, **i32), torch.full((B,), 3, **i32),
                        torch.ones(B, **i32))
    temps = torch.full((B,), 0.8)
    zi = torch.zeros(B, **i32)
    gen = torch.Generator()
    for _ in range(2):
        ex.spec_scan(ctx, tables, pos, None, None, None, kcaps, ones, None,
                     greedy=True, windows=2)
    ex.spec_scan(ctx, tables, pos, temps, zi, temps, kcaps, ones, gen,
                 greedy=False, windows=2)
    for _ in range(2):
        ex.spec_verify(pos, ctx[:, :3], tables, pos, None, None, None, kcaps,
                       None, greedy=True)
    assert set(ex._graphs) == {("spec_scan", True, 2),
                               ("spec_scan", False, 2),
                               ("spec_verify", True)}
    assert ex.captures == 3 and ex.replays["spec"] == 5
    assert ex._graphs[("spec_scan", False, 2)].graph.generators == [gen]
    assert ex._graphs[("spec_scan", True, 2)].graph.replays == 2
    # each capture's warm-up and capture ran over zeroed inputs
    assert seen == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="generator"):
        ex.spec_scan(ctx, tables, pos, temps, zi, temps, kcaps, ones,
                     torch.Generator(), greedy=False, windows=2)
