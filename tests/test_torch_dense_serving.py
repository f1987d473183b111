"""The dense-cache server in the port (``GenerationServer(cache="dense")``,
``inference/executor.py``'s ``DenseExecutor``) held against the JAX dense
server and the port's own ``generate`` on the CPU in fp32, with the JAX
weights carried over: the cases of ``tests/test_serving.py`` (churn
through fewer slots than requests, reuse after a drain, per-slot sampling,
``tick_window`` 1 against 4, a sampled slot in a window), the paged server
equal to the dense one and to ``generate`` under churn
(``tests/test_paged_serving.py``), ``submit`` validation for both caches,
a preempted-and-resumed paged run equal to the dense oracle
(``tests/test_scheduler.py``), speculative serving equal to it
(``tests/test_speculative.py``), the dense request API, every refusal of a
paged-only option in JAX's words, the dense snapshot and migration
refusals (``tests/test_faults.py``), a prefill's whole-row scatter into
the slab, the programs' graph bookkeeping on a CPU stand-in for the CUDA
graph calls, and no host read in a program's body."""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.lora import AdapterRegistry, LoRAConfig
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

# tests/test_serving.py's model (llama_tiny_config at 128 positions)
TINY = dict(vocab_size=1024, hidden_size=256, intermediate_size=704,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, max_position_embeddings=128,
            dtype="float32")
# tests/test_paged_serving.py's, tests/test_scheduler.py's and
# tests/test_speculative.py's
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")

_aten = torch.ops.aten
HOST_READS = {_aten._local_scalar_dense, _aten.item, _aten.nonzero,
              _aten.masked_select, _aten.is_nonzero, _aten.equal}
MASK_INDEXING = {_aten.index, _aten.index_put, _aten.index_put_}


class NoHostRead(TorchDispatchMode):
    """Raises on any op of ``HOST_READS`` and on boolean-mask indexing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in HOST_READS or op in MASK_INDEXING and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            raise AssertionError(f"host read of a device value: {func}")
        return func(*args, **(kwargs or {}))


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
def _restore_mode():
    yield
    ops.set_kernel_mode("auto")


def _pair(cfg_kw, seed):
    paddle.seed(seed)
    jm = JModel(JConfig(**cfg_kw, use_flash_attention=False))
    cfg = LlamaConfig(**cfg_kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in state_values(jm).items()}, cfg))
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL, 7)


def _gen(tm, prompt, n):
    return tm.generate(torch.tensor([prompt]), max_new_tokens=n)[0].tolist()


def _serve(srv, prompts, **kw):
    rids = [srv.submit(p, **kw) for p in prompts]
    out = srv.run()
    assert set(out) == set(rids)
    return [out[r] for r in rids]


def _dense(tm, **kw):
    return GenerationServer(tm, device="cpu", **kw)


# ------------------------------------------------ tests/test_serving.py
def test_matches_generate_with_slot_churn(tiny):
    """4 requests through 2 slots: each equals ``generate`` (a slot
    refilled mid-flight) and the JAX dense server's."""
    jm, tm = tiny
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 1024, (n,)).tolist() for n in (5, 12, 7, 3)]
    srv = _dense(tm, max_batch=2, max_len=64, prompt_buckets=(16,))
    assert srv.cache_mode == "dense"
    got = _serve(srv, prompts, max_new_tokens=8)
    assert got == [_gen(tm, p, 8) for p in prompts]
    js = JServer(jm, max_batch=2, max_len=64, prompt_buckets=(16,))
    assert got == _serve(js, prompts, max_new_tokens=8)


def test_variable_max_new_tokens_and_reuse(tiny):
    _, tm = tiny
    rng = np.random.RandomState(1)
    srv = _dense(tm, max_batch=2, max_len=64, prompt_buckets=(16,))
    r1 = srv.submit(rng.randint(1, 1024, (4,)).tolist(), max_new_tokens=3)
    r2 = srv.submit(rng.randint(1, 1024, (6,)).tolist(), max_new_tokens=10)
    res = srv.run()
    assert len(res[r1]) == 4 + 3 and len(res[r2]) == 6 + 10
    r3 = srv.submit([1, 2, 3], max_new_tokens=2)
    res2 = srv.run()
    assert len(res2[r3]) == 5 and r1 not in res2


@pytest.mark.parametrize("window", [1, 8])
def test_per_slot_temperature_sampling(tiny, window):
    """A greedy slot beside a sampled one in the same ticks still equals
    ``generate``; the sampled row's ids are valid and differ from its
    greedy run (``tick_window`` 1 and 8, as the JAX tests)."""
    _, tm = tiny
    rng = np.random.RandomState(2)
    p_greedy = rng.randint(1, 1024, (6,)).tolist()
    p_sample = rng.randint(1, 1024, (6,)).tolist()
    srv = _dense(tm, max_batch=2, max_len=64, prompt_buckets=(16,),
                 tick_window=window)
    rg = srv.submit(p_greedy, max_new_tokens=6)
    rs = srv.submit(p_sample, max_new_tokens=6, temperature=1.0)
    res = srv.run()
    assert res[rg] == _gen(tm, p_greedy, 6)
    toks = res[rs][len(p_sample):]
    assert all(0 <= t < 1024 for t in toks)
    assert res[rs] != _gen(tm, p_sample, 6)


def test_tick_window_greedy_parity(small):
    """Four ticks a program give the one-tick server's tokens (the surplus
    past a request's end discarded), and the JAX server's at W = 4."""
    jm, tm = small
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 128, n).tolist() for n in (5, 17, 33)]
    kw = dict(max_batch=2, max_len=160, prompt_buckets=(32, 64))
    exact = _serve(_dense(tm, **kw), prompts, max_new_tokens=9)
    windowed = _serve(_dense(tm, tick_window=4, **kw), prompts,
                      max_new_tokens=9)
    assert exact == windowed
    assert windowed == _serve(JServer(jm, tick_window=4, **kw), prompts,
                              max_new_tokens=9)


def test_eos_inside_a_window_matches_jax(small):
    jm, tm = small
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 128, n).tolist() for n in (6, 9, 13)]
    eos = _gen(tm, prompts[1], 3)[-1]
    kw = dict(max_batch=2, max_len=64, prompt_buckets=(16,), tick_window=4,
              eos_token_id=eos)
    got = _serve(_dense(tm, **kw), prompts, max_new_tokens=10)
    assert eos in got[1][len(prompts[1]):]
    assert got == _serve(JServer(jm, **kw), prompts, max_new_tokens=10)


# ------------------------------ tests/test_paged_serving.py, scheduling
def test_paged_matches_dense_and_generate_under_churn(small):
    """6 requests through 2 slots: the paged server (multi-chunk prefill)
    equals the dense one and ``generate``; the dense one equals JAX's."""
    jm, tm = small
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, (n,)).tolist()
               for n in (5, 12, 7, 3, 12, 20)]
    refs = [_gen(tm, p, 8) for p in prompts]
    dense = _serve(_dense(tm, max_batch=2, max_len=64, prompt_buckets=(32,)),
                   prompts, max_new_tokens=8)
    psrv = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                            max_len=64, block_size=4, prefill_chunk=8)
    paged = _serve(psrv, prompts, max_new_tokens=8)
    assert paged == refs and dense == refs
    assert psrv.kv_stats()["blocks_in_use"] == 0
    assert dense == _serve(JServer(jm, max_batch=2, max_len=64,
                                   prompt_buckets=(32,)),
                           prompts, max_new_tokens=8)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_submit_validation(small, cache):
    _, tm = small
    kw = dict(cache="paged", block_size=4) if cache == "paged" else \
        dict(prompt_buckets=(16,))
    srv = GenerationServer(tm, device="cpu", max_batch=2, max_len=64, **kw)
    with pytest.raises(ValueError, match="at least one token"):
        srv.submit([], max_new_tokens=4)
    with pytest.raises(ValueError, match="positive int"):
        srv.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="positive int"):
        srv.submit([1, 2], max_new_tokens=-3)
    with pytest.raises(ValueError, match="int token ids"):
        srv.submit([1.5, 2], max_new_tokens=4)
    with pytest.raises(ValueError, match="int token ids"):
        srv.submit(["a", 2], max_new_tokens=4)
    with pytest.raises(ValueError, match="top_k"):
        srv.submit([1, 2], max_new_tokens=4, top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        srv.submit([1, 2], max_new_tokens=4, top_p=1.5)
    if cache == "dense":
        with pytest.raises(ValueError, match="exceeds largest bucket 16"):
            srv.submit(list(range(1, 18)), max_new_tokens=4)
        with pytest.raises(ValueError, match="no prompt bucket fits"):
            GenerationServer(tm, device="cpu", max_len=64,
                             prompt_buckets=(128,))
    rid = srv.submit(np.asarray([3, 4, 5], np.int64), max_new_tokens=2)
    assert len(srv.run()[rid]) == 5


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_preempted_resume_is_token_identical(small, kv_quant):
    """A paged request swapped out mid-decode and resumed emits the
    un-preempted run's tokens; with fp KV, the dense oracle's too."""
    _, tm = small
    rs = np.random.RandomState(11)
    prompts = [rs.randint(1, 128, (n,)).tolist() for n in (12, 7, 19, 5)]
    paged = dict(cache="paged", device="cpu", max_batch=2, max_len=96,
                 block_size=8, prefill_chunk=16, kv_quant=kv_quant)
    base = _serve(GenerationServer(tm, **paged), prompts, max_new_tokens=12)
    tight = GenerationServer(tm, num_blocks=7, policy="priority", **paged)
    rids = [tight.submit(p, max_new_tokens=12, priority=i % 2)
            for i, p in enumerate(prompts)]
    out = tight.run()
    sm = tight.sched_metrics()
    assert sm["preemptions"] > 0 and sm["resumes"] > 0, sm
    assert [out[r] for r in rids] == base
    if kv_quant == "none":
        assert base == _serve(_dense(tm, max_batch=2, max_len=96,
                                     prompt_buckets=(32,)),
                              prompts, max_new_tokens=12)


def test_spec_greedy_exact_vs_dense_under_churn(small):
    """8 requests through 2 slots with mixed draft budgets: the
    speculative server's greedy tokens equal the dense server's."""
    _, tm = small
    rng = np.random.RandomState(3)

    def motif(n, period=5):
        m = rng.randint(1, 100, period).tolist()
        return (m * (n // period + 1))[:n]

    prompts = [motif(n) for n in (11, 24, 7)] + \
        [rng.randint(1, 128, n).tolist() for n in (5, 19, 12)] + \
        [motif(16, period=3), [9, 9, 9, 9]]
    kws = [{}, {"draft_k": 0}, {"draft_k": 1}, {}, {"draft_k": 2}, {}, {},
           {"draft_k": 0}]
    dense = _serve(_dense(tm, max_batch=2, max_len=64, prompt_buckets=(32,)),
                   prompts, max_new_tokens=10)
    srv = GenerationServer(tm, cache="paged", device="cpu", max_batch=2,
                           max_len=64, block_size=4, prefill_chunk=8,
                           tick_window=2, spec=SpecConfig(k=3))
    rids = [srv.submit(p, max_new_tokens=10, **kw)
            for p, kw in zip(prompts, kws)]
    out = srv.run()
    assert [out[r] for r in rids] == dense
    assert srv.spec_metrics()["draft_tokens_proposed"] > 0


# ------------------------------------------------------ the request API
def test_dense_request_api_matches_jax(small):
    """status / cancel / sched_metrics / load_metrics / kv_stats /
    assert_conserved / probe_prefix on a dense server: the JAX dense
    server's answers and keys."""
    jm, tm = small
    prompts = [[5, 6, 7], [8, 9], [10, 11, 12, 13]]
    servers = [GenerationServer(tm, device="cpu", max_batch=2, max_len=32,
                                prompt_buckets=(8,)),
               JServer(jm, max_batch=2, max_len=32, prompt_buckets=(8,))]
    seen = []
    for srv in servers:
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        before = [srv.status(r) for r in rids]
        srv.step()
        mid = [srv.status(r) for r in rids]
        cancelled = srv.cancel(rids[1])
        srv.step()
        lm = srv.load_metrics()
        conserved = srv.assert_conserved()
        while srv.step():
            pass
        after = [srv.status(r) for r in rids]
        res = srv.run()
        sm = srv.sched_metrics()
        seen.append(dict(
            before=before, mid=mid, cancelled=cancelled,
            after=after, load=sorted(lm),
            conserved=conserved, kv=srv.kv_stats(),
            probe=srv.probe_prefix(prompts[0]),
            sched={k: v for k, v in sm.items() if k != "tenants"},
            cancel_again=srv.cancel(rids[1]),
            tokens={r: res[r] for r in res}))
    assert seen[0] == seen[1]
    assert seen[0]["mid"] == ["running", "running", "queued"]
    assert seen[0]["after"] == ["done", "cancelled", "done"]


def test_dense_telemetry_records_dense_windows(small):
    _, tm = small
    srv = GenerationServer(tm, device="cpu", max_batch=2, max_len=32,
                           prompt_buckets=(8,), telemetry=True,
                           tick_window=2)
    rid = srv.submit([3, 4, 5], max_new_tokens=5)
    srv.run()
    recs = srv.telemetry.flight.dump()
    assert recs and {r["prog"] for r in recs} == {"dense"}
    assert all(set(r) >= {"t_wall_s", "decoding", "queue_depth",
                          "recompiles"} for r in recs)
    names = {e["name"] for e in srv.telemetry.tracer.spans(rid)}
    assert {"queued", "prefill", "decode_window"} <= names
    assert srv.telemetry_snapshot()["config"]["cache"] == "dense"


@pytest.mark.parametrize("call", ["snapshot", "restore", "evacuate",
                                  "admit_migrated", "adopt_warm"])
def test_dense_snapshot_and_migration_raise_as_jax(small, call):
    jm, tm = small
    kw = dict(max_batch=2, max_len=96, prompt_buckets=(32,))
    msgs = []
    for srv in (GenerationServer(tm, device="cpu", **kw), JServer(jm, **kw)):
        fn = getattr(srv, call)
        args = {"snapshot": (), "evacuate": (), "restore": ({},),
                "admit_migrated": ({},), "adopt_warm": ([],)}[call]
        with pytest.raises(ValueError, match="paged") as e:
            fn(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _refusal_options(pkg):
    """Each option of the paged path, as the package ``pkg`` ("jax" or
    "torch") takes it."""
    from paddle_tpu.inference import LoRAConfig as JLoRAConfig
    from paddle_tpu.inference import AdapterRegistry as JRegistry
    from paddle_tpu.inference.speculative import SpecConfig as JSpec

    lora = (JLoRAConfig(JRegistry()) if pkg == "jax"
            else LoRAConfig(AdapterRegistry()))
    spec = JSpec(k=2) if pkg == "jax" else SpecConfig(k=2)
    return {"kv_quant": dict(kv_quant="int8"),
            "pool_bytes": dict(pool_bytes=1 << 20),
            "host_pool_bytes": dict(host_pool_bytes=0),
            "lora": dict(lora=lora), "role": dict(role="prefill"),
            "tier": dict(tier_demote_low=0.1, tier_demote_high=0.2),
            "warm_pool_bytes": dict(warm_pool_bytes=0),
            "megakernel": dict(kernels="megakernel"),
            "spec": dict(spec=spec)}


@pytest.mark.parametrize("option", sorted(_refusal_options("torch")))
def test_paged_only_options_raise_on_dense_in_jax_words(small, option):
    jm, tm = small
    msgs = []
    for srv, pkg, extra in ((GenerationServer, "torch", dict(device="cpu")),
                            (JServer, "jax", {})):
        model = tm if pkg == "torch" else jm
        with pytest.raises(ValueError) as e:
            srv(model, max_len=64, **_refusal_options(pkg)[option], **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "paged" in msgs[0]
    assert ops.kernel_mode() == "auto"


def test_mesh_on_dense_raises_the_jax_wording(small):
    _, tm = small
    with pytest.raises(ValueError, match=r"mesh= \(multi-chip serving\) "
                                         r"requires cache='paged'"):
        GenerationServer(tm, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="cache must be 'dense' or 'paged'"):
        GenerationServer(tm, device="cpu", cache="blocks")


# ---------------------------------------------------- the executor
def test_prefill_writes_the_slot_row_as_jax(small):
    """A prefill scatters the slot's WHOLE row (the prompt's K/V, zeros
    past the bucket), over whatever the row held: the slab equals the JAX
    server's caches after the same admissions."""
    jm, tm = small
    kw = dict(max_batch=2, max_len=32, prompt_buckets=(8, 16))
    srv = GenerationServer(tm, device="cpu", **kw)
    js = JServer(jm, **kw)
    for s in (srv, js):
        s.submit(list(range(3, 15)), max_new_tokens=2)   # 12 in bucket 16
        s.run()
        s.submit([7, 8, 9], max_new_tokens=1)            # 3 in bucket 8
        s._fill_free_slots()
    for t, j in zip(srv._exec.slab, js._caches):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    row = srv._exec.slab[0][0]
    assert float(row[8:].abs().sum()) == 0.0 and float(row[:3].abs().sum())


class _StubGraph:
    def __init__(self):
        self.replays = 0
        self.generators = []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, gen):
        self.generators.append(gen)


@pytest.fixture
def stub_cuda(monkeypatch):
    """The CUDA graph API the executor calls, stubbed so that its capture
    bookkeeping runs on the CPU: a 'capture' runs the body once, eagerly,
    and a replay runs nothing."""
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
    return monkeypatch


def test_dense_programs_capture_once_a_key_over_their_own_inputs(
        small, stub_cuda):
    """One graph a (greedy, ticks) key and one a bucket, captured at first
    use after a warm-up over the pass's own inputs (not zeroed: the slab
    has no scratch row), then replays; a sampled window registers the
    server's generator; reference mode runs eagerly."""
    _, tm = small
    srv = GenerationServer(tm, device="cpu", max_batch=2, max_len=32,
                           prompt_buckets=(8, 16))
    ex = srv._exec
    ex.graphs = True
    seen = []
    body = ex._prefill

    def spy(bucket):
        seen.append(int(ex._pre[bucket]["slot"][0]))
        return body(bucket)

    ex._prefill = spy
    prompt = torch.zeros(1, 8, dtype=torch.int32)
    for slot in (1, 0, 1):
        ex.prefill_dense(8, prompt, torch.tensor([3]),
                         torch.tensor([slot]))
    # the warm-up and the stand-in capture, at the first pass's own slot
    assert seen == [1, 1]
    assert ex.captures == 1 and ex.replays["prefill"] == 3
    z = torch.zeros(2, dtype=torch.int32)
    for ticks in (1, 1, 2):
        ex.decode_dense(z, z, None, None, None, z, srv._gen, greedy=True,
                        ticks=ticks)
    assert ex.captures == 3 and ex.replays["decode"] == 3
    f = torch.zeros(2)
    ex.decode_dense(z, z, f, z, f, z, srv._gen, greedy=False)
    assert ex._graphs[("decode", False, 1)].graph.generators == [srv._gen]
    ops.set_kernel_mode("reference")
    assert ex._program(("decode", True, 1), None, ex._dec, None) is None


def test_dense_program_bodies_read_nothing_on_the_host(small):
    """Each dense program's body (every prefill bucket, greedy and sampled
    windows) runs without a host read of a device value."""
    _, tm = small
    srv = GenerationServer(tm, device="cpu", max_batch=2, max_len=48,
                           prompt_buckets=(8, 16), tick_window=3)
    ex = srv._exec
    for name in ("_prefill", "_decode_window"):
        orig = getattr(ex, name)

        def guarded(*a, _orig=orig):
            with NoHostRead():
                return _orig(*a)
        setattr(ex, name, guarded)
    srv.submit(list(range(1, 12)), max_new_tokens=5)
    srv.submit([4, 5, 6], max_new_tokens=7, temperature=0.8, top_k=5,
               top_p=0.9)
    srv.submit([9, 9], max_new_tokens=3)
    out = srv.run()
    assert sorted(len(v) for v in out.values()) == [5, 10, 16]
