"""Scheduling, swap preemption and the per-request API of the PyTorch port
(``inference/scheduler.py``, ``inference/kv_offload.py`` and their
``GenerationServer`` integration) against the JAX package on the CPU, the
cases of ``tests/test_scheduler.py`` one for one.

The pure-scheduler cases drive the JAX ``Scheduler`` and the port's with
the same clock and submits and require the same pop order, expiries and
counters. The server cases run a 2-layer Llama from JAX weights through
both servers in fp32 and require the same tokens, ``status`` and
``sched_metrics`` counters: a preempted request resumes token-identical
(fp and int8 KV), a high-priority request preempts a low one, a cancel of
a queued, a swapped and a speculating request, TTL expiry and admission
backpressure, and an overload that drains."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import kv_offload as jkv
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.inference.speculative import SpecConfig as JSpec
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch.inference import kv_offload as tkv
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
HIGH, NORMAL, LOW = (tsched.PRIORITY_HIGH, tsched.PRIORITY_NORMAL,
                     tsched.PRIORITY_LOW)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(scenario):
    """Run ``scenario(module)`` on the JAX scheduler module and the
    port's; they must return the same trace. Returns the port's."""
    want = scenario(jsched)
    got = scenario(tsched)
    assert got == want
    return got


# --------------------------------------------------------------------------
# The scheduler alone
# --------------------------------------------------------------------------

def test_fifo_orders_by_submission_and_preempted_first():
    def run(m):
        s = m.Scheduler("fifo")
        a, b, c = (s.submit(x, i) for i, x in enumerate("abc"))
        first = s.pop().rid
        s.requeue(a)          # a preempted entry drains before its peers
        order = [s.pop().rid for _ in range(3)]
        return first, order, len(s), s.pop()
    assert _both(run) == (0, [0, 1, 2], 0, None)


def test_priority_classes_with_edf_tiebreak():
    def run(m):
        s = m.Scheduler("priority", default_ttl_s=None, clock=lambda: 100.0)
        s.submit("lo", 0, priority=m.PRIORITY_LOW)
        s.submit("hl", 1, priority=m.PRIORITY_HIGH, ttl_s=50.0)
        s.submit("hs", 2, priority=m.PRIORITY_HIGH, ttl_s=10.0)
        s.submit("hn", 3, priority=m.PRIORITY_HIGH)
        s.submit("nm", 4, priority=m.PRIORITY_NORMAL)
        waiting = [e.rid for e in s.waiting()]
        return waiting, [s.pop().rid for _ in range(5)]
    assert _both(run) == ([2, 1, 3, 4, 0], [2, 1, 3, 4, 0])


def test_wfq_share_follows_tenant_weights():
    """Tenant a (weight 3) against b (weight 1), each with a deep backlog:
    the first 8 pops are 6 a and 2 b; equal weights alternate."""
    def run(m):
        s = m.Scheduler("wfq", weights={"a": 3.0, "b": 1.0})
        for i in range(12):
            s.submit(f"a{i}", i, tenant="a", cost=1.0)
        for i in range(12):
            s.submit(f"b{i}", 100 + i, tenant="b", cost=1.0)
        first8 = [s.pop().tenant for _ in range(8)]
        s2 = m.Scheduler("wfq")
        for i in range(4):
            s2.submit(f"x{i}", i, tenant="x", cost=1.0)
        for i in range(4):
            s2.submit(f"y{i}", 10 + i, tenant="y", cost=1.0)
        return first8, [s2.pop().tenant for _ in range(8)], s._vnow
    first8, order, _ = _both(run)
    assert first8.count("a") == 6 and first8.count("b") == 2
    assert order.count("x") == 4 and order[:2] in (["x", "y"], ["y", "x"])


def test_admission_control_backpressure():
    def run(m):
        s = m.Scheduler("fifo", max_queue=2)
        s.submit("a", 0)
        s.submit("b", 1)
        with pytest.raises(m.AdmissionError, match="queue full"):
            s.submit("c", 2)
        s.pop()
        s.submit("c", 3)                      # space reopened
        ent = s.pop()
        s.submit("d", 4)
        s.requeue(ent)                        # requeue bypasses admission
        return len(s), s.submitted, [e.rid for e in s.waiting()]
    assert _both(run)[0] == 3


def test_ttl_expires_only_never_started_entries():
    def run(m):
        t = [0.0]
        s = m.Scheduler("fifo", default_ttl_s=10.0, clock=lambda: t[0])
        a = s.submit("a", 0)
        s.submit("b", 1, ttl_s=100.0)         # per-request override
        s.requeue(s.pop())                    # a started: exempt from TTL
        t[0] = 50.0
        early = [e.rid for e in s.expire()]
        t[0] = 150.0
        late = [e.rid for e in s.expire()]
        t[0] = 20.0                           # a clock that runs backwards
        return early, late, s.expired, s.now(), s.pop() is a, len(s)
    assert _both(run) == ([], [1], 1, 150.0, True, 0)


def test_cancel_and_validation():
    def run(m):
        s = m.Scheduler("priority")
        s.submit("a", 0)
        ent = s.cancel(0)
        out = [ent.req, s.cancel(0), s.cancelled]
        for bad, match in ((dict(priority=-1), "priority"),
                           (dict(ttl_s=0.0), "ttl_s")):
            with pytest.raises(ValueError, match=match):
                s.submit("x", 1, **bad)
        with pytest.raises(ValueError, match="policy"):
            m.Scheduler("lifo")
        with pytest.raises(ValueError, match="weight"):
            m.Scheduler("wfq", weights={"t": 0.0})
        return out
    assert _both(run) == ["a", None, 1]


def test_kv_and_adapter_demand_in_pop_order():
    """``kv_demand`` sums the admission gate's annotations;
    ``adapter_demand`` lists the queue's adapters in pop order."""
    def run(m):
        s = m.Scheduler("priority")
        e1 = s.submit("a", 0, adapter="x", priority=m.PRIORITY_LOW)
        e2 = s.submit("b", 1, adapter="y")
        s.submit("c", 2, adapter="x", priority=m.PRIORITY_HIGH)
        s.submit("d", 3)
        e1.kv_need, e2.kv_need = 3, 4
        return s.kv_demand(), s.adapter_demand()
    assert _both(run) == (7, ["x", "y"])


@pytest.mark.parametrize("mod", [jkv, tkv], ids=["jax", "port"])
def test_host_pool_budget(mod):
    p = mod.HostKVPool(capacity_bytes=100)
    assert p.put(1, [np.zeros(4)], 60)
    assert not p.put(2, [np.zeros(4)], 60)    # would exceed the cap
    assert p.put(2, [np.zeros(4)], 40)
    assert p.bytes_in_use == 100 and p.bytes_peak == 100
    p.take(1, 60)
    assert p.bytes_in_use == 40 and len(p) == 1
    p.discard(2, 40)
    p.discard(2, 40)                          # idempotent
    assert p.bytes_in_use == 0 and p.bytes_peak == 100 and len(p) == 0
    with pytest.raises(ValueError):
        mod.HostKVPool(capacity_bytes=-1)


def test_adopted_payload_swaps_in_on_another_engine():
    """``adopt`` re-parks a payload captured on one engine in another
    (restore, migration): ``swap_in`` there checks its CRC and writes the
    blocks into that engine's pool tensors in place; a host pool too small
    for it raises."""
    from paddle_tpu_torch.inference.paged_cache import BlockAllocator

    def engine(cap=None):
        alloc = BlockAllocator(8, 4, bytes_per_block=2 * 4 * 2 * 4)
        pools = [torch.zeros(8, 4, 2, 4) for _ in range(2)]
        return tkv.KVOffloadEngine(alloc, capacity_bytes=cap), pools

    src, src_pools = engine()
    table = [src.alloc.alloc() for _ in range(3)]
    for i, p in enumerate(src_pools):
        p[table] = torch.randn(3, 4, 2, 4, generator=torch.Generator()
                               .manual_seed(i))
    want = [p[table].clone() for p in src_pools]
    handle = src.swap_out(5, table, [], src_pools, n_tokens=10,
                          last_token=7)
    assert handle is not None and src.alloc.blocks_in_use == 0
    payload = src.host.take(handle.rid, handle.nbytes)
    dst, dst_pools = engine()
    ids = [id(p) for p in dst_pools]
    dst.adopt(handle, payload)
    assert dst.host.bytes_in_use == handle.nbytes
    assert dst.alloc.host_bytes_in_use == handle.nbytes
    new_table, pools = dst.swap_in(handle, dst_pools)
    assert [id(p) for p in pools] == ids             # written in place
    for p, w in zip(pools, want):
        assert torch.equal(p[new_table], w)
    assert dst.host.bytes_in_use == 0 and len(dst.host) == 0
    small, _ = engine(cap=handle.nbytes - 1)
    with pytest.raises(RuntimeError, match="host_pool_bytes"):
        small.adopt(handle, payload)


def test_payload_checksum_is_jax_s_over_tensors():
    """The port's checksum reads CPU tensors (bfloat16 included) as their
    bytes: the JAX checksum of the same bytes."""
    rng = np.random.default_rng(0)
    arrs = [rng.integers(-127, 128, (3, 4, 2, 8)).astype(np.int8),
            rng.standard_normal((3, 2)).astype(np.float32)]
    assert tkv.payload_checksum([torch.from_numpy(a) for a in arrs]) == \
        jkv.payload_checksum(arrs)
    b = torch.randn(5, 7).to(torch.bfloat16)
    assert tkv.payload_checksum([b]) == jkv.payload_checksum(
        [b.view(torch.int16).numpy()])


# --------------------------------------------------------------------------
# The servers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _servers(models, **kw):
    """{"jax": server, "port": server} over the same weights."""
    jm, tm = models
    jkw = dict(kw)
    if isinstance(jkw.get("spec"), SpecConfig):
        jkw["spec"] = JSpec(**{f: getattr(kw["spec"], f)
                               for f in ("k", "gate_cooldown")})
    return {"jax": JServer(jm, cache="paged", **jkw),
            "port": GenerationServer(tm, cache="paged", device="cpu", **kw)}


_COUNTERS = ("policy", "queue_depth", "submitted", "expired", "cancelled",
             "preemptions", "prefill_aborts", "resumes",
             "stalled_reservations", "host_bytes_in_use",
             "host_bytes_peak", "swapped_waiting")


def _counters(srv):
    m = srv.sched_metrics()
    return {k: m[k] for k in _COUNTERS}


_PROMPT_LENS = (12, 7, 19, 5)


def _prompts(cfg_vocab=128, lens=_PROMPT_LENS):
    rng = np.random.RandomState(11)
    return [rng.randint(1, cfg_vocab, (n,)).tolist() for n in lens]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_preempted_resume_is_token_identical(models, kv_quant):
    """A request preempted mid-decode (KV swapped to host) and resumed
    emits the tokens of a run that was never preempted: 6 usable blocks
    against a peak demand of about 8. The JAX server preempts and resumes
    the same requests at the same steps; over fp pools it emits the same
    tokens. (Over int8 pools the port clears a reused block before its
    first write, where the JAX pool requantizes a block with the rows its
    last user left: ``ROADMAP.md`` §C.)"""
    prompts = _prompts()
    ample = _servers(models, max_batch=2, max_len=96, block_size=8,
                     prefill_chunk=16, kv_quant=kv_quant)["port"]
    ra = [ample.submit(p, max_new_tokens=12) for p in prompts]
    base = ample.run()
    assert ample.sched_metrics()["preemptions"] == 0
    runs = {}
    for name, srv in _servers(models, max_batch=2, max_len=96, block_size=8,
                              prefill_chunk=16, num_blocks=7,
                              policy="priority",
                              kv_quant=kv_quant).items():
        rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
                for i, p in enumerate(prompts)]
        out = srv.run()
        runs[name] = ([out[r] for r in rids], _counters(srv), srv)
    tokens, counters, tight = runs["port"]
    assert counters == runs["jax"][1]
    assert counters["preemptions"] > 0 and counters["resumes"] > 0
    assert tokens == [base[r] for r in ra]
    if kv_quant == "none":
        assert tokens == runs["jax"][0]
    ks = tight.kv_stats()
    assert ks["swap_out_blocks"] > 0
    assert ks["swap_out_blocks"] == ks["swap_in_blocks"]
    assert ks["host_bytes_in_use"] == 0 and ks["host_bytes_peak"] > 0
    assert ks["blocks_in_use"] == 0 and ks["pinned_blocks"] == 0
    tight.assert_conserved()


def _status_trace(srv, prompts):
    """The priority-preemption script: two LOW requests fill both slots,
    a HIGH one arrives; statuses at each step until drained."""
    lows = [srv.submit(p, max_new_tokens=24, priority=LOW)
            for p in prompts[:2]]
    for _ in range(4):
        srv.step()
    trace = [[srv.status(r) for r in lows]]
    hi = srv.submit(prompts[2], max_new_tokens=4, priority=HIGH)
    srv.step()
    trace.append([srv.status(r) for r in (hi, *lows)])
    done = []
    while srv.step():
        for r in (hi, *lows):
            if srv.status(r) == "done" and r not in done:
                done.append(r)
        trace.append([srv.status(r) for r in (hi, *lows)])
    out = srv.run()
    return trace, done, [out[r] for r in (hi, *lows) if r in out], hi, lows


def test_priority_preempts_running_low_for_waiting_high(models):
    """With both slots busy on LOW work a HIGH submission evicts a victim
    and finishes first; the JAX server takes the same steps, statuses and
    tokens."""
    prompts = [_prompts(lens=(16, 14))[0], _prompts(lens=(16, 14))[1],
               _prompts(lens=(9,))[0]]
    runs = {name: (_status_trace(srv, prompts), _counters(srv))
            for name, srv in _servers(models, max_batch=2, max_len=96,
                                      block_size=8, prefill_chunk=16,
                                      policy="priority").items()}
    assert runs["port"] == runs["jax"]
    (trace, done, out, hi, lows), counters = runs["port"]
    assert all(s in ("running", "prefilling") for s in trace[0])
    assert trace[1][0] in ("running", "prefilling", "done")
    assert sum(s in ("swapped", "preempted", "queued")
               for s in trace[1][1:]) == 1
    assert done[0] == hi
    assert counters["preemptions"] + counters["prefill_aborts"] >= 1
    assert len(out[0]) == 9 + 4 and all(len(t) == 16 + 24 or
                                        len(t) == 14 + 24 for t in out[1:])


def test_cancel_mid_spec_window_rolls_back_blocks(models):
    """A cancel of a request between speculative windows returns the
    allocator to its pre-submit occupancy through ``truncate`` (the
    window's tail reservation included), and the survivor finishes with
    the JAX server's tokens."""
    res = {}
    for name, srv in _servers(models, max_batch=2, max_len=96, block_size=4,
                              prefill_chunk=8,
                              spec=SpecConfig(k=4, gate_cooldown=0)).items():
        a = srv.alloc
        usable = a.num_blocks - 1
        pre = a.blocks_in_use
        rid = srv.submit(_prompts(lens=(10,))[0], max_new_tokens=40)
        keep = srv.submit(_prompts(lens=(6,))[0], max_new_tokens=8)
        for _ in range(4):                    # prefill + spec windows ran
            srv.step()
        st = srv.status(rid)
        s = next(i for i in range(2) if srv._slots[i] is not None
                 and srv._slots[i].rid == rid)
        held = len(srv._slots[s].table)
        assert held >= -(-int(srv.pos[s]) // srv.block_size) > 0
        first = srv.cancel(rid)
        again = srv.cancel(rid)               # a no-op
        out = srv.run()
        assert a.blocks_in_use == pre
        assert a.blocks_in_use + a.blocks_cached + a.blocks_free == usable
        res[name] = (st, first, again, srv.status(rid), rid in out,
                     out[keep], srv.sched_metrics()["cancelled"])
    assert res["port"] == res["jax"]
    assert res["port"][:5] == ("running", True, False, "cancelled", False)
    assert len(res["port"][5]) == 6 + 8 and res["port"][6] == 1


def test_cancel_queued_and_swapped_discards_host_copy(models):
    prompts = _prompts()
    res = {}
    for name, srv in _servers(models, max_batch=1, max_len=96, block_size=8,
                              prefill_chunk=16, num_blocks=5,
                              policy="priority").items():
        trace = []
        lo = srv.submit(prompts[0], max_new_tokens=16, priority=LOW)
        for _ in range(3):                    # lo prefills, starts decoding
            srv.step()
        trace.append(srv.status(lo))
        q = srv.submit(prompts[1], max_new_tokens=4, priority=LOW)
        trace += [srv.status(q), srv.cancel(q)]   # cancelled while waiting
        hi = srv.submit(prompts[3], max_new_tokens=4, priority=HIGH)
        for _ in range(12):
            if srv.status(lo) == "swapped":
                break
            srv.step()
        trace += [srv.status(lo), srv.sched_metrics()["host_bytes_in_use"]]
        trace.append(srv.cancel(lo))          # parked host copy discarded
        trace.append(srv.sched_metrics()["host_bytes_in_use"])
        out = srv.run()
        trace += [sorted(out), out[hi], srv.kv_stats()["host_bytes_in_use"],
                  srv.cancel(999), srv.status(999)]
        res[name] = trace
    assert res["port"] == res["jax"]
    t = res["port"]
    assert t[:3] == ["running", "queued", True]
    assert t[3] == "swapped" and t[4] > 0 and t[5] is True and t[6] == 0
    assert t[9:] == [0, False, "unknown"] and len(t[7]) == 1


def test_ttl_expiry_and_admission_through_server(models):
    """``policy=`` takes a configured Scheduler: a bounded queue raises
    AdmissionError through submit(), and a TTL'd entry that never reaches
    a slot is dropped as "expired"."""
    prompts = _prompts()
    res = {}
    for name, mod in (("jax", jsched), ("port", tsched)):
        t = [0.0]
        sched = mod.Scheduler("fifo", max_queue=2, clock=lambda: t[0])
        jm, tm = models
        kw = dict(cache="paged", max_batch=1, max_len=96, block_size=8,
                  prefill_chunk=16, policy=sched)
        srv = JServer(jm, **kw) if name == "jax" else \
            GenerationServer(tm, device="cpu", **kw)
        a = srv.submit(prompts[0], max_new_tokens=6)
        b = srv.submit(prompts[1], max_new_tokens=6, ttl_s=5.0)
        with pytest.raises(mod.AdmissionError):
            srv.submit(prompts[3], max_new_tokens=6)
        srv.step()                            # a admitted; b waits
        c = srv.submit(prompts[2], max_new_tokens=6)
        t[0] = 10.0                           # b's deadline passes queued
        out = srv.run()
        res[name] = (srv.status(b), b in out, out[a], out[c],
                     _counters(srv))
    assert res["port"] == res["jax"]
    assert res["port"][:2] == ("expired", False)
    assert res["port"][4]["expired"] == 1


def test_overload_drains_without_deadlock_and_infeasible_rejected(models):
    """Demand far beyond the pool: every request completes (preempt /
    swap / resume churn, no deadlock), with the JAX server's tokens and
    counters, and a request that could never fit is rejected at
    submit."""
    res = {}
    for name, srv in _servers(models, max_batch=3, max_len=96, block_size=8,
                              prefill_chunk=16, num_blocks=9,
                              policy="wfq").items():
        with pytest.raises(ValueError, match="never be scheduled"):
            srv.submit(list(range(1, 70)), max_new_tokens=20)
        rng = np.random.RandomState(5)
        rids = []
        for i in range(8):
            p = rng.randint(1, 128, (int(rng.choice([5, 9, 14])),))
            rids.append(srv.submit(p.tolist(), max_new_tokens=10,
                                   tenant=("a", "b")[i % 2]))
        out = srv.run()
        ks = srv.kv_stats()
        m = srv.request_metrics()
        assert all("done_t" in m[r] and "first_token_t" in m[r]
                   for r in rids)
        res[name] = ([out[r] for r in rids], _counters(srv),
                     ks["blocks_in_use"], ks["host_bytes_in_use"])
    assert res["port"] == res["jax"]
    assert res["port"][2:] == (0, 0)


def test_preemption_adds_no_program_and_the_request_api(models):
    """After a warm preempt / resume wave, a second overload wave runs
    only the executor programs the first one used (preemption and resume
    are host work between passes: no new graph key), and the request API
    answers as the JAX server's: ``take_results``, ``steps``,
    ``load_metrics``, ``probe_prefix``, ``assert_conserved``."""
    srvs = _servers(models, max_batch=2, max_len=96, block_size=8,
                    prefill_chunk=16, num_blocks=7, policy="priority")
    port = srvs["port"]
    keys = []
    orig = port._exec._program
    port._exec._program = lambda key, *a: keys.append(key) or orig(key, *a)
    rng = np.random.RandomState(9)
    second = [rng.randint(1, 128, (n,)).tolist() for n in (11, 6, 17, 8)]
    res = {}
    for name, srv in srvs.items():
        for i, p in enumerate(_prompts()):
            srv.submit(p, max_new_tokens=12, priority=i % 2)
        first = srv.run()
        warm = set(keys)
        pre = srv.sched_metrics()["preemptions"]
        rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
                for i, p in enumerate(second)]
        if name == "port":
            assert srv.status(rids[0]) == "queued"
        while srv.step():
            srv.assert_conserved()
        got = srv.take_results()
        res[name] = (sorted(first), [got[r] for r in rids], srv.steps,
                     srv.load_metrics(), srv.probe_prefix(second[2]),
                     srv.probe_prefix([1, 2, 3]),
                     srv.sched_metrics()["preemptions"] > pre,
                     srv.take_results(), srv.assert_conserved())
    assert set(keys) == warm and warm
    jax_conserved = res["jax"][-1]
    assert res["port"][-1] == {k: jax_conserved[k] for k in
                               res["port"][-1]}
    assert res["port"][:-1] == res["jax"][:-1]
    assert res["port"][6] is True and res["port"][7] == {}
    assert res["port"][5] == 0
