"""Observability and recovery on the PyTorch port's paged server and train
engine, against the JAX package on the CPU: a 2-layer Llama from JAX
weights in fp32 through both servers under the same ``FaultPlan`` — the
same tokens, ``fired`` lists, statuses, ``sched_metrics`` (``tenants``
included) and flight-record keys — for the cases of ``tests/test_faults.py``
(tick-fault retry, poison quarantine, fatal failure, allocator exhaustion,
swap corruption → re-prefill over fp and int8 pools, snapshot / restore
with its refusals and validation ladder, a chaos soak),
``tests/test_tiered_kv.py`` (watermark demotion, demotion mid-decode,
the tier-aware probe, the host pool's refusals and the tier gauges,
adopting a peer's warm tier) and ``tests/test_telemetry.py`` (spans across
preemption, cancel mid speculative window, the registry against the
request marks, the disabled server); then migration, ``fail`` and the
train engine's retried step. JAX server runs are few: most cases hold the
port to a fault-free port run whose tokens the fixture holds to JAX's."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.faults import FaultInjector as JInjector
from paddle_tpu.inference.faults import FaultPlan as JPlan
from paddle_tpu.inference.faults import FaultSpec as JSpec
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch.faults import (EngineFailedError, FaultInjector,
                                     FaultPlan, FaultSpec, StepFault)
from paddle_tpu_torch.inference.kv_offload import HostKVPool
from paddle_tpu_torch.inference.lora import (LORA_TARGETS, AdapterRegistry,
                                             LoRAConfig, target_dims)
from paddle_tpu_torch.inference.scheduler import PRIORITY_HIGH
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.telemetry import NULL_TRACER, TrainTelemetry

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
SERVE = dict(max_batch=2, max_len=96, cache="paged", block_size=8,
             prefill_chunk=16)
TIERED = dict(max_batch=2, max_len=64, cache="paged", block_size=4,
              prefill_chunk=8)


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
    return jm, tm


def _prompts(lens=(18, 11, 7), seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (n,)).tolist() for n in lens]


def _port(models, **kw):
    return GenerationServer(models[1], device="cpu", **{**SERVE, **kw})


def _jax(models, **kw):
    return JServer(models[0], **{**SERVE, **kw})


def _plans(specs, seed=0):
    """The same plan in both packages: {"jax": injector, "port": ...}."""
    return {"jax": JInjector(JPlan([JSpec(*s) for s in specs], seed=seed)),
            "port": FaultInjector(FaultPlan([FaultSpec(*s) for s in specs],
                                            seed=seed))}


def _drive(srv, prompts, new=10, conserve=True, **submit):
    """Submit, step to the end (``assert_conserved`` after every step),
    return (tokens by request, statuses, the server's results)."""
    rids = [srv.submit(p, max_new_tokens=new, **submit) for p in prompts]
    steps = 0
    while srv.step():
        if conserve:
            srv.assert_conserved()
        steps += 1
        assert steps < 5000, "server wedged"
    statuses = [srv.status(r) for r in rids]
    out = srv.run()
    return [out.get(r) for r in rids], statuses


_COUNTERS = ("policy", "queue_depth", "submitted", "expired", "cancelled",
             "preemptions", "prefill_aborts", "resumes",
             "stalled_reservations", "host_bytes_in_use", "swapped_waiting")


def _metrics(srv):
    """``sched_metrics`` with ``tenants`` reduced to its tenants, their
    completed counts and percentile keys (their values are clock
    readings)."""
    m = srv.sched_metrics()
    out = {k: m[k] for k in _COUNTERS}
    out["tenants"] = {t: (row["completed"], sorted(row))
                      for t, row in m["tenants"].items()}
    return out


@pytest.fixture(scope="module")
def clean(models):
    """The fault-free greedy tokens of the default prompts, the port's
    held to the JAX server's."""
    want, _ = _drive(_jax(models), _prompts())
    got, _ = _drive(_port(models), _prompts())
    assert got == want
    return got


# --------------------------------------------------------------------------
# Options
# --------------------------------------------------------------------------

BAD_OPTIONS = {
    "telemetry_object": dict(telemetry=object()),
    "faults_object": dict(faults=object()),
    "fault_retries_negative": dict(fault_retries=-1),
    "fault_retries_float": dict(fault_retries=1.5),
    "tier_unpaired": dict(tier_demote_low=0.2),
    "tier_unordered": dict(tier_demote_low=0.5, tier_demote_high=0.4),
    "tier_over_one": dict(tier_demote_low=0.5, tier_demote_high=1.5),
    "warm_negative": dict(warm_pool_bytes=-1),
}


@pytest.mark.parametrize("name", sorted(BAD_OPTIONS))
def test_option_validation_is_jax_s(models, name):
    """Each bad ``telemetry=`` / ``faults=`` / ``fault_retries=`` /
    ``warm_pool_bytes=`` / ``tier_demote_*`` raises ValueError in both
    packages, with the JAX message."""
    kw = BAD_OPTIONS[name]
    with pytest.raises(ValueError) as want:
        _jax(models, **kw)
    with pytest.raises(ValueError) as got:
        _port(models, **kw)
    assert str(got.value) == str(want.value)


def test_options_are_taken(models):
    srv = _port(models, telemetry=True, fault_retries=5,
                warm_pool_bytes=1 << 20, tier_demote_low=0.2,
                tier_demote_high=0.5,
                faults=FaultInjector(FaultPlan([FaultSpec("tick")])))
    assert srv.telemetry.enabled and srv.fault_retries == 5
    assert srv._offload.warm.capacity_bytes == 1 << 20
    assert (srv.tier_demote_low, srv.tier_demote_high) == (0.2, 0.5)
    assert srv.alloc.faults is srv.faults and srv._offload.faults is srv.faults
    plain = _port(models, telemetry=False)
    assert plain.telemetry.tracer is NULL_TRACER and plain.alloc.faults is None


# --------------------------------------------------------------------------
# The degradation ladder
# --------------------------------------------------------------------------

LADDER = {
    # tick faults at trips 2 and 3: retried after a backoff
    "tick_retry": dict(specs=[("tick", 2, 2)]),
    # rid 0 takes 4 strikes > fault_retries=3: quarantined
    "poison": dict(specs=[("tick", 1, 4, "", 0)]),
    # injected exhaustion rides the preempt / stall path
    "alloc": dict(specs=[("alloc", 6, 2)]),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_fault_ladder_matches_jax(models, clean, case):
    """The same plan through both servers (telemetry on): the same tokens,
    ``fired`` lists, statuses, ``sched_metrics`` and flight-record keys;
    every request that was not quarantined finishes with the fault-free
    tokens, and pool conservation holds after every step."""
    inj = _plans(LADDER[case]["specs"])
    runs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        srv = make(models, faults=inj[name], telemetry=True)
        toks, st = _drive(srv, _prompts())
        runs[name] = (toks, st, inj[name].fired, _metrics(srv),
                      sorted({k for r in srv.telemetry.flight.dump()
                              for k in r}), srv)
    for i in range(5):
        assert runs["port"][i] == runs["jax"][i], i
    toks, st, fired, _, _, srv = runs["port"]
    assert fired
    for t, s, want in zip(toks, st, clean):
        assert t is None if s == "failed" else t == want
    if case == "poison":
        assert st[0] == "failed" and srv._quarantined == 1
        assert srv.telemetry.registry.counter(
            "serving_requests_failed").total() == 1
        extra = srv.submit(_prompts()[1], max_new_tokens=4)
        assert srv.run()[extra] == clean[1][:len(_prompts()[1]) + 4]
    if case == "tick_retry":
        assert srv._tick_faults == 2
        assert srv.telemetry.registry.counter(
            "serving_faults_injected").value(site="tick") == 2
    srv.assert_conserved()


def test_fatal_fault_leaves_the_server_failed(models):
    inj = FaultInjector(FaultPlan([FaultSpec("tick", at=0, kind="fatal")]))
    srv = _port(models, faults=inj)
    srv.submit(_prompts()[0], max_new_tokens=8)
    with pytest.raises(RuntimeError, match="injected fatal"):
        srv.run()
    with pytest.raises(EngineFailedError, match="terminal failed state"):
        srv.submit(_prompts()[1], max_new_tokens=4)
    with pytest.raises(ValueError, match="untrusted"):
        srv.snapshot()
    salvage = srv.snapshot(trust_kv=False)
    assert [d["phase"] for d in salvage["requests"]] == ["queued"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_swap_corruption_reprefills_token_identical(models, kv_quant):
    """A bit-flipped swap-in payload fails its CRC; the request re-prefills
    ``prompt + generated[:-1]`` and finishes with the tokens of a run that
    was never preempted; the host pool drains. Over fp pools the JAX
    server takes the same steps and tokens (over int8 pools the port
    clears reused blocks where JAX requantizes stale rows, ``ROADMAP.md``
    §C, so it is held to its own unpreempted run)."""
    prompts = _prompts((18, 11))
    ample, _ = _drive(_port(models, kv_quant=kv_quant), prompts, new=12)
    inj = _plans([("swap_corrupt", 0)])
    runs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        if name == "jax" and kv_quant == "int8":
            continue
        srv = make(models, num_blocks=7, policy="priority",
                   kv_quant=kv_quant, faults=inj[name], telemetry=True)
        rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
                for i, p in enumerate(prompts)]
        out = srv.run()
        runs[name] = ([out[r] for r in rids], inj[name].fired,
                      _metrics(srv), srv)
    toks, fired, sm, srv = runs["port"]
    assert sm["preemptions"] > 0 and fired == [("swap_corrupt", 0)]
    assert toks == ample
    assert srv.telemetry.registry.counter("serving_swap_reprefills") \
        .total() == 1
    assert srv.kv_stats()["host_bytes_in_use"] == 0
    spans = [s["name"] for r in range(2)
             for s in srv.telemetry.tracer.spans(r)]
    assert spans.count("swap_out") == 1 and "swap_in" not in spans
    if "jax" in runs:
        assert runs["jax"][:3] == runs["port"][:3]
    srv.assert_conserved()


@pytest.mark.parametrize("mid", ["swap", "snapshot_kv", "snapshot_salvage"])
def test_replay_rebuild_in_windows_and_mid_rebuild(models, mid):
    """The re-prefill rung's decode rebuild (the prompt prefilled, the
    generated tokens fed back one a tick) on a ``tick_window=2`` server:
    trips of one tick while a rebuild runs, then windows again, the
    unpreempted tokens; a rebuild interrupted by a swap, or snapshotted
    (its KV copied, its remaining inputs carried; or salvaged, the
    rebuild starting over) ends with the same tokens."""
    prompts = _prompts((18, 11))
    ample, _ = _drive(_port(models, tick_window=2), prompts, new=12)
    inj = FaultInjector(FaultPlan([FaultSpec("swap_corrupt", 0)]))
    srv = _port(models, num_blocks=7, policy="priority", tick_window=2,
                faults=inj)
    rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
            for i, p in enumerate(prompts)]
    while not any(r is not None and r.force for r in srv._slots):
        assert srv.step()
    req = next(r for r in srv._slots if r is not None and r.force)
    if mid == "swap":
        s = srv._slots.index(req)
        assert srv._preempt_slot(s)
        srv.assert_conserved()
        out = srv.run()
    else:
        snap = srv.snapshot(trust_kv=mid == "snapshot_kv")
        d = next(d for d in snap["requests"] if d["rid"] == req.rid)
        assert bool(d["force"]) == (mid == "snapshot_kv")
        fresh = _port(models, num_blocks=7, policy="priority",
                      tick_window=2)
        fresh.restore(snap)
        out = fresh.run()
        fresh.assert_conserved()
    assert [out[r] for r in rids] == ample


def test_host_put_refusal_stalls_token_identical(models):
    """A refused swap-out (``host_put``) leaves the victim in place: the
    run stalls instead of parking, and finishes with the unpreempted
    tokens."""
    prompts = _prompts((18, 11))
    ample, _ = _drive(_port(models), prompts, new=12)
    inj = FaultInjector(FaultPlan([FaultSpec("host_put", 0, 3)]))
    srv = _port(models, num_blocks=7, policy="priority", faults=inj)
    rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
            for i, p in enumerate(prompts)]
    out = srv.run()
    assert [out[r] for r in rids] == ample
    assert ("host_put", 0) in inj.fired
    assert srv._offload.host.puts + 3 >= len(inj.fired)
    srv.assert_conserved()


def test_drafter_fault_falls_back_to_plain_decode(models):
    """A ``drafter`` fault in an n-gram speculative server runs the trip
    through the plain decode program and holds the gate off: the tokens
    are the plain server's, the firing counted."""
    prompts = _prompts((10, 6))
    plain, _ = _drive(_port(models, block_size=4, prefill_chunk=8),
                      prompts, new=8)
    inj = FaultInjector(FaultPlan([FaultSpec("drafter", at=1)]))
    srv = _port(models, block_size=4, prefill_chunk=8, faults=inj,
                spec=SpecConfig(k=4, gate_cooldown=0))
    toks, _ = _drive(srv, prompts, new=8)
    assert toks == plain and inj.fired == [("drafter", 1)]
    assert srv.telemetry.registry.counter(
        "serving_faults_injected").value(site="drafter") == 1
    assert srv.spec_metrics()["gated_plain_windows"] > 0


def test_watchdog_pressure_finding_degrades_the_server(models):
    """Every 32 flight records the watchdog runs over the last 64: a
    preemption storm puts the server in its degraded mode (64 steps;
    speculation off, admission asking for 3 spare blocks), counted once
    per entry."""
    srv = _port(models, telemetry=True, block_size=4, prefill_chunk=8,
                spec=SpecConfig(k=4, gate_cooldown=0))
    for i in range(31):
        srv.telemetry.flight.record(prog="x", preemptions=1, stalls=0,
                                    recompiles=0)
    srv.submit(_prompts((6,))[0], max_new_tokens=4)
    srv.step()
    assert srv._degraded_ticks == 64
    assert srv.telemetry.registry.counter("serving_degrade_events") \
        .value(kind="preemption_storm") == 1
    proposed = srv.spec_metrics()["draft_tokens_proposed"]
    srv.run()
    assert srv.spec_metrics()["draft_tokens_proposed"] == proposed
    assert srv.spec_metrics()["gated_plain_windows"] > 0


def test_assert_conserved_detects_leaks(models):
    srv = _port(models)
    srv.submit(_prompts()[0], max_new_tokens=4)
    srv.run()
    audit = srv.assert_conserved()
    assert audit["blocks_in_use"] == 0 and audit["warm_blocks"] == 0
    leaked = srv.alloc.alloc()
    with pytest.raises(AssertionError, match="refcount audit"):
        srv.assert_conserved()
    srv.alloc.free(leaked)
    srv._offload.warm.bytes_in_use += 1
    with pytest.raises(AssertionError, match="warm tier ledger"):
        srv.assert_conserved()


def test_chaos_soak_matches_jax(models):
    """``FaultPlan.chaos(3)`` against a bursty priority workload on a
    tight pool, both servers: the same firings, statuses and tokens;
    every request not quarantined equals the fault-free run; conservation
    after every step."""
    rng = np.random.RandomState(23)
    prompts = [rng.randint(1, 128, (n,)).tolist() for n in (18, 9, 13, 7, 11)]
    kw = dict(num_blocks=10, policy="priority")

    def submit(srv):
        return [srv.submit(p, max_new_tokens=8,
                           priority=PRIORITY_HIGH if i == 2 else 1)
                for i, p in enumerate(prompts)]
    base_srv = _port(models, **kw)
    rb = submit(base_srv)
    base = base_srv.run()
    runs = {}
    for name, make, plan in (("jax", _jax, JPlan.chaos),
                             ("port", _port, FaultPlan.chaos)):
        inj = (JInjector if name == "jax" else FaultInjector)(
            plan(3, horizon=40))
        srv = make(models, faults=inj, **kw)
        rs = submit(srv)
        steps = 0
        while srv.step():
            srv.assert_conserved()
            steps += 1
            assert steps < 5000
        st = [srv.status(r) for r in rs]
        out = srv.run()
        runs[name] = (inj.fired, st, [out.get(r) for r in rs])
    assert runs["port"] == runs["jax"]
    fired, st, toks = runs["port"]
    assert fired
    for r, s, t in zip(rb, st, toks):
        assert t is None if s == "failed" else t == base[r]


# --------------------------------------------------------------------------
# Snapshot / restore and migration
# --------------------------------------------------------------------------

def _mid_flight(models, kv_quant="none", lora=None, adapters=None, **kw):
    srv = _port(models, kv_quant=kv_quant, lora=lora, **kw)
    rids = [srv.submit(p, max_new_tokens=12, adapter=a)
            for p, a in zip(_prompts(), adapters or [None] * 3)]
    for _ in range(4):       # decoding slots and a queued request
        srv.step()
    assert any(srv.status(r) == "running" for r in rids)
    return srv, rids


@pytest.mark.parametrize("trust_kv", [True, False], ids=["kv", "salvage"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_snapshot_restore_token_identical(models, clean, kv_quant, trust_kv):
    """``snapshot()`` mid-flight, ``restore()`` into a fresh server: every
    request finishes with the tokens the captured server goes on to make
    (it keeps serving), with the KV copied (``trust_kv=True``) or rebuilt
    by re-prefill (salvage); a second restore into the warm server again;
    over fp pools these are the JAX server's tokens (``clean``)."""
    srv, rids = _mid_flight(models, kv_quant)
    snap = srv.snapshot(trust_kv=trust_kv)
    phases = sorted(d["phase"] for d in snap["requests"])
    assert phases == (["kv", "kv", "queued"] if trust_kv
                      else ["queued"] * 3)
    base = srv.run()
    if kv_quant == "none":
        # batch-invariant products: a request's first 10 tokens are the
        # fault-free run's whatever the batch
        assert [base[r][:len(p) + 10] for r, p in zip(rids, _prompts())] \
            == clean
    fresh = _port(models, kv_quant=kv_quant)
    assert fresh.restore(snap) == len(rids)
    out = fresh.run()
    assert all(out[r] == base[r] for r in rids)
    fresh.assert_conserved()
    assert fresh.restore(snap) == len(rids)
    out2 = fresh.run()
    assert all(out2[r] == base[r] for r in rids)


def test_snapshot_restore_matches_the_jax_round_trip(models):
    """Both servers snapshot the same mid-flight state and restore it into
    a fresh server of their own: the same phases and tokens."""
    res = {}
    for name, make in (("jax", _jax), ("port", _port)):
        srv = make(models)
        rids = [srv.submit(p, max_new_tokens=12) for p in _prompts()]
        for _ in range(4):
            srv.step()
        snap = srv.snapshot()
        fresh = make(models)
        fresh.restore(snap)
        out = fresh.run()
        res[name] = ([d["phase"] for d in snap["requests"]],
                     sorted(snap["config"]), [out[r] for r in rids],
                     snap["step_no"], snap["next_rid"])
    assert res["port"][0] == res["jax"][0]
    assert res["port"][2:] == res["jax"][2:]
    assert set(res["port"][1]) <= set(res["jax"][1])


def _adapter_weights(cfg, rank, seed, sd=(0.02, 0.05)):
    rng = np.random.RandomState(seed)
    dims = target_dims(cfg)
    return {(layer, t): (
        rng.normal(0, sd[0], (dims[t][0], rank)).astype(np.float32),
        rng.normal(0, sd[1], (rank, dims[t][1])).astype(np.float32))
        for layer in range(cfg.num_hidden_layers) for t in LORA_TARGETS}


def _registry(cfg):
    reg = AdapterRegistry()
    reg.register("a1", _adapter_weights(cfg, 4, seed=1), rank=4, alpha=8.0)
    reg.register("a2", _adapter_weights(cfg, 2, seed=2), rank=2, alpha=2.0)
    return reg


def test_snapshot_restore_with_lora_adapters(models):
    cfg = models[1].cfg
    reg = _registry(cfg)
    lora = dict(max_live_adapters=4, max_rank=4)
    srv, rids = _mid_flight(models, lora=LoRAConfig(reg, **lora),
                            adapters=["a1", "a2", None])
    snap = srv.snapshot()
    base = srv.run()
    fresh = _port(models, lora=LoRAConfig(reg, **lora))
    assert fresh.restore(snap) == len(rids)
    out = fresh.run()
    assert all(out[r] == base[r] for r in rids)
    fresh.assert_conserved()


def test_restore_refuses_bad_targets(models):
    srv, rids = _mid_flight(models)
    snap = srv.snapshot()
    with pytest.raises(ValueError, match="idle"):
        srv.restore(snap)
    with pytest.raises(ValueError, match="block_size"):
        _port(models, block_size=4).restore(snap)
    with pytest.raises(ValueError, match="format"):
        _port(models).restore(dict(snap, format=2))
    failed = _port(models)
    failed.fail("down")
    failed.fail("ignored")
    with pytest.raises(ValueError, match="down"):
        failed.restore(snap)
    with pytest.raises(EngineFailedError, match="down"):
        failed.admit_migrated(snap["requests"][0])
    srv.run()


def test_restore_validation_ladder_leaves_the_target_untouched(models):
    """kv_quant mismatch, a shrunk pool, no LoRA stack and an unknown
    adapter each raise and leave the target conserved, idle and serving;
    the same snapshot then restores token-identically."""
    cfg = models[1].cfg
    reg = _registry(cfg)
    lora = dict(max_live_adapters=4, max_rank=4)
    srv = _port(models, num_blocks=24, lora=LoRAConfig(reg, **lora))
    rids = [srv.submit(p, max_new_tokens=12,
                       adapter="a1" if i == 0 else None)
            for i, p in enumerate(_prompts())]
    for _ in range(4):
        srv.step()
    snap = srv.snapshot()
    base = srv.run()

    def rejects(target, match):
        with pytest.raises(ValueError, match=match):
            target.restore(snap)
        audit = target.assert_conserved()
        assert audit["blocks_in_use"] == 0 and audit["host_bytes_in_use"] == 0
        assert target.load_metrics()["queue_depth"] == 0
        r = target.submit(_prompts()[2], max_new_tokens=4)
        assert r in target.run()

    rejects(_port(models, num_blocks=24, kv_quant="int8",
                  lora=LoRAConfig(reg, **lora)), "kv_quant")
    rejects(_port(models, num_blocks=12, lora=LoRAConfig(reg, **lora)),
            "blocks")
    rejects(_port(models, num_blocks=24), "lora")
    rejects(_port(models, num_blocks=24,
                  lora=LoRAConfig(AdapterRegistry(), **lora)),
            "unknown adapter")
    good = _port(models, num_blocks=24, lora=LoRAConfig(reg, **lora))
    assert good.restore(snap) == len(rids)
    out = good.run()
    assert all(out[r] == base[r] for r in rids)
    good.assert_conserved()


def test_restore_under_live_fault_injection(models):
    """The restoring server's own plan corrupts the restored payloads,
    exhausts its allocator and faults a tick: the CRC rung fires, every
    request not quarantined finishes as the captured server does."""
    srv, rids = _mid_flight(models)
    snap = srv.snapshot()
    base = srv.run()
    inj = FaultInjector(FaultPlan([FaultSpec("swap_corrupt", 0, 2),
                                   FaultSpec("tick", 1, 1),
                                   FaultSpec("alloc", 2, 2)], seed=13))
    fresh = _port(models, faults=inj)
    assert fresh.restore(snap) == len(rids)
    steps = 0
    while fresh.step():
        fresh.assert_conserved()
        steps += 1
        assert steps < 5000, "restore under faults wedged"
    statuses = [fresh.status(r) for r in rids]
    done = fresh.run()
    assert inj.fired
    assert fresh.telemetry.registry.counter(
        "serving_swap_reprefills").total() >= 1
    for r, st in zip(rids, statuses):
        assert st == "failed" or done.get(r) == base[r]


def test_evacuate_and_admit_into_a_busy_server(models):
    """``evacuate(rids=)`` moves one decoding request (its KV copied) out
    of a server; ``admit_migrated`` puts it into a server busy with its
    own request; both finish with their uninterrupted tokens; a full
    ``evacuate`` then empties the source."""
    want, _ = _drive(_port(models), _prompts(), new=12)
    own_prompt = _prompts((9,), seed=3)[0]
    own_want, _ = _drive(_port(models), [own_prompt], new=6)
    srv, rids = _mid_flight(models)
    moving = next(d for d in srv.snapshot()["requests"] if d["phase"] == "kv")
    snap = srv.evacuate(rids=[moving["rid"]])
    assert [d["rid"] for d in snap["requests"]] == [moving["rid"]]
    assert srv.status(moving["rid"]) == "unknown"
    srv.assert_conserved()
    busy = _port(models)
    with pytest.raises(ValueError, match="int >= 0"):
        busy.set_rid_base(-1)
    busy.set_rid_base(100)                # rids unique across servers
    own = busy.submit(own_prompt, max_new_tokens=6)
    busy.step()
    assert busy.admit_migrated(snap["requests"][0],
                               source_config=snap["config"]) == moving["rid"]
    out = busy.run()
    assert out[moving["rid"]] == want[rids.index(moving["rid"])]
    assert out[own] == own_want[0]
    busy.assert_conserved()
    with pytest.raises(ValueError, match="fresh server"):
        busy.set_rid_base(0)
    rest = srv.evacuate()
    assert len(rest["requests"]) == 2 and srv.load_metrics()[
        "slots_occupied"] == 0 and srv.assert_conserved()["blocks_in_use"] == 0


# --------------------------------------------------------------------------
# The warm KV tier
# --------------------------------------------------------------------------

def test_watermark_demotion_token_exact_and_conserved(models):
    """A block-starved server with watermarks demotes under pressure and
    emits the tokens of an unpressured run (and, for the same plan, the
    JAX server's demotions), conserved at every step."""
    prompts = _prompts((17, 13, 21, 9, 15), seed=4)
    ref, _ = _drive(_port(models, **TIERED), prompts, new=8)
    runs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        srv = make(models, num_blocks=20, tier_demote_low=0.3,
                   tier_demote_high=0.7, **TIERED)
        toks, _ = _drive(srv, prompts, new=8)
        st = srv.kv_stats()
        runs[name] = (toks, st["warm_demoted_blocks"],
                      st["warm_promoted_blocks"], st["cold_refills"])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == ref and runs["port"][1] > 0


def test_mid_decode_demotion_conserved_and_promotable(models):
    pa, pb = _prompts((19, 14), seed=5)
    ref, _ = _drive(_port(models, **TIERED), [pa, pb], new=8)
    srv = _port(models, **TIERED)
    assert _drive(srv, [pa], new=8)[0][0] == ref[0]
    r2 = srv.submit(pb, max_new_tokens=8)
    srv.step()
    srv.step()                           # pb mid-decode
    victims = srv.alloc.coldest_cached(8)
    assert victims
    assert srv._offload.demote(victims, srv._exec._flat_pools) == \
        len(victims)
    srv.assert_conserved()
    while srv.step():
        srv.assert_conserved()
    assert srv.take_results()[r2] == ref[1]
    before = srv.kv_stats()
    assert _drive(srv, [pa], new=8)[0][0] == ref[0]
    after = srv.kv_stats()
    assert after["warm_promoted_blocks"] > before["warm_promoted_blocks"]
    assert after["cold_refills"] == before["cold_refills"] + 1
    srv.assert_conserved()


def test_probe_prefix_agrees_with_tiered_match_and_is_read_only(models):
    prompt = _prompts((21,), seed=6)[0]
    srv = _port(models, **TIERED)
    _drive(srv, [prompt], new=6)
    a = srv.alloc
    full = (len(prompt) - 1) // 4
    assert srv._offload.demote(a.coldest_cached(2), srv._exec._flat_pools) == 2
    pre = (dict(srv._offload.warm.stats()), a.blocks_free,
           a.prefix_lookup_blocks, a.prefix_hit_blocks)
    hits = a.probe_prefix(prompt)
    assert hits == full == srv.probe_prefix(prompt)
    assert a.probe_prefix(prompt, hot_only=True) < full
    assert (dict(srv._offload.warm.stats()), a.blocks_free,
            a.prefix_lookup_blocks, a.prefix_hit_blocks) == pre
    pools = srv._exec._flat_pools
    table, out, st = srv._offload.match_prefix_tiered(prompt, pools)
    assert out is pools and len(table) == hits
    assert st == {"hot": hits - 2, "warm": 2}
    assert len(srv._offload.warm) == 0
    for bid in table:
        a.free(bid)
    srv.assert_conserved()


def test_promotion_writes_the_demoted_bytes_into_the_same_pools(models):
    """A demoted block's bytes come back bit for bit, through
    ``index_copy_`` into the pool tensors the server holds (int8 codes and
    scales included); an int8 pool's promoted block is not cleared."""
    prompt = _prompts((21,), seed=6)[0]
    srv = _port(models, kv_quant="int8", **TIERED)
    _drive(srv, [prompt], new=6)
    pools = srv._exec._flat_pools
    ids = [id(p) for p in pools]
    victims = srv.alloc.coldest_cached(3)
    want = [p[[b for b, _ in victims]].clone() for p in pools]
    cleared = []
    orig = srv._exec.clear_blocks
    srv._exec.clear_blocks = lambda bids: (cleared.extend(bids),
                                           orig(bids))
    srv._offload.demote(victims, pools)
    for p in pools:                      # the freed blocks scribbled on
        p[[b for b, _ in victims]] = 0
    hashes = [h for _, h in victims]
    table, _, st = srv._offload.match_prefix_tiered(prompt, pools)
    assert st["warm"] == 3 and [id(p) for p in pools] == ids
    back = [table[i] for i, h in enumerate(srv.alloc.chain_hashes(prompt))
            if h in hashes]
    for p, w in zip(pools, want):
        assert torch.equal(p[back], w)
    assert not set(back) & set(cleared)
    for bid in table:
        srv.alloc.free(bid)


def test_host_pool_rejects_counter_and_server_gauge(models):
    pool = HostKVPool(capacity_bytes=64)
    assert pool.put(1, [np.zeros(8, np.float32)], 32)
    assert not pool.put(2, [np.zeros(64, np.float32)], 256)
    assert pool.stats() == {"bytes_in_use": 32, "bytes_peak": 32, "puts": 1,
                            "takes": 0, "rejects": 1, "parked": 1}
    assert pool.peek(1)[0].shape == (8,)
    srv = _port(models, telemetry=True, **TIERED)
    srv._offload.host = HostKVPool(capacity_bytes=8)
    assert not srv._offload.host.put(7, [np.zeros(16, np.float32)], 64)
    srv.telemetry_snapshot()
    reg = srv.telemetry.registry
    assert reg.gauge("serving_host_pool_rejects").value() == 1.0
    assert reg.gauge("serving_host_pool_bytes_in_use").value() == 0.0


def test_server_exports_tier_gauges(models):
    srv = _port(models, telemetry=True, **TIERED)
    _drive(srv, _prompts((17,), seed=8), new=4)
    assert srv._offload.demote(srv.alloc.coldest_cached(2),
                               srv._exec._flat_pools) == 2
    snap = srv.telemetry_snapshot()
    reg = srv.telemetry.registry
    assert reg.gauge("serving_tier_warm_blocks").value() == 2.0
    assert reg.gauge("serving_tier_warm_demoted_blocks").value() == 2.0
    assert reg.gauge("serving_tier_warm_bytes_in_use").value() > 0.0
    assert reg.gauge("serving_tier_cold_refills").value() == 0.0
    assert reg.gauge("kv_pool_demoted_blocks").value() == 2.0
    assert snap["config"]["kv_quant"] == "none"
    json.dumps(snap)


def test_adopt_warm_carries_a_demoted_prefix_across_servers(models):
    prompt = _prompts((21,), seed=10)[0]
    a = _port(models, **TIERED)
    ref = _drive(a, [prompt], new=6)[0][0]
    assert a._offload.demote(a.alloc.coldest_cached(8),
                             a._exec._flat_pools) > 0
    entries = a.snapshot()["warm_tier"]
    assert entries
    b = _port(models, **TIERED)
    assert b.adopt_warm(entries) == len(entries)
    assert b.adopt_warm(entries) == 0
    bad = [dict(entries[0], checksum=entries[0]["checksum"] ^ 1)]
    assert _port(models, **TIERED).adopt_warm(bad) == 0
    assert _drive(b, [prompt], new=6)[0][0] == ref
    st = b.kv_stats()
    assert st["warm_promoted_blocks"] == len(entries)
    assert st["cold_refills"] == 1
    b.assert_conserved()


# --------------------------------------------------------------------------
# Server telemetry
# --------------------------------------------------------------------------

def test_preempt_swap_resume_spans_match_jax(models, tmp_path):
    """A request preempted mid-decode shows queued → prefill →
    decode_window* → swap_out → preempted → swap_in → decode_window* →
    complete on one chrome-trace row, as on the JAX server; no span stays
    open; ``sched_metrics`` is a view of the registry."""
    prompts = _prompts((21, 33, 18, 27))
    names = {}
    for name, make in (("jax", _jax), ("port", _port)):
        srv = make(models, num_blocks=7, policy="priority", telemetry=True)
        rids = [srv.submit(p, max_new_tokens=12, priority=i % 2)
                for i, p in enumerate(prompts)]
        out = srv.run()
        tr = srv.telemetry.tracer
        names[name] = [[s["name"] for s in tr.spans(r)] for r in rids]
        if name == "jax":
            continue
        assert sorted(out) == sorted(rids)
        sm = srv.sched_metrics()
        reg = srv.telemetry.registry
        assert sm["preemptions"] >= 1 and sm["resumes"] >= 1
        assert sm["preemptions"] == reg.counter("serving_preemptions").total()
        assert sm["submitted"] == len(rids) == reg.counter(
            "sched_requests_submitted").total()
        for r in rids:
            assert tr.open_spans(r) == []
        victim = next(r for r, n in zip(rids, names["port"])
                      if "swap_out" in n)
        path = srv.export_chrome_trace(str(tmp_path / "trace.json"))
        evs = json.load(open(path))["traceEvents"]
        vnames = {e["name"] for e in evs if e.get("tid") == victim
                  and e["ph"] in ("X", "i")}
        assert {"swap_out", "swap_in", "decode_window"} <= vnames
        ticks = srv.telemetry.flight.dump()
        assert sum(t["preemptions"] for t in ticks) >= 1
        assert all("blocks_in_use" in t and "prog" in t for t in ticks)
    assert names["port"] == names["jax"]
    for n in names["port"]:
        assert n[0] == "queued" and n[-1] == "complete" and \
            "first_token" in n


def test_cancel_mid_spec_window_closes_spans(models):
    srv = _port(models, block_size=4, prefill_chunk=8, telemetry=True,
                spec=SpecConfig(k=4, gate_cooldown=0))
    rid = srv.submit(_prompts((10,))[0], max_new_tokens=40)
    keep = srv.submit(_prompts((6,))[0], max_new_tokens=8)
    for _ in range(4):
        srv.step()
    assert srv.status(rid) == "running" and srv.cancel(rid)
    out = srv.run()
    assert rid not in out and keep in out
    tr = srv.telemetry.tracer
    assert tr.open_spans(rid) == []
    names = [s["name"] for s in tr.spans(rid)]
    assert "spec_window" in names and "cancelled" in names
    assert srv.telemetry.registry.counter("serving_requests_dropped") \
        .value(reason="cancelled") == 1 == srv.sched_metrics()["cancelled"]
    assert [s["name"] for s in tr.spans(keep)][-1] == "complete"
    assert any(t.get("spec_proposed", 0) > 0
               for t in srv.telemetry.flight.dump())


def test_registry_reproduces_request_metrics_percentiles(models):
    srv = _port(models, telemetry=True)
    rids = [srv.submit(p, max_new_tokens=8, tenant="t" + str(i % 2))
            for i, p in enumerate(_prompts((9, 17, 12, 30, 7, 22)))]
    srv.run()
    rm = srv.request_metrics()
    ttft = [rm[r]["first_token_t"] - rm[r]["submit_t"] for r in rids]
    tpot = [1e3 * (rm[r]["done_t"] - rm[r]["first_token_t"])
            / (rm[r]["n_generated"] - 1) for r in rids]
    reg = srv.telemetry.registry
    for q in (50, 95):
        assert reg.percentile("serving_ttft_s", q) == pytest.approx(
            float(np.percentile(ttft, q)), rel=1e-9)
        assert reg.percentile("serving_tpot_ms", q) == pytest.approx(
            float(np.percentile(tpot, q)), rel=1e-9)
    tb = srv.sched_metrics()["tenants"]
    assert sorted(tb) == ["t0", "t1"] and tb["t0"]["completed"] == 3
    assert tb["t0"]["ttft_p50_ms"] == pytest.approx(
        float(np.percentile(ttft[0::2], 50)) * 1e3, rel=1e-9)
    slo = srv.slo_observations()
    assert sorted(slo["ttft"]) == ["t0", "t1"] and len(slo["tpot"]["t1"]) == 3
    json.dumps(srv.telemetry_snapshot())
    assert srv.watchdog_findings() == []


def test_tenants_and_flight_keys_match_jax(models):
    """With one constant clock, the JAX and port servers' ``tenants`` and
    the keys of their flight records are equal."""
    res = {}
    for name, make in (("jax", _jax), ("port", _port)):
        srv = make(models, telemetry=True, clock=lambda: 5.0)
        [srv.submit(p, max_new_tokens=6, tenant=t) for p, t in
         zip(_prompts(), ("a", "b", "a"))]
        srv.run()
        res[name] = (srv.sched_metrics()["tenants"],
                     [sorted(r) for r in srv.telemetry.flight.dump()])
    assert res["port"][0] == res["jax"][0]
    assert {tuple(k) for k in res["port"][1]} == \
        {tuple(k) for k in res["jax"][1]}


def test_disabled_server_records_nothing_but_counts(models):
    srv = _port(models)
    rids = [srv.submit(p, max_new_tokens=6) for p in _prompts((9, 14))]
    srv.run()
    assert srv.telemetry.enabled is False
    assert srv.telemetry.tracer is NULL_TRACER
    assert srv.telemetry.flight.total == 0
    assert srv.sched_metrics()["submitted"] == len(rids)
    assert srv.telemetry.registry.percentile("serving_ttft_s", 50) \
        is not None


# --------------------------------------------------------------------------
# The train engine
# --------------------------------------------------------------------------

def test_train_step_fault_retry_leaves_parameters_equal():
    """A ``train_step`` fault at step 3 raises ``StepFault`` before the
    step changes anything; the retried step leaves the parameters, the
    moments and the step count bit-equal to a fault-free run after 5
    steps, and the retry books no lost goodput."""
    from paddle_tpu_torch.models.llama import llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    def engine(injector=None, telemetry=None):
        torch.manual_seed(0)
        m = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                             device="cpu")
        return ParallelEngine(m, optimizer=AdamW(
            learning_rate=1e-3, parameters=m.named_parameters()),
            injector=injector, telemetry=telemetry)

    g = torch.Generator().manual_seed(3)
    batches = [torch.randint(0, 1024, (2, 17), generator=g)
               for _ in range(5)]
    ref = engine()
    for b in batches:
        ref.train_batch(b[:, :-1], b[:, 1:])
    inj = FaultInjector(FaultPlan([FaultSpec("train_step", at=3)]))
    tel = TrainTelemetry()
    eng = engine(inj, tel)
    for i, b in enumerate(batches):
        if i == 3:
            before = eng.engine_state_dict()
            with pytest.raises(StepFault, match="step 3"):
                eng.train_batch(b[:, :-1], b[:, 1:])
            after = eng.engine_state_dict()
            assert after["step"] == before["step"] == 3
            for n in before["params"]:
                assert np.array_equal(after["params"][n],
                                      before["params"][n])
        eng.train_batch(b[:, :-1], b[:, 1:])
    assert inj.fired == [("train_step", 3)]
    want, got = ref.engine_state_dict(), eng.engine_state_dict()
    assert got["step"] == want["step"] == 5
    for n in want["params"]:
        assert np.array_equal(got["params"][n], want["params"][n]), n
    for n in want["opt_state"]:
        for k in want["opt_state"][n]:
            assert np.array_equal(got["opt_state"][n][k],
                                  want["opt_state"][n][k])
    assert [r["step"] for r in tel.flight.dump()] == [0, 1, 2, 3, 4]
    assert tel.goodput.ratio() == 1.0
    fatal = engine(FaultInjector(FaultPlan([FaultSpec("train_step",
                                                      kind="fatal")])))
    with pytest.raises(RuntimeError, match="fatal"):
        fatal.train_batch(batches[0][:, :-1], batches[0][:, 1:])
