"""The serving fleet on the PyTorch port (``paddle_tpu_torch/inference/
fleet.py``) against the JAX package on the CPU: a 2-layer Llama from JAX
weights in fp32, the port's replicas on the CPU, the cases of
``tests/test_fleet.py`` — prefix- and load-aware routing over disjoint
rid spaces (rids past 2**32), the heartbeat state machine against an
injectable clock, token-exact drains (fp and int8 pools, LoRA), the
``migrate_payload`` / ``route`` / ``replica_down`` fault sites, the
quarantine, ``fleet_metrics`` and the per-tenant SLO roll-up.

Tolerances: tokens exact (greedy) — the port's fleet against the port's
single engine and against the JAX fleet on the same traffic and fault
plan; the rid → replica assignment, the ``fired`` list and every
``fleet_metrics`` field but the clock readings (migration latencies, the
SLO roll-up's samples) exact against the JAX router. Where a request
takes the re-prefill rung (a salvage after ``replica_down``, a payload
that fails its CRC) the port rebuilds its generated tokens through the
decode program, one step a token, where the JAX server prefills them in
chunks (ROADMAP §C, deliberate divergences): there the engine step
counts (``ticks``, each row's ``steps``) are at least the JAX router's,
and a replica re-prefilling without a decode step reads as one
heartbeat stall in JAX only."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import AdapterRegistry as JRegistry
from paddle_tpu.inference import LoRAConfig as JLoRAConfig
from paddle_tpu.inference.faults import FaultInjector as JInjector
from paddle_tpu.inference.faults import FaultPlan as JPlan
from paddle_tpu.inference.faults import FaultSpec as JSpec
from paddle_tpu.inference.fleet import FleetRouter as JFleet
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch.faults import (EngineFailedError, FaultInjector,
                                     FaultPlan, FaultSpec)
from paddle_tpu_torch.inference import FleetRouter, InProcessReplica
from paddle_tpu_torch.inference.fleet import (REPLICA_DEAD,
                                              REPLICA_DEGRADED,
                                              REPLICA_LIVE, RID_STRIDE)
from paddle_tpu_torch.inference.lora import (LORA_TARGETS, AdapterRegistry,
                                             LoRAConfig, target_dims)
from paddle_tpu_torch.inference.scheduler import AdmissionError, Scheduler
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_tensor_parity import jax_jit_at_o0

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
SERVE = dict(max_batch=2, max_len=96, cache="paged", block_size=8,
             prefill_chunk=16)
# fleet_metrics fields that are clock readings
TIMING = ("migration_latency_p50_s", "migration_latency_p95_s", "slo")


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


def _prompts(lens=(18, 11, 7, 9), seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (n,)).tolist() for n in lens]


def _port(models, **kw):
    return GenerationServer(models[1], device="cpu", **{**SERVE, **kw})


def _jax(models, **kw):
    return JServer(models[0], **{**SERVE, **kw})


def _adapter_weights(cfg, rank, seed):
    rng = np.random.RandomState(seed)
    dims = target_dims(cfg)
    w = {}
    for layer in range(cfg.num_hidden_layers):
        for t in LORA_TARGETS:
            fi, fo = dims[t]
            w[(layer, t)] = (rng.normal(0, 0.02, (fi, rank)).astype(np.float32),
                             rng.normal(0, 0.05, (rank, fo)).astype(np.float32))
    return w


def _loras(models):
    """The same two adapters in both packages: {"jax": LoRAConfig maker,
    "port": ...}."""
    cfg = models[1].cfg
    entries = [("a1", _adapter_weights(cfg, 4, 1), 4, 8.0),
               ("a2", _adapter_weights(cfg, 2, 2), 2, 2.0)]
    jr, tr = JRegistry(), AdapterRegistry()
    for name, w, rank, alpha in entries:
        jr.register(name, w, rank=rank, alpha=alpha)
        tr.register(name, w, rank=rank, alpha=alpha)
    return {"jax": lambda: JLoRAConfig(jr, max_live_adapters=4, max_rank=4),
            "port": lambda: LoRAConfig(tr, max_live_adapters=4, max_rank=4)}


def _baseline(make, prompts, max_new=12, adapters=None):
    """Undisturbed single-engine run: the token-identity oracle."""
    srv = make()
    akw = [{"adapter": a} for a in (adapters or [None] * len(prompts))]
    rids = [srv.submit(p, max_new_tokens=max_new, **a)
            for p, a in zip(prompts, akw)]
    out = srv.run()
    return [out[r] for r in rids]


def _view(fleet):
    """``fleet_metrics()`` less its clock readings."""
    fm = fleet.fleet_metrics()
    return {k: v for k, v in fm.items() if k not in TIMING}


def _less_steps(view):
    """A fleet view less its engine step counts and heartbeat stalls:
    what the re-prefill rung's decode rebuild changes (module
    docstring)."""
    out = {k: v for k, v in view.items()
           if k not in ("ticks", "heartbeat_stalls")}
    out["replicas"] = [{k: v for k, v in row.items() if k != "steps"}
                       for row in view["replicas"]]
    return out


@pytest.fixture(scope="module")
def clean(models):
    """The port's single-engine tokens of the default prompts, held to the
    JAX server's."""
    with jax_jit_at_o0():
        want = _baseline(lambda: _jax(models), _prompts())
    got = _baseline(lambda: _port(models), _prompts())
    assert got == want
    return got


# --------------------------------------------------------------------------
# The port's fleet against the JAX fleet: same traffic, same fault plan
# --------------------------------------------------------------------------

def _scenario(models, pkg, case, lora=None):
    """One fleet run of ``case`` in package ``pkg`` ("jax" / "port"):
    (tokens, rid → replica, fleet view, fired, replica states)."""
    make = _jax if pkg == "jax" else _port
    inj_cls, plan_cls, spec_cls = ((JInjector, JPlan, JSpec) if pkg == "jax"
                                   else (FaultInjector, FaultPlan, FaultSpec))
    fleet_cls = JFleet if pkg == "jax" else FleetRouter
    kv_quant = "int8" if case.endswith("int8") else "none"
    kw = dict(kv_quant=kv_quant)
    if lora is not None:
        kw["lora"] = lora[pkg]()
    adapters = ["a1", "a2", None, "a1"] if lora is not None else None
    faults, n, drain = None, 2, False
    if case.startswith("chaos"):
        faults = inj_cls(plan_cls.fleet_chaos(3, replicas=2))
    elif case.startswith("drain"):
        n, drain = 3, True
    elif case == "corrupt":
        faults = inj_cls(plan_cls([spec_cls("migrate_payload", at=0)],
                                  seed=17))
        drain = True
    elif case == "route":
        faults = inj_cls(plan_cls([spec_cls("route", at=0, count=1)]))
    fleet = fleet_cls([make(models, **kw) for _ in range(n)], faults=faults)
    akw = [{"adapter": a} for a in (adapters or [None] * 4)]
    rids = [fleet.submit(p, max_new_tokens=12, **a)
            for p, a in zip(_prompts(), akw)]
    if drain:
        for _ in range(4):
            fleet.step()
        assert fleet.drain(0) >= 1
    out = fleet.run()
    fleet.assert_conserved()
    home = {r: fleet._home[r] for r in rids}
    fired = list(faults.fired) if faults is not None else []
    return ([out[r] for r in rids], home, _view(fleet), fired,
            fleet.replica_states())


@pytest.mark.parametrize("case", ["drain", "drain_int8", "drain_lora",
                                  "chaos", "chaos_int8", "chaos_lora",
                                  "corrupt", "route"])
def test_fleet_matches_the_jax_fleet(models, clean, case):
    """Drain mid-decode (3 replicas; fp, int8, LoRA), the seeded chaos plan
    (one replica down mid-decode, a payload bit flip, misroutes; fp,
    int8, LoRA), a corrupted drain payload and a misroute: the port's
    fleet finishes with the JAX fleet's tokens — the port's single
    engine's too — on the same replicas, firing the same faults, with the
    same ``fleet_metrics`` (clock readings aside)."""
    lora = _loras(models) if case.endswith("lora") else None
    with jax_jit_at_o0():
        want = _scenario(models, "jax", case, lora)
    got = _scenario(models, "port", case, lora)
    if lora is not None:
        base = _baseline(lambda: _port(models, lora=lora["port"]()),
                         _prompts(), adapters=["a1", "a2", None, "a1"])
    elif case.endswith("int8"):
        base = _baseline(lambda: _port(models, kv_quant="int8"), _prompts())
    else:
        base = clean
    assert got[0] == base, "the fleet diverged from the single engine"
    assert got[0] == want[0], "the fleet's tokens are not the JAX fleet's"
    assert got[1] == want[1], "rid -> replica differs from the JAX router"
    if case.startswith("chaos") or case == "corrupt":
        # the re-prefill rung: decode steps a rebuilt token (docstring)
        assert _less_steps(got[2]) == _less_steps(want[2])
        assert got[2]["ticks"] >= want[2]["ticks"]
        assert all(g["steps"] >= w["steps"] for g, w in
                   zip(got[2]["replicas"], want[2]["replicas"]))
    else:
        assert got[2] == want[2], "fleet_metrics differ from the JAX router's"
    assert got[3] == want[3] and got[4] == want[4]
    if case.startswith("chaos"):
        assert got[2]["deaths"] == 1 and got[2]["quarantined"] == 0
        assert got[2]["migrated_requests"] >= 1
    if case == "corrupt":
        assert got[2]["migrate_corruptions"] == 1


# --------------------------------------------------------------------------
# Routing: read-only prefix probe, load spread, admission fallback
# --------------------------------------------------------------------------

def test_probe_prefix_is_read_only(models):
    """Routing probes must not perturb the replica they score: no refs
    taken, no LRU reordering, no hit/lookup counter movement — the same
    walk via match_prefix (which DOES take refs) agrees on the depth."""
    srv = _port(models)
    p = _prompts()[0]
    srv.submit(p, max_new_tokens=6)
    srv.run()
    stats = srv.alloc.stats()
    refs = srv.alloc.ref_counts()
    hits = srv.alloc.probe_prefix(p)
    assert hits == len(p) // srv.block_size >= 2
    assert srv.probe_prefix(p) == hits
    assert srv.alloc.probe_prefix([1, 2, 3]) == 0
    assert srv.alloc.stats() == stats, "probe moved allocator counters"
    assert srv.alloc.ref_counts() == refs, "probe took references"
    got = srv.alloc.match_prefix(p)
    assert len(got) == hits, "probe disagrees with the real prefix match"
    for bid in got:
        srv.alloc.free(bid)
    srv.assert_conserved()


def test_router_validates_replicas(models):
    dense = GenerationServer(models[1], device="cpu", max_batch=2,
                             max_len=96, prompt_buckets=(32,))
    with pytest.raises(ValueError, match="paged"):
        FleetRouter([dense])
    with pytest.raises(ValueError, match="homogeneous"):
        FleetRouter([_port(models), _port(models, block_size=4)])
    used = _port(models)
    used.submit(_prompts()[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="fresh"):
        FleetRouter([_port(models), used])
    used.run()
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter([])


def test_routing_spreads_by_load_and_rids_are_disjoint(models):
    """Idle-fleet submissions alternate replicas by load score, and the
    rid itself names the home replica (disjoint rid spaces, past 2**32:
    host ints end to end)."""
    fleet = FleetRouter([_port(models) for _ in range(3)])
    rng = np.random.RandomState(3)
    rids = [fleet.submit(rng.randint(1, 128, (10,)).tolist(),
                         max_new_tokens=4) for _ in range(6)]
    assert [r // RID_STRIDE for r in rids] == [0, 1, 2, 0, 1, 2]
    assert rids[2] == 2 * RID_STRIDE > np.iinfo(np.int32).max
    out = fleet.run()
    assert all(r in out for r in rids)
    assert all(type(r) is int for r in out)
    fleet.assert_conserved()


def test_routing_prefers_cached_prefix(models):
    """A submission sharing a cached block with replica 1 overrides the
    idle tie (which would pick replica 0)."""
    fleet = FleetRouter([_port(models) for _ in range(2)])
    prompts = _prompts()
    r0 = fleet.submit(prompts[0], max_new_tokens=4)
    r1 = fleet.submit(prompts[1], max_new_tokens=4)
    assert (r0 // RID_STRIDE, r1 // RID_STRIDE) == (0, 1)
    fleet.run()
    warm = prompts[1][:8] + _prompts(lens=(10,))[0]
    rid = fleet.submit(warm, max_new_tokens=4)
    assert rid // RID_STRIDE == 1, "router ignored the cached prefix"
    assert fleet.run()[rid][:len(warm)] == warm


def test_admission_backpressure_falls_through_to_peer(models):
    """AdmissionError on the preferred replica falls through to the
    next-best; only when EVERY eligible replica refuses does submit
    re-raise the backpressure signal."""
    fleet = FleetRouter(
        [_port(models, policy=Scheduler("fifo", max_queue=1))
         for _ in range(2)])
    prompts = _prompts()
    a = fleet.submit(prompts[0], max_new_tokens=4)
    b = fleet.submit(prompts[1], max_new_tokens=4)   # falls through to 1
    assert (a // RID_STRIDE, b // RID_STRIDE) == (0, 1)
    with pytest.raises(AdmissionError):
        fleet.submit(prompts[2], max_new_tokens=4)
    out = fleet.run()
    assert a in out and b in out
    fleet.assert_conserved()


# --------------------------------------------------------------------------
# Health: heartbeat state machine against an injectable clock
# --------------------------------------------------------------------------

def test_heartbeat_wedge_degrades_then_kills_and_fails_over(models, clean):
    """A replica holding work without advancing its step counter walks
    live → degraded → dead on the router's stall thresholds, and its
    requests fail over to the peer token-identically."""
    t = [0.0]
    fleet = FleetRouter([_port(models) for _ in range(2)],
                        clock=lambda: t[0], probe_every=0,
                        stall_ticks_degraded=2, stall_ticks_dead=4)
    prompts = _prompts()[:2]
    rids = [fleet.submit(p, max_new_tokens=12) for p in prompts]
    assert [r // RID_STRIDE for r in rids] == [0, 1]
    rep0 = fleet._replicas[0]
    rep0.server.step = lambda: 1          # wedge: holds work, no progress
    for _ in range(2):
        t[0] += 1.0
        fleet.step()
    assert rep0.state == REPLICA_DEGRADED
    for _ in range(2):
        t[0] += 1.0
        fleet.step()
    assert rep0.state == REPLICA_DEAD
    fm = fleet.fleet_metrics()
    assert fm["heartbeat_stalls"] == 4 and fm["deaths"] == 1
    assert fm["degraded_events"] == 1 and fm["quarantined"] == 0
    assert [s for _, s in rep0.history] == [
        REPLICA_LIVE, REPLICA_DEGRADED, REPLICA_DEAD]
    assert [when for when, _ in rep0.history] == [0.0, 2.0, 4.0]
    with pytest.raises(EngineFailedError):
        rep0.server.submit(prompts[0], max_new_tokens=1)
    out = fleet.run()
    assert [out[r] for r in rids] == clean[:2]
    fleet.assert_conserved()


def test_heartbeat_recovery_after_cooldown(models):
    """A transient stall degrades the replica; once it progresses again
    and the cooldown elapses it returns to live — no kill, no drops."""
    t = [0.0]
    fleet = FleetRouter([_port(models) for _ in range(2)],
                        clock=lambda: t[0], probe_every=0,
                        stall_ticks_degraded=2, stall_ticks_dead=100,
                        degrade_cooldown_s=5.0)
    rid = fleet.submit(_prompts()[0], max_new_tokens=8)
    rep0 = fleet._replicas[0]
    rep0.server.step = lambda: 1
    for _ in range(3):
        t[0] += 1.0
        fleet.step()
    assert rep0.state == REPLICA_DEGRADED
    del rep0.server.step                  # un-wedge: class method returns
    t[0] += 1.0
    fleet.step()
    assert rep0.state == REPLICA_DEGRADED, "recovered before cooldown"
    t[0] += 10.0
    fleet.step()
    assert rep0.state == REPLICA_LIVE
    assert rid in fleet.run()
    fleet.assert_conserved()


class _LaggyHandle:
    """Transport-latency model: ``steps`` observations refresh only on
    every k-th read (the RPC round trip), and ``progress_seq`` advances
    only when a fresh observation crossed the boundary."""

    def __init__(self, server, every=3):
        self._srv = server
        self._every = every
        self._reads = 0
        self._seq = 0
        self._steps = 0

    @property
    def steps(self):
        self._reads += 1
        if self._reads % self._every == 1:
            self._steps = self._srv.steps
            self._seq += 1
        return self._steps

    @property
    def progress_seq(self):
        return self._seq

    def __getattr__(self, name):
        return getattr(self._srv, name)


class _WedgedRemote:
    """Fresh observations (seq advances every read) of a replica that
    never progresses: freshness must not shield it."""

    def __init__(self, server):
        self._srv = server
        self._n = 0

    @property
    def steps(self):
        return 0

    @property
    def progress_seq(self):
        self._n += 1
        return self._n

    def step(self):
        return 1                       # claims work, does nothing

    def __getattr__(self, name):
        return getattr(self._srv, name)


@pytest.mark.parametrize("remote", ["laggy", "wedged"])
def test_heartbeat_reads_transport_freshness(models, clean, remote):
    """A healthy remote replica observed through a laggy transport accrues
    no stall (staleness is not a stall); a remote whose observations are
    fresh but which never progresses is degraded, killed and failed over
    token-exactly."""
    t = [0.0]
    head = (_LaggyHandle(_port(models), every=4) if remote == "laggy"
            else _WedgedRemote(_port(models)))
    fleet = FleetRouter([head, _port(models)], clock=lambda: t[0],
                        probe_every=0, stall_ticks_degraded=2,
                        stall_ticks_dead=4)
    n = 4 if remote == "laggy" else 2
    rids = [fleet.submit(p, max_new_tokens=12) for p in _prompts()[:n]]
    while True:
        t[0] += 1.0
        if fleet.step() == 0:
            break
    fm = fleet.fleet_metrics()
    if remote == "laggy":
        assert fm["heartbeat_stalls"] == 0, \
            "transport staleness was charged as a stall"
        assert fm["deaths"] == 0 and fm["degraded_events"] == 0
        assert fleet.replica_states() == [REPLICA_LIVE, REPLICA_LIVE]
    else:
        assert fm["heartbeat_stalls"] == 4 and fm["deaths"] == 1
        assert fleet.replica_states() == [REPLICA_DEAD, REPLICA_LIVE]
    out = fleet.run()
    assert [out[r] for r in rids] == clean[:n]
    fleet.assert_conserved()


# --------------------------------------------------------------------------
# Live migration: drain, corruption, quarantine, chaos
# --------------------------------------------------------------------------

def test_drain_migration_swaps_in_without_a_capture(models):
    """Migration admits through the swap-in path: a second drain and the
    fleet's drain to empty capture no program (the executor's CUDA graph
    count; on the card phase 37 (a) holds the same), each peer swapped a
    payload in, and the tokens are the single engine's."""
    prompts = _prompts(lens=(18, 11, 7, 9, 13, 15))
    base = _baseline(lambda: _port(models, max_batch=3), prompts,
                     max_new=24)
    fleet = FleetRouter([InProcessReplica(_port(models, max_batch=3))
                         for _ in range(3)])
    rids = [fleet.submit(p, max_new_tokens=24) for p in prompts]
    assert [r // RID_STRIDE for r in rids] == [0, 1, 2, 0, 1, 2]
    for _ in range(4):
        fleet.step()
    assert fleet.drain(0) >= 2            # one KV payload to each peer
    for _ in range(8):
        fleet.step()
    peers = [fleet._replicas[i].server for i in (1, 2)]
    assert all(s.sched_metrics()["resumes"] >= 1 for s in peers)
    captures = [s._exec.captures for s in peers]
    fleet.drain(1)
    out = fleet.run()
    assert [s._exec.captures for s in peers] == captures
    assert [out[r] for r in rids] == base
    audits = fleet.assert_conserved()
    assert audits[0]["blocks_in_use"] == 0, "drained replica kept blocks"


def test_migrate_payload_corruption_degrades_to_reprefill(models, clean):
    """A payload bit-flipped in transit is caught by the receiver's CRC
    check and degrades to token-exact re-prefill, counted on both
    sides."""
    inj = FaultInjector(FaultPlan([FaultSpec("migrate_payload", at=0)],
                                  seed=17))
    fleet = FleetRouter([_port(models) for _ in range(2)], faults=inj)
    rids = [fleet.submit(p, max_new_tokens=12) for p in _prompts()[:3]]
    for _ in range(4):
        fleet.step()
    assert fleet.drain(0) >= 1
    assert fleet.fleet_metrics()["migrate_corruptions"] == 1
    out = fleet.run()
    assert [out[r] for r in rids] == clean[:3]
    s1 = fleet._replicas[1].server
    assert s1.telemetry.registry.counter(
        "serving_swap_reprefills", "").total() >= 1, \
        "receiver never exercised the re-prefill rung"
    fleet.assert_conserved()


def test_no_survivor_quarantines_not_drops(models):
    """Killing the last replica leaves its in-flight requests
    quarantined ('failed'), never silently vanished; finished work
    stays answerable from the router's ledgers."""
    prompts = _prompts(lens=(18, 11))
    fleet = FleetRouter([_port(models)])
    done = fleet.submit(prompts[0], max_new_tokens=2)
    while fleet.status(done) != "done":
        fleet.step()
    doomed = fleet.submit(prompts[1], max_new_tokens=8)
    fleet.step()
    fleet.kill(0)
    assert fleet.status(done) == "done"
    assert fleet.status(doomed) == "failed"
    assert fleet.fleet_metrics()["quarantined"] == 1
    with pytest.raises(EngineFailedError):
        fleet.submit(prompts[0], max_new_tokens=1)
    with pytest.raises(ValueError, match="already dead"):
        fleet.kill(0)
    assert fleet.step() == 0
    fleet.assert_conserved()


def test_add_replica_joins_mid_flight_with_the_next_rid_space(models, clean):
    """The autoscaler's scale-up primitive: a fresh homogeneous replica
    joins mid-run with the next rid space and serves; a heterogeneous one
    is refused."""
    fleet = FleetRouter([_port(models)])
    rids = [fleet.submit(p, max_new_tokens=12) for p in _prompts()[:2]]
    fleet.step()
    assert fleet.add_replica(_port(models)) == 1
    with pytest.raises(ValueError, match="homogeneous"):
        fleet.add_replica(_port(models, block_size=4))
    rids += [fleet.submit(p, max_new_tokens=12) for p in _prompts()[2:]]
    assert rids[2] // RID_STRIDE == 1
    assert fleet.live_indices() == [0, 1]
    out = fleet.run()
    assert [out[r] for r in rids] == clean


def test_fleet_chaos_plan_is_deterministic():
    pa, pb = FaultPlan.fleet_chaos(5), FaultPlan.fleet_chaos(5)
    assert pa.specs == pb.specs
    assert FaultPlan.fleet_chaos(6).specs != pa.specs
    assert {s.site for s in pa.specs} == {"replica_down", "migrate_payload",
                                          "route"}
    jp = JPlan.fleet_chaos(5)
    assert [(s.site, s.at, s.count) for s in pa.specs] == \
        [(s.site, s.at, s.count) for s in jp.specs]


def test_fleet_metrics_rows_and_registry_sync(models):
    """fleet_metrics() is the benchmark table contract: one well-formed
    row per replica and the fleet_* gauges synced into the registry."""
    fleet = FleetRouter([_port(models) for _ in range(2)])
    rids = [fleet.submit(p, max_new_tokens=6) for p in _prompts()[:2]]
    for _ in range(3):
        fleet.step()
    fleet.drain(0)
    fleet.run()
    fm = fleet.fleet_metrics()
    assert len(fm["replicas"]) == 2
    for row in fm["replicas"]:
        for key in ("replica", "state", "steps", "queue_depth",
                    "slots_occupied", "blocks_headroom", "prefix_hit_rate",
                    "routed", "stall_ticks", "transitions"):
            assert key in row
    assert fm["states"][REPLICA_DEAD] == 1
    assert fm["routed"] == len(rids)
    assert fm["migration_latency_samples"] >= 1
    reg = fleet.registry
    assert reg.gauge("fleet_replicas_dead", "").value() == 1.0
    assert reg.gauge("fleet_replica_up", "").value(replica="0") == 0.0
    assert reg.gauge("fleet_replica_up", "").value(replica="1") == 1.0
    assert reg.counter("fleet_drains", "").total() == 1


def test_slo_rollup_per_tenant_burn_rate_and_gauges(models):
    """Per-tenant SLO roll-up across replica registries: objectives come
    from the slos= map (with "default" re-basing), attainment/burn-rate
    reflect the rolling TTFT/TPOT windows, and the rows land both in
    fleet_metrics()["slo"] and as router-registry Prometheus gauges."""
    fleet = FleetRouter(
        [_port(models, telemetry=True) for _ in range(2)],
        slos={"default": {"ttft_s": 1e9},          # everything attains
              "batch": {"ttft_s": 1e-12, "target": 0.9}})  # nothing does
    rng = np.random.RandomState(3)
    for i in range(4):
        fleet.submit(rng.randint(1, 128, (9 + i,)).tolist(),
                     max_new_tokens=6, tenant="batch" if i % 2 else "gold")
    fleet.run()
    slo = fleet.fleet_metrics()["slo"]
    assert sorted(slo) == ["batch", "gold"]
    assert slo["gold"]["ttft"]["objective"] == 1e9
    assert slo["gold"]["ttft"]["attainment"] == 1.0
    assert slo["gold"]["ttft"]["burn_rate"] == 0.0
    assert slo["gold"]["target"] == 0.95
    assert slo["batch"]["ttft"]["attainment"] == 0.0
    assert slo["batch"]["ttft"]["burn_rate"] == pytest.approx(10.0)
    assert slo["batch"]["target"] == 0.9
    assert sum(slo[t]["ttft"]["samples"] for t in slo) == 4
    prom = fleet.registry.to_prometheus()
    assert 'fleet_slo_ttft_burn_rate{tenant="batch"} 10.0' in prom
    assert 'fleet_slo_ttft_attainment{tenant="gold"} 1.0' in prom
    assert 'fleet_slo_ttft_objective{tenant="batch"} 1e-12' in prom
