"""The fleet's control plane on the PyTorch port against the JAX package:
the seeded workloads (``autotune/workload.py``), the elastic autoscaler
(``inference/autoscale.py``) and the fleet simulator (``fleetsim/``), the
cases of ``tests/test_autoscale.py`` and ``tests/test_fleetsim.py`` —
then a real slice of a drawn day through the port's router against the
JAX router on the same weights, with the autoscaler scripted through a
scale-up and a drain.

Tolerances: exact. Draws equal array for array (both packages use
numpy's ``RandomState`` and ``hashlib``), decision journals and
simulation reports byte for byte as JSON, tokens and rids of the replayed
slice exactly."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import fleetsim as jsim
from paddle_tpu.autotune import workload as jworkload
from paddle_tpu.inference import autoscale as jscale
from paddle_tpu.inference.fleet import FleetRouter as JFleet
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.inference.transport import CountingClock as JCountingClock
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import autotune
from paddle_tpu_torch import fleetsim as psim
from paddle_tpu_torch.autotune import workload
from paddle_tpu_torch.fleetsim import (DayTrafficSpec, ReplicaServiceModel,
                                       VirtualClock, draw_day,
                                       expected_session_rate,
                                       materialize_session)
from paddle_tpu_torch.inference import FleetRouter
from paddle_tpu_torch.inference import autoscale as pscale
from paddle_tpu_torch.inference.autoscale import (AutoscalePolicy,
                                                  ElasticAutoscaler,
                                                  verify_replay)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.transport import CountingClock
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_tensor_parity import jax_jit_at_o0

CAP = 1000.0  # tokens/s per replica
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
SERVE = dict(max_batch=2, max_len=96, cache="paged", block_size=8,
             prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# Workloads
# --------------------------------------------------------------------------

WORKLOADS = [dict(), dict(requests=24, repeat_suffix=True, seed=3),
             dict(requests=20, mixed_priority=True, lora_adapters=3,
                  arrival_rate=50.0, burst=3, seed=5),
             dict(requests=12, shared_prefix_frac=0.5, long_context=True,
                  seed=9)]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_workload_draws_equal_the_jax_draws(kw):
    spec, jspec = workload.WorkloadSpec(**kw), jworkload.WorkloadSpec(**kw)
    assert spec.to_dict() == jspec.to_dict()
    t, jt = workload.draw_traffic(spec), jworkload.draw_traffic(jspec)
    assert [tuple(vars(r).values()) for r in t.requests] == \
        [tuple(vars(r).values()) for r in jt.requests]
    assert t.schedule == jt.schedule and t.motif == jt.motif
    assert t.signature() == jt.signature()
    w = workload.warmup_traffic(spec, 5)
    jw = jworkload.warmup_traffic(jspec, 5)
    assert [r.prompt for r in w] == [r.prompt for r in jw]
    assert workload.draw_traffic(spec.truncated(3)).requests == \
        t.requests[:3]
    assert workload.WorkloadSpec.from_dict(spec.to_dict()) == spec


def test_workload_validation_and_the_unported_autotuner():
    for bad in (dict(requests=0), dict(max_new=0), dict(burst=0),
                dict(vocab_size=1), dict(prompt_ladder=()),
                dict(shared_prefix_frac=1.5)):
        with pytest.raises(ValueError):
            workload.WorkloadSpec(**bad)
    assert autotune.WorkloadSpec is workload.WorkloadSpec
    # the autotuner is ported: every name of the JAX package's resolves
    import paddle_tpu.autotune as jautotune

    for name in jautotune.__all__:
        assert getattr(autotune, name) is not None, name
    for name in ("cost", "features", "kernel_geometry", "profile",
                 "search", "space"):
        assert getattr(autotune, name).__name__.endswith(name)
    with pytest.raises(AttributeError):
        autotune.no_such_name
    # only the axes that wait for ROADMAP A9c raise
    kg = autotune.kernel_geometry
    for op, geom in (("flash_attention",
                      autotune.FlashAttentionGeometry(block_q=128)),
                     ("flash_attention",
                      autotune.FlashAttentionGeometry(block_kv=256)),
                     ("fused_lora", autotune.LoRAGeometry(
                         accum="delta_first")),
                     ("paged_attention", autotune.PagedAttentionGeometry(
                         q_rows=8)),
                     ("paged_attention", autotune.PagedAttentionGeometry(
                         dequant="early"))):
        with pytest.raises(NotImplementedError, match="A9c"):
            kg.check_served(op, geom)
    for op in autotune.OP_FAMILIES:
        kg.check_served(op, autotune.default_geometry(op), rank=8,
                        hopper=True)
    kg.check_served("paged_attention", autotune.PagedAttentionGeometry(
        kv_block_depth=2, grid_order="gbm"), quantized=True, hopper=True)


def test_submit_traffic_submits_in_order():
    class _Rec:
        def __init__(self):
            self.calls = []

        def submit(self, prompt, **kw):
            self.calls.append((prompt, kw))
            return len(self.calls) - 1

    spec = workload.WorkloadSpec(requests=4, lora_adapters=2, seed=1)
    reqs = workload.draw_traffic(spec).requests
    rec = _Rec()
    out = workload.submit_traffic(rec, reqs)
    assert list(out) == [0, 1, 2, 3]
    assert [c[1]["adapter"] for c in rec.calls] == ["a0", "a1", "a0", "a1"]


# --------------------------------------------------------------------------
# The autoscaler's decision engine
# --------------------------------------------------------------------------

def _engine(jax=False, **kw):
    kw.setdefault("max_replicas", 8)
    kw.setdefault("target_utilization", 0.8)
    kw.setdefault("up_cooldown_s", 0.0)
    kw.setdefault("down_cooldown_s", 0.0)
    mod = jscale if jax else pscale
    return mod.ElasticAutoscaler(CAP, policy=mod.AutoscalePolicy(**kw))


@pytest.mark.parametrize("rows,kw", [
    # sizing, burn override, forecast lead, max step, cooldowns, ceiling,
    # last replica, burn gate, one-at-a-time downs
    ([(0.0, 1, 500.0, 3000.0, 0.0), (1.0, 4, 6000.0, 0.0, 0.0),
      (2.0, 8, 1e6, 0.0, 0.0), (3.0, 2, 100.0, 0.0, 1.5),
      (4.0, 3, 100.0, 0.0, 0.5), (5.0, 3, 100.0, 0.0, 0.0),
      (6.0, 1, 0.0, 0.0, 0.0)], dict(burn_down=0.25)),
    ([(0.0, 1, 3000.0, 0.0, 0.0), (10.0, 2, 6000.0, 0.0, 0.0),
      (70.0, 2, 6000.0, 0.0, 0.0), (71.0, 4, 100.0, 0.0, 0.0),
      (131.0, 3, 100.0, 0.0, 0.0), (800.0, 3, 100.0, 0.0, 0.0)],
     dict(up_cooldown_s=60.0, down_cooldown_s=600.0)),
    ([(0.0, 2, 1e6, 0.0, 0.0), (1.0, 2, 0.0, 0.0, 0.0),
      (2.0, 2, 0.0, 0.0, 0.0)], dict(min_replicas=2, max_replicas=2)),
])
def test_decisions_equal_the_jax_engine_as_json(rows, kw):
    """Every observation row gives the JAX engine's decision: the
    journals are equal byte for byte as JSON, and so are the registries'
    counters and gauges."""
    eng, jeng = _engine(**kw), _engine(jax=True, **kw)
    for t, live, demand, forecast, burn in rows:
        d = eng.decide(t, live=live, demand_tok_s=demand,
                       forecast_tok_s=forecast, burn_rate=burn)
        jd = jeng.decide(t, live=live, demand_tok_s=demand,
                         forecast_tok_s=forecast, burn_rate=burn)
        assert d.as_dict() == jd.as_dict()
    assert json.dumps([d.as_dict() for d in eng.events]) == \
        json.dumps([d.as_dict() for d in jeng.events])
    assert eng.registry.to_prometheus() == jeng.registry.to_prometheus()


class TestSizingAndDecisions:
    def test_desired_replicas(self):
        eng = _engine()
        assert eng.desired_replicas(2000.0) == 3
        assert eng.desired_replicas(100.0, forecast_tok_s=4000.0) == 5
        eng = _engine(min_replicas=2, max_replicas=4)
        assert eng.desired_replicas(0.0) == 2
        assert eng.desired_replicas(1e9) == 4

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=0)
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=4, max_replicas=2)
        with pytest.raises(ValueError):
            AutoscalePolicy(target_utilization=1.5)
        with pytest.raises(ValueError):
            ElasticAutoscaler(0.0)

    @pytest.mark.parametrize("kw,obs,want", [
        (dict(burn_up=1.0), dict(live=2, demand_tok_s=100.0, burn_rate=1.5),
         ("up", 1, "burn_rate")),
        (dict(burn_up=1.0), dict(live=2, demand_tok_s=100.0, burn_rate=0.5),
         ("hold", 0, "burn_gate")),
        (dict(), dict(live=1, demand_tok_s=500.0, forecast_tok_s=3000.0),
         ("up", 2, "forecast")),
        (dict(max_step_up=2), dict(live=1, demand_tok_s=6000.0),
         ("up", 2, "demand")),
        (dict(), dict(live=1, demand_tok_s=0.0), ("hold", 0, "last_replica")),
        (dict(burn_down=0.25), dict(live=3, demand_tok_s=100.0,
                                    burn_rate=0.5), ("hold", 0, "burn_gate")),
        (dict(burn_down=0.25), dict(live=3, demand_tok_s=100.0),
         ("down", 1, "demand")),
        (dict(max_replicas=2), dict(live=2, demand_tok_s=1e6),
         ("hold", 0, "ceiling"))])
    def test_one_decision(self, kw, obs, want):
        d = _engine(**kw).decide(0.0, **obs)
        assert (d.action, d.count, d.reason) == want

    def test_cooldowns(self):
        eng = _engine(up_cooldown_s=60.0)
        assert eng.decide(0.0, live=1, demand_tok_s=3000.0).action == "up"
        d = eng.decide(10.0, live=2, demand_tok_s=6000.0)
        assert d.action == "hold" and d.reason == "up_cooldown"
        assert eng.decide(70.0, live=2, demand_tok_s=6000.0).action == "up"
        eng = _engine(down_cooldown_s=600.0)
        assert eng.decide(0.0, live=4, demand_tok_s=100.0).action == "down"
        d = eng.decide(60.0, live=3, demand_tok_s=100.0)
        assert d.action == "hold" and d.reason == "down_cooldown"


class TestDeterminism:
    ROWS = [(1, 3000.0, 0.0, 0.0), (2, 3000.0, 0.0, 0.0),
            (3, 6000.0, 0.0, 1.4), (4, 100.0, 0.0, 0.5),
            (5, 100.0, 0.0, 0.0), (6, 100.0, 0.0, 0.0)]
    POLICY = dict(max_replicas=8, target_utilization=0.8,
                  up_cooldown_s=2.0, down_cooldown_s=5.0)

    def _drive(self, clock, jax=False):
        eng = _engine(jax=jax, up_cooldown_s=2.0, down_cooldown_s=5.0)
        live = 1
        for _, demand, forecast, burn in self.ROWS:
            d = eng.decide(clock(), live=live, demand_tok_s=demand,
                           forecast_tok_s=forecast, burn_rate=burn)
            live += d.count if d.action == "up" else \
                (-d.count if d.action == "down" else 0)
        return [d.as_dict() for d in eng.events]

    def test_identical_decisions_under_counting_clock(self):
        a = self._drive(CountingClock(dt=1.0))
        b = self._drive(CountingClock(dt=1.0))
        j = self._drive(JCountingClock(dt=1.0), jax=True)
        assert a == b and json.dumps(a) == json.dumps(j)
        assert any(d["action"] == "up" for d in a)

    def test_verify_replay_accepts_own_and_rejects_tampered(self):
        events = self._drive(CountingClock(dt=1.0))
        pol = AutoscalePolicy(**self.POLICY)
        assert verify_replay(events, CAP, policy=pol)
        events[0]["action"] = "down"
        with pytest.raises(AssertionError, match="diverged at event 0"):
            verify_replay(events, CAP, policy=pol)


def test_decisions_land_in_the_registry():
    eng = _engine(max_replicas=2)
    eng.decide(0.0, live=1, demand_tok_s=3000.0)      # up
    eng.decide(1.0, live=2, demand_tok_s=1e6)          # ceiling
    eng.decide(2.0, live=1, demand_tok_s=0.0)          # last_replica
    dec = eng.registry.get("fleet_autoscale_decisions")
    blocked = eng.registry.get("fleet_autoscale_blocked")
    assert dec.value(action="up") == 1 and dec.value(action="hold") == 2
    assert blocked.value(reason="ceiling") == 1
    assert blocked.value(reason="last_replica") == 1
    eng = _engine()
    eng.decide(5.0, live=3, demand_tok_s=1234.0, forecast_tok_s=2500.0,
               burn_rate=0.125)
    reg = eng.registry
    assert reg.get("fleet_autoscale_live_replicas").value() == 3.0
    assert reg.get("fleet_autoscale_demand_tok_s").value() == 1234.0
    assert reg.get("fleet_autoscale_forecast_tok_s").value() == 2500.0
    assert reg.get("fleet_autoscale_burn_rate").value() == 0.125


# --------------------------------------------------------------------------
# Virtual time and the drawn day
# --------------------------------------------------------------------------

def test_virtual_clock():
    clk = VirtualClock(5.0)
    assert clk() == clk() == 5.0 and clk.now == 5.0
    clk.advance(2.5)
    clk.advance_to(10.0)
    assert clk() == 10.0
    with pytest.raises(ValueError):
        clk.advance_to(1.0)
    with pytest.raises(ValueError):
        clk.advance(-0.5)


DAYS = [dict(sessions=50_000, seed=11),
        dict(sessions=20_000, seed=3, diurnal_amplitude=0.6, peak_frac=0.5,
             longtail_frac=0.2),
        dict(sessions=5_000, seed=2, shared_prefix_tokens=16, tenants=3,
             populations=7)]


@pytest.mark.parametrize("kw", DAYS)
def test_day_draws_equal_the_jax_draws(kw):
    """The drawn day array for array, its signature, the analytic rate and
    a spread of materialized sessions (clipped and not) equal the JAX
    package's."""
    spec, jspec = DayTrafficSpec(**kw), jsim.DayTrafficSpec(**kw)
    assert spec.to_dict() == jspec.to_dict()
    t, jt = draw_day(spec), jsim.draw_day(jspec)
    for f in ("t", "tenant", "population", "prompt_len", "max_new"):
        a, b = getattr(t, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert t.signature() == jt.signature()
    assert t.mean_tokens == jt.mean_tokens and len(t) == len(jt)
    for x in (0.0, 1234.5, spec.day_s * 0.58):
        assert expected_session_rate(spec, x) == \
            jsim.expected_session_rate(jspec, x)
    for i in (0, 17, len(t) // 2, len(t) - 1):
        for max_len in (None, 48):
            a = materialize_session(t, i, max_len=max_len)
            b = jsim.materialize_session(jt, i, max_len=max_len)
            assert (a.prompt, a.max_new, a.tenant) == \
                (b.prompt, b.max_new, b.tenant)


def test_day_shape_and_validation():
    spec = DayTrafficSpec(sessions=200_000, seed=3, diurnal_amplitude=0.6,
                          peak_frac=0.5)
    t = draw_day(spec).t
    assert np.all(np.diff(t) >= 0) and 0.0 <= t[0] and t[-1] <= spec.day_s
    peak = np.sum((t > 0.45 * spec.day_s) & (t < 0.55 * spec.day_s))
    trough = np.sum((t < 0.05 * spec.day_s) | (t > 0.95 * spec.day_s))
    assert peak > 2.0 * trough
    for bad in (dict(sessions=0), dict(diurnal_amplitude=1.0),
                dict(longtail_frac=1.5), dict(tenants=0), dict(day_s=0)):
        with pytest.raises(ValueError):
            DayTrafficSpec(**bad)


# --------------------------------------------------------------------------
# The simulated day
# --------------------------------------------------------------------------

def _sim(pkg, seed=7, sessions=30_000, cap=400.0, scaler=True):
    mod, smod = (jsim, jscale) if pkg == "jax" else (psim, pscale)
    spec = mod.DayTrafficSpec(sessions=sessions, seed=seed)
    policy = smod.AutoscalePolicy(max_replicas=12, up_cooldown_s=120.0,
                                  down_cooldown_s=1200.0)
    engine = smod.ElasticAutoscaler(cap, policy=policy) if scaler else None
    model = mod.ReplicaServiceModel(decode_tok_s=cap, prefill_tok_s=8 * cap,
                                    slots=16, spawn_delay_s=30.0)
    sim = mod.FleetSimulation(mod.draw_day(spec), model, autoscaler=engine,
                              initial_replicas=2)
    return sim, policy


@pytest.mark.parametrize("seed,sessions,cap,scaler", [
    (7, 30_000, 400.0, True), (11, 20_000, 150.0, True),
    (1, 10_000, 400.0, False)])
def test_simulation_report_equals_the_jax_report(seed, sessions, cap,
                                                 scaler):
    """The day through the analytic fleet under the autoscaler (and
    without one): the port's report equals the JAX package's byte for
    byte as JSON, and every session completes."""
    rep = _sim("port", seed, sessions, cap, scaler)[0].run()
    jrep = _sim("jax", seed, sessions, cap, scaler)[0].run()
    assert json.dumps(rep, sort_keys=True) == json.dumps(jrep, sort_keys=True)
    assert rep["completed"] == rep["sim_sessions"] == sessions
    assert rep["sim_virtual_hours"] == 24.0
    if not scaler:
        assert rep["autoscale_event_count"] == 0
        assert rep["replicas_spawned"] == 2


def test_autoscaler_rides_the_diurnal_curve_and_beats_static():
    """The fleet grows into the peak and shrinks after, with fewer
    replica-hours than a fleet sized for the peak and every tenant at its
    SLO target; the journal replays."""
    sim, policy = _sim("port", sessions=120_000, cap=100.0)
    rep = sim.run()
    assert rep["scale_ups"] >= 1 and rep["scale_downs"] >= 1
    assert rep["peak_replicas"] > 2
    assert verify_replay(rep["autoscale_events"], 100.0, policy=policy)
    assert rep["slo_attained"] and rep["elastic_beats_static"]
    assert rep["replica_hours"] < rep["static_replica_hours"]
    for row in rep["slo"].values():
        assert 0.0 <= row["ttft"]["attainment"] <= 1.0 and row["sessions"]


def test_service_model_from_a_cost_model():
    class _Cost:
        max_batch = 12

        def capacity_tok_s(self, config, workload):
            return 250.0

    m = ReplicaServiceModel.from_cost_model(_Cost(), None, None)
    j = jsim.ReplicaServiceModel.from_cost_model(_Cost(), None, None)
    assert vars(m) == vars(j)
    assert (m.decode_tok_s, m.prefill_tok_s, m.slots) == (250.0, 2000.0, 12)
    with pytest.raises(ValueError):
        ReplicaServiceModel(decode_tok_s=0.0, prefill_tok_s=1.0, slots=1)


# --------------------------------------------------------------------------
# A real slice of the day through both routers
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


def _frozen():
    return 0.0


def _slice(models, pkg, scripted):
    """The first 8 sessions of a drawn day through a 2-replica router of
    package ``pkg`` on a virtual clock; with ``scripted``, a FleetAutoscaler
    forced through one scale-up (tick 3) and one drain (tick 7)."""
    jax = pkg == "jax"
    mod, smod = (jsim, jscale) if jax else (psim, pscale)

    # the servers' latency clock frozen: the SLO burn the autoscaler reads
    # must not depend on how fast this machine runs either package
    def server():
        return (JServer(models[0], clock=_frozen, **SERVE) if jax else
                GenerationServer(models[1], device="cpu", clock=_frozen,
                                 **SERVE))

    spec = mod.DayTrafficSpec(sessions=64, seed=3, shared_prefix_tokens=8,
                              prompt_ladder=(12, 16, 20), longtail_frac=0.0,
                              max_new_ladder=(4, 6, 8))
    clock = mod.VirtualClock()
    fleet = (JFleet if jax else FleetRouter)([server(), server()],
                                             clock=clock)
    engine = smod.ElasticAutoscaler(400.0, policy=smod.AutoscalePolicy(
        max_replicas=4, up_cooldown_s=0.0, down_cooldown_s=0.0))
    scaler = smod.FleetAutoscaler(fleet, engine, spawn=server)

    def on_tick(tick, now, submitted):
        if scripted and tick == 3:
            scaler.control(now, demand_tok_s=1e6)
        elif scripted and tick == 7:
            scaler.control(now, demand_tok_s=1.0)

    out = mod.replay_slice(mod.draw_day(spec), fleet, sessions=8,
                           clock=clock, compress=20000.0, tick_s=1.0,
                           max_len=96, on_tick=on_tick)
    fleet.assert_conserved()
    return out, [d.as_dict() for d in engine.events], scaler.applied, fleet


def test_replayed_slice_equals_the_jax_slice(models):
    """The same slice through the port's router and the JAX router, once
    undisturbed and once with the autoscaler adding a replica and draining
    one mid-run: the same rids, tokens, decisions and applied replicas;
    the scripted run's tokens equal the undisturbed run's session for
    session."""
    with jax_jit_at_o0():
        jplain = _slice(models, "jax", False)
        jscripted = _slice(models, "jax", True)
    plain = _slice(models, "port", False)
    scripted = _slice(models, "port", True)
    for got, want in ((plain, jplain), (scripted, jscripted)):
        assert got[0] == want[0]
        assert json.dumps(got[1]) == json.dumps(want[1])
        assert [(d.as_dict(), t) for d, t in got[2]] == \
            [(d.as_dict(), t) for d, t in want[2]]
    assert len(plain[0]["rids"]) == 8
    assert [d["action"] for d in scripted[1]] == ["up", "down"]
    assert all(d["burn_rate"] == 0.0 for d in scripted[1])
    assert len(scripted[3].replica_states()) == 4
    assert "dead" in scripted[3].replica_states()
    toks = [plain[0]["results"][r] for r in plain[0]["rids"]]
    stoks = [scripted[0]["results"][r] for r in scripted[0]["rids"]]
    assert toks == stoks and all(toks)
