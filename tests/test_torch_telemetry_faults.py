"""The host substrates of observability and recovery in the PyTorch port
(``paddle_tpu_torch/telemetry.py``, ``paddle_tpu_torch/faults.py``) against
the JAX package's, the cases of ``tests/test_telemetry.py``,
``tests/test_faults.py`` and ``tests/test_train_telemetry.py`` that need no
server one for one: each scenario drives the JAX object and the port's with
the same clock and calls, and the two must return the same results — equal
``to_json()``, Prometheus text, percentiles, spans, flight records,
watchdog findings (less their message text), ``chaos(seed)`` scripts and
flipped bits. Then the port's train engine with ``TrainTelemetry``
against the JAX engine's records."""
import json
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import faults as jfaults
from paddle_tpu import telemetry as jtel
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu_torch import faults as tfaults
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.inference import faults as tifaults
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference import telemetry as titel

JAX = SimpleNamespace(tel=jtel, faults=jfaults, sched=jsched)
PORT = SimpleNamespace(tel=ttel, faults=tfaults, sched=tsched)


class _FakeClock:
    """Deterministic injectable clock: each call returns the next value."""

    def __init__(self, step=1.0, start=0.0):
        self.t = start
        self.step = step

    def __call__(self):
        v = self.t
        self.t += self.step
        return v


def _plain(x):
    """A finding list or record without its message text (the port words
    a recompile as a CUDA graph capture)."""
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k != "detail"}
    return x


def _both(scenario):
    """Run ``scenario(m)`` with the JAX modules and the port's; they must
    return the same result. Returns the port's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert _plain(got) == _plain(want)
    return got


def test_shims_reexport_the_substrates():
    assert titel.MetricsRegistry is ttel.MetricsRegistry
    assert titel.ServingTelemetry is ttel.ServingTelemetry
    assert tifaults.FaultInjector is tfaults.FaultInjector
    assert tifaults.SITES == jfaults.SITES
    assert ttel.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS
    assert ttel.TRAIN_RID == jtel.TRAIN_RID


# --------------------------------------------------------------------------
# MetricsRegistry
# --------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy():
    rng = np.random.RandomState(3)
    xs = rng.exponential(0.05, 500)

    def run(m):
        reg = m.tel.MetricsRegistry()
        h = reg.histogram("lat_s", "latency")
        for x in xs:
            h.observe(float(x))
        return [reg.percentile("lat_s", q) for q in (50, 90, 95, 99)]
    got = _both(run)
    for g, q in zip(got, (50, 90, 95, 99)):
        assert g == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_labeled_percentiles_and_where_filter():
    a, b = [0.01, 0.02, 0.03], [0.5, 0.6]

    def run(m):
        reg = m.tel.MetricsRegistry()
        h = reg.histogram("ttft_s")
        for x in a:
            h.observe(x, tenant="a", priority=0)
        for x in b:
            h.observe(x, tenant="b", priority=1)
        return (reg.percentile("ttft_s", 50, where={"tenant": "a"}),
                reg.percentile("ttft_s", 50, where={"priority": 1}),
                reg.percentile("ttft_s", 50), h.count({"tenant": "b"}),
                h.label_values("tenant"))
    pa, pb, pall, nb, labels = _both(run)
    assert pa == pytest.approx(np.percentile(a, 50))
    assert pb == pytest.approx(np.percentile(b, 50))
    assert pall == pytest.approx(np.percentile(a + b, 50))
    assert nb == 2 and labels == ["a", "b"]


def test_clipped_series_falls_back_to_buckets():
    def run(m):
        h = m.tel.Histogram("h", buckets=(0.1, 0.2, 0.4), max_samples=4)
        for _ in range(50):
            h.observe(0.15)
        return h.percentile(50), h.count()
    p, n = _both(run)
    assert 0.1 <= p <= 0.2 and n == 50


def test_kind_mismatch_raises():
    def run(m):
        reg = m.tel.MetricsRegistry()
        reg.counter("n")
        for make in (reg.gauge, reg.histogram):
            with pytest.raises(TypeError):
                make("n")
        with pytest.raises(ValueError, match="sorted"):
            m.tel.Histogram("h", buckets=(1.0, 0.5))
        return True
    _both(run)


def test_counter_gauge_semantics():
    def run(m):
        reg = m.tel.MetricsRegistry()
        c = reg.counter("req", "requests")
        c.inc(tenant="a")
        c.inc(2, tenant="b")
        g = reg.gauge("depth")
        g.set(5)
        g.set(2)
        return (c.value(tenant="a"), c.total(), c.total(where={"tenant": "b"}),
                g.value(), c.series())
    assert _both(run)[:4] == (1, 3, 2, 2)


def test_timer_uses_injected_clock():
    def run(m):
        reg = m.tel.MetricsRegistry(clock=_FakeClock(step=0.25))
        with reg.timer("block_s", phase="x"):
            pass
        return reg.get("block_s").samples()
    assert _both(run) == [0.25]


def _exposition_registry(m):
    reg = m.tel.MetricsRegistry()
    reg.counter("req_total", "requests served").inc(3, tenant="a")
    h = reg.histogram("lat_s", "latency", buckets=(0.1, 1.0))
    for x in (0.05, 0.5, 5.0):
        h.observe(x)
    g = reg.histogram("ttft_s")
    for x in (0.1, 0.2, 0.3, 0.4):
        g.observe(x, tenant="a")
    reg.gauge("depth", "queue").set(7)
    return reg


def test_prometheus_text_is_the_jax_text():
    text = _both(lambda m: _exposition_registry(m).to_prometheus())
    assert "# HELP req_total requests served" in text
    assert 'req_total{tenant="a"} 3.0' in text
    assert 'lat_s_bucket{le="0.1"} 1' in text
    assert 'lat_s_bucket{le="1.0"} 2' in text
    assert 'lat_s_bucket{le="+Inf"} 3' in text
    assert "lat_s_count 3" in text and "lat_s_sum 5.55" in text


def test_to_json_is_the_jax_json():
    j = _both(lambda m: json.loads(json.dumps(
        _exposition_registry(m).to_json())))
    e = j["histograms"]["ttft_s"]
    assert e["count"] == 4
    assert e["p50"] == pytest.approx(np.percentile([0.1, 0.2, 0.3, 0.4], 50))
    assert e["series"][0]["labels"] == {"tenant": "a"}


def test_reset_histograms_keeps_counters():
    def run(m):
        reg = m.tel.MetricsRegistry()
        reg.counter("c").inc(7)
        reg.histogram("h").observe(1.0)
        reg.reset_histograms()
        out = [reg.counter("c").total(), reg.histogram("h").count()]
        reg.reset()
        return out + [reg.counter("c").total()]
    assert _both(run) == [7, 0, 0]


@pytest.mark.parametrize("case", ["empty", "boundary", "escape"])
def test_registry_edge_cases(case):
    def run(m):
        reg = m.tel.MetricsRegistry()
        if case == "empty":
            reg.histogram("lat_s")
            out = [reg.percentile("lat_s", 50),
                   reg.percentile("never_registered", 95)]
            reg.histogram("lat_s").observe(0.2, tenant="a")
            return out + [reg.percentile("lat_s", 50,
                                         where={"tenant": "ghost"})]
        if case == "boundary":
            h = reg.histogram("lat_s", buckets=(0.1, 1.0))
            for x in (0.1, 1.0, 0.1 + 1e-9):
                h.observe(x)
            return reg.to_prometheus()
        c = reg.counter("req_total")
        for t in ('evil"name', "back\\slash", "two\nlines"):
            c.inc(tenant=t)
        return reg.to_prometheus()
    out = _both(run)
    if case == "empty":
        assert out == [None, None, None]
    elif case == "boundary":
        assert 'lat_s_bucket{le="0.1"} 1' in out
        assert 'lat_s_bucket{le="1.0"} 3' in out
    else:
        assert 'req_total{tenant="evil\\"name"} 1.0' in out
        assert sum(1 for ln in out.splitlines()
                   if ln.startswith("req_total{")) == 3


# --------------------------------------------------------------------------
# SpanTracer
# --------------------------------------------------------------------------

def _tracer_script(m):
    tr = m.tel.SpanTracer(clock=_FakeClock(), max_spans=7)
    tr.begin(1, "queued")
    tr.end(1, "queued")
    tr.complete(2, "decode_window", 10.0, 12.5, ticks=4)
    tr.begin(3, "prefill")
    tr.begin(3, "preempted")
    tr.close(3, "cancelled")
    tr.begin(4, "queued")
    tr.begin(4, "queued")            # an implicit end of the first
    tr.set_meta(7, tenant="acme")
    tr.complete(7, "decode_window", 0.0, 1.0)
    tr.instant(7, "first_token")
    tr.complete(8, "dropped", 0.0, 1.0)
    tr.complete(8, "dropped_too", 0.0, 1.0)
    return tr


def test_span_tracer_records_as_jax():
    def run(m):
        tr = _tracer_script(m)
        return (tr.spans(), tr.open_spans(3), tr.open_spans(4), tr.rids(),
                tr.dropped, tr.end(9, "never"))
    spans, open3, open4, rids, dropped, none = _both(run)
    s1 = next(s for s in spans if s["rid"] == 1)
    assert (s1["t0"], s1["t1"], s1["dur"]) == (0.0, 1.0, 1.0)
    s2 = next(s for s in spans if s["rid"] == 2)
    assert s2["dur"] == 2.5 and s2["args"]["ticks"] == 4
    names3 = [s["name"] for s in spans if s["rid"] == 3]
    assert names3.count("cancelled") == 1 and open3 == []
    assert all(s["args"]["outcome"] == "cancelled" for s in spans
               if s["rid"] == 3 and s["name"] != "cancelled")
    assert open4 == ["queued"] and dropped == 3 and none is None


def test_chrome_events_and_export(tmp_path):
    def run(m):
        tr = _tracer_script(m)
        path = tr.export_chrome_trace(str(tmp_path / f"{m.tel.__name__}.json"))
        return json.load(open(path)), tr.chrome_events()
    blob, evs = _both(run)
    assert blob["traceEvents"] == evs
    meta = [e for e in evs if e["ph"] == "M" and e["name"] == "thread_name"
            and e["tid"] == 7]
    assert "acme" in meta[0]["args"]["name"]
    x = next(e for e in evs if e["ph"] == "X" and e["tid"] == 7)
    assert x["ts"] == 0.0 and x["dur"] == 1e6


def test_port_tracer_forwards_to_no_profiler():
    """The JAX tracer forwards each span into ``paddle_tpu.profiler``'s
    recorder; the port's has no profiler and keeps its spans to itself."""
    from paddle_tpu import profiler

    rec = profiler._recorder
    rec.drain()
    rec.enabled = True
    try:
        ttel.SpanTracer(clock=_FakeClock()).complete(9, "swap_out", 1.0, 2.0)
    finally:
        rec.enabled = False
    assert rec.drain() == []


# --------------------------------------------------------------------------
# FlightRecorder + watchdogs
# --------------------------------------------------------------------------

def test_flight_ring_wraparound_underfull_and_reset():
    def run(m):
        fr = m.tel.FlightRecorder(size=4)
        for i in range(10):
            fr.record(tick=i)
        wrapped = (fr.total, len(fr), fr.dump())
        small = m.tel.FlightRecorder(size=8)
        small.record(a=1)
        small.record(a=2)
        fr.reset()
        with pytest.raises(ValueError):
            m.tel.FlightRecorder(size=0)
        return wrapped, small.dump(), fr.dump(), fr.total
    (total, n, dump), small, after, t = _both(run)
    assert (total, n) == (10, 4) and [r["tick"] for r in dump] == [6, 7, 8, 9]
    assert [r["a"] for r in small] == [1, 2] and after == [] and t == 0


def _ticks(n, **base):
    return [dict(base, seq=i, prog="decode", preemptions=0, stalls=0,
                 recompiles=0) for i in range(n)]


def _watch(case):
    recs = _ticks(64)
    kw = {}
    if case == "preemption_storm":
        for i in range(20, 30):
            recs[i]["preemptions"] = 1
    elif case == "pool_pressure_stall":
        for i in range(16, 48):
            recs[i]["stalls"] = 2
    elif case == "steady_state_recompile":
        recs[40]["recompiles"] = 1
    elif case == "first_seen_program":
        recs[40]["prog"] = "spec:w4"
        recs[40]["recompiles"] = 1
    elif case == "warmup_ticks":
        recs[3]["recompiles"] = 2
    elif case == "warm_prog_at_zero":
        recs = _ticks(6)
        recs[0]["recompiles"] = 1
        kw["warm_progs"] = {"decode"}
    elif case == "new_prog_with_warm_set":
        recs[40]["prog"] = "spec:w4"
        recs[40]["recompiles"] = 1
        kw["warm_progs"] = {"decode"}
    elif case.startswith("thrash"):
        d, p, n = {"thrash_both": (1, 1, 32), "thrash_demote": (2, 0, 32),
                   "thrash_promote": (0, 2, 32),
                   "thrash_short": (1, 1, 8)}[case]
        recs = [{"seq": i, "demotions": d, "promotions": p,
                 "preemptions": 0, "stalled": 0, "recompiles": 0}
                for i in range(n)]
    return recs, kw


WATCH_CASES = {"quiet": [], "preemption_storm": ["preemption_storm"],
               "pool_pressure_stall": ["pool_pressure_stall"],
               "steady_state_recompile": ["steady_state_recompile"],
               "first_seen_program": [], "warmup_ticks": [],
               "warm_prog_at_zero": ["steady_state_recompile"],
               "new_prog_with_warm_set": [],
               "thrash_both": ["tier_thrash"], "thrash_demote": [],
               "thrash_promote": [], "thrash_short": []}


@pytest.mark.parametrize("case", sorted(WATCH_CASES))
def test_watchdog_findings_match_jax(case):
    recs, kw = _watch(case)
    finds = _both(lambda m: m.tel.watchdog(recs, **kw))
    assert [f["kind"] for f in finds] == WATCH_CASES[case]
    if case == "steady_state_recompile":
        assert finds[0]["seq"] == 40


def test_port_recompile_finding_names_graph_captures():
    recs, _ = _watch("steady_state_recompile")
    (f,) = ttel.watchdog(recs)
    assert "CUDA graph" in f["detail"]


def test_warm_program_fold_across_resets():
    def run(m):
        fr = m.tel.FlightRecorder(size=8)
        fr.record(prog="decode")
        fr.record(prog="prefill:16")
        fr.record(prog=None)
        fr.reset(fold_warm=True)
        first = set(fr.warm_progs)
        fr.record(prog="spec:w4")
        fr.reset(fold_warm=True)
        plain = m.tel.FlightRecorder(size=4)
        plain.record(prog="decode")
        plain.reset()
        tel = m.tel.ServingTelemetry()
        tel.flight.record(prog="decode", recompiles=1, preemptions=0,
                          stalls=0)
        tel.reset()
        tel.flight.record(prog="decode", recompiles=1, preemptions=0,
                          stalls=0)
        return (first, set(fr.warm_progs), set(plain.warm_progs),
                [f["kind"] for f in tel.watchdog()])
    first, both, plain, kinds = _both(run)
    assert first == {"decode", "prefill:16"}
    assert both == first | {"spec:w4"} and plain == set()
    assert kinds == ["steady_state_recompile"]


# --------------------------------------------------------------------------
# The disabled path
# --------------------------------------------------------------------------

def test_null_singletons_installed():
    def run(m):
        tel = m.tel.ServingTelemetry(enabled=False)
        null = (tel.tracer is m.tel.NULL_TRACER
                and tel.flight is m.tel.NULL_FLIGHT)
        tel.tracer.begin(1, "x")
        tel.flight.record(tick=1)
        return (null, tel.registry is not None, tel.tracer.spans(),
                tel.flight.dump(), tel.snapshot()["flight_ticks"])
    assert _both(run) == (True, True, [], [], 0)


def test_disabled_calls_do_not_accumulate_memory():
    """The port's no-op tracer and flight recorder retain nothing over 20k
    disabled-path calls (O(1) memory, not O(calls))."""
    tel = ttel.ServingTelemetry(enabled=False)
    tr, fl = tel.tracer, tel.flight
    for i in range(100):
        tr.begin(i, "s")
        fl.record(t=i)
    tracemalloc.start()
    before = tracemalloc.get_traced_memory()[0]
    for i in range(20_000):
        tr.begin(i, "s", a=1)
        tr.end(i, "s")
        tr.complete(i, "w", 0.0, 1.0, ticks=4)
        fl.record(t_wall_s=0.1, prog="decode", preemptions=0)
    grown = tracemalloc.get_traced_memory()[0] - before
    tracemalloc.stop()
    assert grown < 64 * 1024, f"disabled path retained {grown} bytes"


# --------------------------------------------------------------------------
# Faults
# --------------------------------------------------------------------------

def test_fault_spec_validation():
    def run(m):
        F = m.faults
        for kw, match in ((dict(site="warp_core"), "site"),
                          (dict(site="tick", at=-1), "at"),
                          (dict(site="tick", count=0), "count"),
                          (dict(site="warm_corrupt"), "site")):
            with pytest.raises(ValueError, match=match):
                F.FaultSpec(**kw)
        return (issubclass(F.EngineFailedError, RuntimeError),
                issubclass(F.TickFault, RuntimeError),
                issubclass(F.StepFault, RuntimeError),
                sorted(F.SITES))
    assert _both(run)[:3] == (True, True, True)


def _specs(plan):
    return [(s.site, s.at, s.count, s.kind, s.rid, s.magnitude)
            for s in plan.specs]


@pytest.mark.parametrize("seed", [0, 3, 9, 10, 123])
def test_chaos_plans_script_the_jax_specs(seed):
    """``chaos``, ``train_chaos``, ``fleet_chaos`` and ``disagg_chaos``
    draw the JAX package's specs, seed for seed."""
    def run(m):
        P = m.faults.FaultPlan
        return (_specs(P.chaos(seed)), _specs(P.chaos(seed, horizon=40)),
                _specs(P.chaos(seed, intensity=3, horizon=120)),
                _specs(P.train_chaos(seed)),
                _specs(P.train_chaos(seed, horizon=8, kills=3)),
                _specs(P.fleet_chaos(seed)),
                _specs(P.disagg_chaos(seed, replicas=3, prefill=2)))
    _both(run)


def test_injector_determinism_and_null_fast_path():
    sites = ["alloc", "tick", "drafter", "swap_corrupt", "host_put"] * 60

    def run(m):
        F = m.faults
        ia = F.FaultInjector(F.FaultPlan.chaos(9))
        ib = F.FaultInjector(F.FaultPlan.chaos(9))
        fired_a = [(s, ia.fire(s) is not None) for s in sites]
        fired_b = [(s, ib.fire(s) is not None) for s in sites]
        null = F.NULL_INJECTOR
        return (fired_a == fired_b, ia.fired == ib.fired, ia.fired,
                ia.stats(), F.FaultPlan.chaos(10).specs != ia.plan.specs,
                null.enabled, [null.fire(s) for s in sites[:5]], null.fired)
    same, same_fired, fired, _, differs, enabled, nulls, nfired = _both(run)
    assert same and same_fired and fired and differs
    assert not enabled and nulls == [None] * 5 and nfired == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_corrupt_flips_the_jax_bit_in_a_tensor(dtype):
    """The port's ``corrupt`` flips exactly one bit of a CPU tensor's bytes
    (bfloat16 through a uint8 view), the byte and bit the JAX injector
    flips in a numpy array of the same bytes, the same again for the same
    seed; across several payload arrays too."""
    rng = np.random.RandomState(0)
    t = (torch.from_numpy(rng.randn(8, 8).astype(np.float32))
         .to(getattr(torch, dtype)) if dtype != "int8" else
         torch.from_numpy(rng.randint(-127, 128, (8, 8)).astype(np.int8)))
    base = [t, torch.arange(12, dtype=torch.float32)]
    raw = [b.reshape(-1).view(torch.uint8).numpy().copy() for b in base]
    for seed in (5, 6, 7):
        ours = [b.clone() for b in base]
        tfaults.FaultInjector(tfaults.FaultPlan(
            [tfaults.FaultSpec("swap_corrupt")], seed=seed)).corrupt(ours)
        again = [b.clone() for b in base]
        tfaults.FaultInjector(tfaults.FaultPlan(
            [tfaults.FaultSpec("swap_corrupt")], seed=seed)).corrupt(again)
        theirs = [r.copy() for r in raw]
        jfaults.FaultInjector(jfaults.FaultPlan(
            [jfaults.FaultSpec("swap_corrupt")], seed=seed)).corrupt(theirs)
        got = [o.reshape(-1).view(torch.uint8).numpy() for o in ours]
        for g, w, a in zip(got, theirs, again):
            assert np.array_equal(g, w)
            assert np.array_equal(g, a.reshape(-1).view(torch.uint8).numpy())
        flipped = sum(bin(int(x)).count("1") for g, r in zip(got, raw)
                      for x in np.bitwise_xor(g, r))
        assert flipped == 1


def test_corrupt_refuses_a_device_or_strided_tensor():
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        [tfaults.FaultSpec("swap_corrupt")], seed=1))
    with pytest.raises(ValueError, match="contiguous host"):
        inj.corrupt([torch.zeros(4, 4).t()])


def test_wrap_clock_stall_and_jump_back():
    def run(m):
        F = m.faults
        t = [100.0]
        plan = F.FaultPlan([F.FaultSpec("clock", at=1, count=1, kind="stall"),
                            F.FaultSpec("clock", at=3, count=1,
                                        kind="jump_back", magnitude=50.0)])
        clock = F.FaultInjector(plan).wrap_clock(lambda: t[0])
        out = [clock()]
        t[0] = 110.0
        out += [clock(), clock(), clock()]
        t[0] = 120.0
        return out + [clock()]
    assert _both(run) == [100.0, 100.0, 110.0, 60.0, 120.0]


def test_scheduler_clock_monotonic_clamp():
    def run(m):
        t = [100.0]
        s = m.sched.Scheduler("priority", clock=lambda: t[0])
        s.submit("a", 0, ttl_s=30.0)
        first = s.now()
        t[0] = 40.0
        clamped = s.now()
        s.submit("b", 1, ttl_s=5.0)
        order = [e.rid for e in s.waiting()]
        none = s.expire()
        t[0] = 106.0
        return first, clamped, order, none, [e.rid for e in s.expire()]
    assert _both(run) == (100.0, 100.0, [1, 0], [], [1])


def test_scheduler_attach_metrics_seeds_history():
    """``attach_metrics`` seeds the counts made before it, then mirrors
    submit (labeled by tenant), cancel and expiry into the registry."""
    def run(m):
        t = [0.0]
        s = m.sched.Scheduler("fifo", clock=lambda: t[0])
        s.submit("a", 0, tenant="x")
        s.submit("b", 1, ttl_s=1.0)
        s.cancel(0)
        reg = m.tel.MetricsRegistry()
        s.attach_metrics(reg)
        s.submit("c", 2, tenant="y")
        t[0] = 5.0
        s.expire()
        return reg.to_json()["counters"]
    got = _both(run)
    assert got["sched_requests_submitted"]["series"][-1]["value"] == 1.0


# --------------------------------------------------------------------------
# Training telemetry: the ledger, the watchdog and the engine
# --------------------------------------------------------------------------

def test_goodput_ledger():
    def run(m):
        g = m.tel.GoodputLedger()
        for i in range(50):
            g.step(i, 0.001 * (i + 1))
        clean = (g.ratio(), g.snapshot()["lost_steps"])
        r = m.tel.GoodputLedger()
        r.step(0, 2.0)
        r.step(1, 3.0)
        r.step(1, 5.0)
        replay = r.snapshot()
        k = m.tel.GoodputLedger()
        k.step(0, 6.0)
        k.recovery(2.0)
        return clean, replay, r.ratio(), k.snapshot(), k.ratio()
    clean, replay, ratio, rec, rec_ratio = _both(run)
    assert clean == (1.0, 0)
    assert replay["lost_s"] == 3.0 and replay["productive_s"] == 7.0
    assert ratio == pytest.approx(0.7)
    assert rec["recoveries"] == 1 and rec_ratio == pytest.approx(0.75)


def _steps(n, wall=0.01, **extra):
    return [dict({"step": i, "seq": i, "prog": "train:8x4;8x2",
                  "t_wall_s": wall, "data_feed_s": 0.0, "recompiles": 0,
                  "ckpt_backoffs": 0}, **extra) for i in range(n)]


def _train_watch(case):
    kw = {}
    if case == "quiet":
        recs = _steps(40)
        recs[0]["recompiles"] = 1
    elif case == "steady_state_recompile":
        recs = _steps(40)
        recs[20]["recompiles"] = 1
    elif case == "warm_prog_at_zero":
        recs = _steps(6)
        recs[0]["recompiles"] = 1
        kw["warm_progs"] = {"train:8x4;8x2"}
    elif case == "step_time_regression":
        recs = _steps(30)
        for r in recs[-8:]:
            r["t_wall_s"] = 0.05
    elif case == "data_feed_stall":
        recs = _steps(32)
        for r in recs[8:24]:
            r["data_feed_s"] = 0.02
    else:
        recs = _steps(40)
        for i in (10, 12, 14, 16):
            recs[i]["ckpt_backoffs"] = 1
    return recs, kw


TRAIN_WATCH = {"quiet": [], "steady_state_recompile":
               ["steady_state_recompile"],
               "warm_prog_at_zero": ["steady_state_recompile"],
               "step_time_regression": ["step_time_regression"],
               "data_feed_stall": ["data_feed_stall"],
               "ckpt_backoff_storm": ["ckpt_backoff_storm"]}


@pytest.mark.parametrize("case", sorted(TRAIN_WATCH))
def test_train_watchdog_findings_match_jax(case):
    recs, kw = _train_watch(case)
    finds = _both(lambda m: m.tel.train_watchdog(recs, **kw))
    assert [f["kind"] for f in finds] == TRAIN_WATCH[case]
    if case == "step_time_regression":
        assert finds[0]["factor"] == pytest.approx(5.0)


def test_train_telemetry_hooks_match_jax():
    """The hooks the checkpointer, the data feed and the chaos harness call
    (``record_data_feed``, ``record_ckpt``, ``note_ckpt_backoff``,
    ``record_recovery``) and ``record_step`` with a peak: the same spans,
    flight records, gauges and snapshot as JAX's."""
    def run(m):
        tel = m.tel.TrainTelemetry(clock=_FakeClock(), peak_flops=1e9)
        tel.model_params = 10
        tel.record_data_feed(0.0, 0.5, cursor=0)
        tel.note_ckpt_backoff(attempt=1)
        tel.record_step(step=0, prog="train:2x3", tokens=6, t0=1.0,
                        t_h2d=1.5, t_dispatch=2.0, t_wait=3.0, compiles=1)
        tel.record_ckpt("ckpt_save", 3.0, 3.25, step=0)
        tel.record_recovery(4.0, 5.0)
        tel.record_step(step=0, prog="train:2x3", tokens=6, t0=5.0,
                        t_h2d=5.5, t_dispatch=6.0, t_wait=8.0)
        snap = tel.snapshot()
        tel.reset()
        return (tel.tracer.spans() == [], snap,
                json.loads(json.dumps(snap)) == snap)
    cleared, snap, serializable = _both(run)
    assert cleared and serializable
    assert snap["goodput"]["lost_steps"] == 1
    assert snap["metrics"]["gauges"]["train_mfu"]["series"][0]["value"] > 0


def _engine_step_records(tel):
    return [{k: v for k, v in r.items()
             if k not in ("recompiles", "t_wall_s", "h2d_s", "dispatch_s",
                          "wait_s")} for r in tel.flight.dump()]


def _engines(telemetry, injector=None):
    """The JAX engine (``paddle.nn.Linear(4, 2)``, MSE, AdamW) and the
    port's over the same weights; ``telemetry(m)`` / ``injector(m)`` make
    each side's facade."""
    from paddle_tpu import nn, optimizer
    from paddle_tpu.parallel.engine import ParallelEngine as JEngine
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    paddle.seed(5)
    jm = nn.Linear(4, 2)
    je = JEngine(jm, optimizer.AdamW(learning_rate=0.05,
                                     parameters=jm.parameters()),
                 loss_fn=nn.functional.mse_loss, donate=False,
                 injector=injector(JAX) if injector else
                 jfaults.NULL_INJECTOR, telemetry=telemetry(JAX))
    tm = Linear(4, 2, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(jm.weight.value)))
        tm.bias.copy_(torch.from_numpy(np.array(jm.bias.value)))
    te = ParallelEngine(tm, AdamW(learning_rate=0.05,
                                  parameters=tm.named_parameters()),
                        loss_fn=lambda out, y: ((out - y) ** 2).mean(),
                        injector=injector(PORT) if injector else None,
                        telemetry=telemetry(PORT))
    return (je, te)


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return (rng.randn(8, 4).astype("float32"),
            rng.randn(8, 2).astype("float32"))


def _train(je, te, n, start=0):
    for i in range(start, start + n):
        X, y = _batch(i)
        je.train_batch(paddle.to_tensor(X), paddle.to_tensor(y))
        te.train_batch(torch.from_numpy(X), torch.from_numpy(y))


def test_engine_step_telemetry_matches_jax():
    """Five steps with ``TrainTelemetry``: the same span names on the
    train row, the same flight records (step, prog key, tokens, feed and
    backoff fields), counters, goodput exactly 1.0 and no watchdog
    finding. The port's ``recompiles`` is its capture delta (0 here: the
    CPU runs eagerly)."""
    tels = {}

    def make(m):
        tels[m.tel.__name__] = t = m.tel.TrainTelemetry()
        return t
    je, te = _engines(make)
    _train(je, te, 5)
    jt, tt = tels["paddle_tpu.telemetry"], tels["paddle_tpu_torch.telemetry"]
    names = sorted({s["name"] for s in tt.tracer.spans(ttel.TRAIN_RID)})
    assert names == sorted({s["name"] for s in
                            jt.tracer.spans(jtel.TRAIN_RID)}) == [
        "device_wait", "dispatch", "host_to_device", "train_step"]
    assert _engine_step_records(tt) == _engine_step_records(jt)
    assert tt.flight.dump()[0]["prog"] == "train:8x4;8x2"
    assert all(r["recompiles"] == 0 for r in tt.flight.dump())
    for name in ("train_steps", "train_tokens_total"):
        assert tt.registry.counter(name).total() == \
            jt.registry.counter(name).total()
    assert tt.registry.histogram("train_step_time_s").count() == 5
    assert tt.goodput.ratio() == 1.0 == jt.goodput.ratio()
    assert tt.registry.gauge("train_goodput_ratio").value() == 1.0
    assert tt.watchdog() == [] and tt.model_params == jt.model_params == 10
    json.dumps(tt.snapshot())


def test_engine_mfu_needs_peak_flops_and_none_records_nothing():
    je, te = _engines(lambda m: m.tel.TrainTelemetry())
    _train(je, te, 2)
    assert te.telemetry.registry.gauge("train_mfu").value() == 0
    je2, te2 = _engines(lambda m: m.tel.TrainTelemetry(peak_flops=1e12))
    _train(je2, te2, 2)
    assert te2.telemetry.registry.gauge("train_mfu").value() > 0
    je3, te3 = _engines(lambda m: None)
    _train(je3, te3, 2)
    assert te3.telemetry is None and je3.telemetry is None


def test_engine_rejects_a_foreign_injector_or_telemetry():
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    m = Linear(4, 2, device="cpu")
    opt = AdamW(parameters=m.named_parameters())
    for kw in (dict(injector=object()), dict(telemetry=object()),
               dict(telemetry=True)):
        with pytest.raises(ValueError):
            ParallelEngine(m, opt, **kw)
