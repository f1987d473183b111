"""Whole-stack telemetry — port of ``paddle_tpu/telemetry.py``: the metrics
registry, span tracing, flight recorders and goodput accounting that serving
and training share. ``paddle_tpu_torch.inference.telemetry`` re-exports it.

Serving tier (facade: :class:`ServingTelemetry`, held by
``GenerationServer(telemetry=...)``):

- :class:`MetricsRegistry` — counters / gauges / bounded-bucket
  histograms, labeled (tenant, priority, phase, ...), with JSON and
  Prometheus-text exposition. The registry is ALWAYS live on a server
  (its counters are the single source of truth behind
  ``sched_metrics()``); only spans and the flight recorder gate on
  ``enabled``.
- :class:`SpanTracer` — per-request lifecycle spans (queued → prefill
  chunks → decode/spec windows → preempt/swap-out/swap-in → complete/
  cancel/expire) dumped as chrome-trace JSON, one timeline row per
  request. The JAX tracer also forwards each finished span to the host
  profiler's event recorder; the port has no profiler yet, so that
  forward is left out.
- :class:`FlightRecorder` — fixed-size ring of per-tick records (batch
  occupancy, program key, block/swap deltas, preemptions, spec
  acceptance, program-build deltas, wall time) with :func:`watchdog`
  post-mortem analysis: preemption storms, pool-pressure stalls, tier
  thrash and steady-state recompiles. On the port a "recompile" is a CUDA
  graph captured on a program key already seen: the count a server or
  engine records is its capture delta.

Training tier (facade: :class:`TrainTelemetry`, held by
``ParallelEngine(telemetry=...)``):

- per-step spans on reserved timeline row :data:`TRAIN_RID` —
  host_to_device, dispatch, device_wait (the engine synchronises the loss
  when telemetry is attached) and, from the hooks the checkpointer and
  the data feed will call, data_feed and ckpt_save / ckpt_restore — on the
  SAME chrome-trace timeline as serving request spans when the tracer is
  shared (``TrainTelemetry(tracer=serving_tel.tracer)``);
- step-time / tokens-per-second / MFU gauges (MFU uses the 6·N·T
  dense-transformer FLOP estimate against ``peak_flops``, default from
  ``PT_PEAK_TFLOPS``, unset unless given: this module states no device's
  peak);
- a training :class:`FlightRecorder` ring analysed by
  :func:`train_watchdog`: steady-state recompiles (shape wobble across
  steps), step-time regressions, data-feed stalls, and
  checkpoint-backoff storms;
- :class:`GoodputLedger` — productive step wall time vs. total wall
  time. A step index run twice (replay after a restore) books the first
  run as lost work; recovery wall time is booked by the caller. The
  resulting ``train_goodput_ratio`` gauge is exactly 1.0 on a fault-free
  run.

Overhead contract: telemetry is HOST-side only — nothing in this module is
called from inside a captured program, and the disabled path is
allocation-free: ``enabled=False`` installs shared no-op tracer/flight
singletons whose methods take ``*args`` and return immediately. The server
and the engine go one further: ``telemetry=None`` (the default) skips even
the clock reads, and the engine's per-step synchronise.

Determinism: registry and tracer take an injectable ``clock`` (default
``time.perf_counter``), mirroring ``Scheduler(clock=)``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SpanTracer", "FlightRecorder", "ServingTelemetry", "watchdog",
           "DEFAULT_BUCKETS", "TRAIN_RID", "GoodputLedger",
           "TrainTelemetry", "train_watchdog"]

# generic latency-ish bucket ladder (seconds); histograms can override
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# reserved SpanTracer rid for the training loop: one timeline row, below
# every request row (thread_sort_index orders by rid), so a trace from a
# process that both trains and serves shows the step loop and the
# request lifecycles on one timeline.
TRAIN_RID = -1


def _lkey(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable key for a label set (values coerced to str —
    Prometheus labels are strings, and it keeps 1 vs 1.0 vs "1" stable)."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _matches(key: Tuple[Tuple[str, str], ...],
             where: Optional[Dict[str, Any]]) -> bool:
    if not where:
        return True
    d = dict(key)
    return all(d.get(k) == str(v) for k, v in where.items())


class Counter:
    """Monotonic counter over label sets. ``inc()`` with no labels uses
    the empty label set; ``total()`` sums every set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _lkey(labels)
        self._vals[k] = self._vals.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(_lkey(labels), 0.0)

    def total(self, where: Optional[Dict[str, Any]] = None) -> float:
        return sum(v for k, v in self._vals.items() if _matches(k, where))

    def series(self) -> List[Tuple[Tuple, float]]:
        return sorted(self._vals.items())


class Gauge(Counter):
    """Point-in-time value over label sets (``set`` replaces; ``inc``
    still works for up/down adjustments)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._vals[_lkey(labels)] = float(value)


class Histogram:
    """Bounded-bucket histogram with exact-percentile support.

    Each label set keeps cumulative-style bucket counts (le semantics),
    a running sum/count, AND the raw samples up to ``max_samples`` —
    percentiles come from ``np.percentile`` over the raw samples (exact,
    matching the pre-registry ad-hoc lists) and fall back to linear
    bucket interpolation once a series overflows its sample bound (the
    bound is what keeps a week-long server from hoarding memory).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 max_samples: int = 8192):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be a sorted non-empty sequence, "
                             f"got {buckets!r}")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.max_samples = int(max_samples)
        self._series: Dict[Tuple, Dict[str, Any]] = {}

    def _row(self, k: Tuple) -> Dict[str, Any]:
        row = self._series.get(k)
        if row is None:
            row = {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                   "count": 0, "samples": [], "clipped": False}
            self._series[k] = row
        return row

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        row = self._row(_lkey(labels))
        i = int(np.searchsorted(self.buckets, v, side="left"))
        row["counts"][i] += 1
        row["sum"] += v
        row["count"] += 1
        if len(row["samples"]) < self.max_samples:
            row["samples"].append(v)
        else:
            row["clipped"] = True

    # ------------------------------------------------------------- queries
    def _rows(self, where: Optional[Dict[str, Any]]):
        return [(k, r) for k, r in self._series.items() if _matches(k, where)]

    def count(self, where: Optional[Dict[str, Any]] = None) -> int:
        return sum(r["count"] for _, r in self._rows(where))

    def sum(self, where: Optional[Dict[str, Any]] = None) -> float:
        return sum(r["sum"] for _, r in self._rows(where))

    def samples(self, where: Optional[Dict[str, Any]] = None) -> List[float]:
        out: List[float] = []
        for _, r in self._rows(where):
            out.extend(r["samples"])
        return out

    def label_values(self, key: str) -> List[str]:
        out = {dict(k)[key] for k in self._series if key in dict(k)}
        return sorted(out)

    def percentile(self, q: float,
                   where: Optional[Dict[str, Any]] = None) -> Optional[float]:
        """q in [0, 100]. Exact (np.percentile over raw samples) unless a
        matching series clipped its sample list — then bucket-interpolated."""
        rows = self._rows(where)
        if not rows or not any(r["count"] for _, r in rows):
            return None
        if not any(r["clipped"] for _, r in rows):
            return float(np.percentile(
                np.concatenate([np.asarray(r["samples"]) for _, r in rows
                                if r["samples"]]), q))
        # merged bucket counts → linear interpolation inside the bucket
        counts = np.sum([r["counts"] for _, r in rows], axis=0)
        total = int(counts.sum())
        target = (q / 100.0) * (total - 1) if total > 1 else 0.0
        edges = (0.0,) + self.buckets
        cum = 0
        for i, c in enumerate(counts):
            if cum + c > target:
                lo = edges[i]
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                frac = (target - cum) / c if c else 0.0
                return float(lo + (hi - lo) * frac)
            cum += c
        return float(self.buckets[-1])


class MetricsRegistry:
    """Get-or-create instrument store with JSON / Prometheus exposition.

    ``clock`` is injectable for deterministic tests and feeds
    :meth:`timer`. Instruments are keyed by name; asking for an existing
    name with a different kind raises (one name, one meaning).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_samples: int = 8192):
        self.clock = clock
        self.max_samples = int(max_samples)
        self._instruments: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls) or inst.kind != cls.kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, help,
                         buckets=buckets or DEFAULT_BUCKETS,
                         max_samples=self.max_samples)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def percentile(self, name: str, q: float,
                   where: Optional[Dict[str, Any]] = None) -> Optional[float]:
        h = self._instruments.get(name)
        return h.percentile(q, where) if isinstance(h, Histogram) else None

    def timer(self, name: str, **labels):
        """Context manager: observe the block's wall duration (via the
        injected clock) into histogram ``name``."""
        reg = self

        class _Timer:
            def __enter__(self):
                self.t0 = reg.clock()
                return self

            def __exit__(self, *exc):
                reg.histogram(name).observe(reg.clock() - self.t0, **labels)
                return False

        return _Timer()

    # ----------------------------------------------------------- exposition
    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for name in self.names():
            inst = self._instruments[name]
            if isinstance(inst, Histogram):
                series = []
                for k, r in sorted(inst._series.items()):
                    row = {"labels": dict(k), "count": r["count"],
                           "sum": r["sum"], "clipped": r["clipped"],
                           "bucket_counts": list(r["counts"])}
                    if r["count"]:
                        row["p50"] = inst.percentile(50.0, dict(k))
                        row["p95"] = inst.percentile(95.0, dict(k))
                    series.append(row)
                entry: Dict[str, Any] = {"help": inst.help,
                                         "buckets": list(inst.buckets),
                                         "series": series}
                if inst.count():
                    entry["p50"] = inst.percentile(50.0)
                    entry["p95"] = inst.percentile(95.0)
                    entry["p99"] = inst.percentile(99.0)
                    entry["count"] = inst.count()
                    entry["sum"] = inst.sum()
                out["histograms"][name] = entry
            else:
                out[inst.kind + "s"][name] = {
                    "help": inst.help,
                    "series": [{"labels": dict(k), "value": v}
                               for k, v in inst.series()]}
        return out

    @staticmethod
    def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                    extra: Optional[Tuple[Tuple[str, str], ...]] = None) \
            -> str:
        items = list(key) + list(extra or ())
        if not items:
            return ""
        def esc(v: str) -> str:
            return v.replace("\\", r"\\").replace('"', r'\"') \
                    .replace("\n", r"\n")
        return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name in self.names():
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                for k, r in sorted(inst._series.items()):
                    cum = 0
                    for b, c in zip(inst.buckets, r["counts"]):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{self._fmt_labels(k, (('le', repr(b)),))} "
                            f"{cum}")
                    lines.append(
                        f"{name}_bucket"
                        f"{self._fmt_labels(k, (('le', '+Inf'),))} "
                        f"{r['count']}")
                    lines.append(
                        f"{name}_sum{self._fmt_labels(k)} {r['sum']}")
                    lines.append(
                        f"{name}_count{self._fmt_labels(k)} {r['count']}")
            else:
                for k, v in inst.series():
                    lines.append(f"{name}{self._fmt_labels(k)} {v}")
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------------- resets
    def reset_histograms(self) -> None:
        """Clear histogram series (counters/gauges keep their lifetime
        values) — the benchmark calls this after its warmup drain so
        percentiles cover only the measured region."""
        for inst in self._instruments.values():
            if isinstance(inst, Histogram):
                inst._series.clear()

    def reset(self) -> None:
        for inst in self._instruments.values():
            if isinstance(inst, Histogram):
                inst._series.clear()
            else:
                inst._vals.clear()


# --------------------------------------------------------------------------- #
# Span tracing
# --------------------------------------------------------------------------- #


class SpanTracer:
    """Per-request lifecycle spans with chrome-trace export.

    Spans are keyed ``(rid, name)``; at most one span of a given name is
    open per request (``begin`` on an already-open name closes it first —
    the serving lifecycle never legitimately nests a span inside itself).
    ``complete`` records a retroactive span from timestamps the caller
    captured around a replayed program — the decode/verify trip path, where
    one device program advances many requests and per-request begin/end
    would misattribute the shared wall time. The training tier records
    ALL its spans this way, on the reserved :data:`TRAIN_RID` row.
    Unlike the JAX tracer it forwards nothing to a profiler (the port has
    none yet).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_spans: int = 65536):
        self.clock = clock
        self.max_spans = int(max_spans)
        self._open: Dict[Tuple[int, str], Dict[str, Any]] = {}
        self._done: List[Dict[str, Any]] = []
        self._meta: Dict[int, Dict[str, Any]] = {}
        self.dropped = 0

    # ------------------------------------------------------------- recording
    def set_meta(self, rid: int, **meta) -> None:
        self._meta.setdefault(rid, {}).update(meta)

    def begin(self, rid: int, name: str, **args) -> None:
        key = (rid, name)
        if key in self._open:
            self.end(rid, name)
        self._open[key] = {"rid": rid, "name": name, "t0": self.clock(),
                           "args": args}

    def end(self, rid: int, name: str, **args) -> Optional[float]:
        span = self._open.pop((rid, name), None)
        if span is None:
            return None
        t1 = self.clock()
        if args:
            span["args"].update(args)
        return self._finish(span, t1)

    def complete(self, rid: int, name: str, t0: float, t1: float,
                 **args) -> None:
        self._finish({"rid": rid, "name": name, "t0": t0, "args": args}, t1)

    def instant(self, rid: int, name: str, **args) -> None:
        t = self.clock()
        self._finish({"rid": rid, "name": name, "t0": t, "args": args,
                      "instant": True}, t)

    def close(self, rid: int, outcome: Optional[str] = None) -> None:
        """End every open span of ``rid`` (preempt/cancel/complete paths
        may leave e.g. a ``preempted`` span open) and drop an ``outcome``
        marker — span trees stay well-formed on every exit path."""
        for (r, name) in [k for k in self._open if k[0] == rid]:
            self.end(r, name, outcome=outcome)
        if outcome is not None:
            self.instant(rid, outcome)

    def _finish(self, span: Dict[str, Any], t1: float) -> float:
        span["t1"] = t1
        dur = t1 - span["t0"]
        span["dur"] = dur
        if len(self._done) < self.max_spans:
            self._done.append(span)
        else:
            self.dropped += 1
        return dur

    # --------------------------------------------------------------- queries
    def open_spans(self, rid: int) -> List[str]:
        return sorted(name for (r, name) in self._open if r == rid)

    def spans(self, rid: Optional[int] = None) -> List[Dict[str, Any]]:
        out = [s for s in self._done if rid is None or s["rid"] == rid]
        return sorted(out, key=lambda s: (s["t0"], s["rid"]))

    def rids(self) -> List[int]:
        return sorted({s["rid"] for s in self._done})

    # ---------------------------------------------------------- chrome trace
    def chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome-trace events: one ``tid`` (= timeline row) per request,
        named via thread_name metadata — a preempted request's swap-out /
        swap-in and its decode windows share one row. A row whose meta
        carries ``name`` (the train loop's :data:`TRAIN_RID` row) uses it
        as the label instead of ``req <rid>``."""
        events: List[Dict[str, Any]] = []
        for rid in self.rids():
            meta = self._meta.get(rid, {})
            label = meta.get("name") or f"req {rid}"
            if meta.get("tenant"):
                label += f" [{meta['tenant']}]"
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": rid, "args": {"name": label}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                           "tid": rid, "args": {"sort_index": rid}})
        for s in self.spans():
            ev = {"name": s["name"], "pid": 0, "tid": s["rid"],
                  "ts": s["t0"] * 1e6, "cat": "serving",
                  "args": dict(s["args"], rid=s["rid"])}
            if s.get("instant"):
                ev.update({"ph": "i", "s": "t"})
            else:
                ev.update({"ph": "X", "dur": s["dur"] * 1e6})
            events.append(ev)
        return events

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)
        return path

    def reset(self) -> None:
        self._open.clear()
        self._done.clear()
        self._meta.clear()
        self.dropped = 0


# --------------------------------------------------------------------------- #
# Flight recorder + watchdogs
# --------------------------------------------------------------------------- #


class FlightRecorder:
    """Fixed-size ring of per-tick records for post-mortem debugging.

    ``record(**fields)`` stamps a monotonically increasing ``seq``;
    ``dump()`` returns surviving records oldest → newest. The ring never
    grows — a wedged server's last N ticks are always reconstructable at
    O(size) memory.

    ``warm_progs`` carries program keys across :meth:`reset` boundaries:
    ``reset(fold_warm=True)`` folds the surviving records' ``prog`` keys
    in before clearing, so a post-reset :func:`watchdog` pass knows which
    programs were already compiled pre-boundary (the benchmark's warmup
    drain) — a recompile of one of those is a finding even on the first
    post-boundary tick, and a warmup compile can never resurface as a
    post-warmup finding.
    """

    def __init__(self, size: int = 256):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = int(size)
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.size
        self._n = 0
        self.warm_progs: set = set()

    def record(self, **fields) -> None:
        fields["seq"] = self._n
        self._ring[self._n % self.size] = fields
        self._n += 1

    @property
    def total(self) -> int:
        """Ticks recorded over the recorder's lifetime (≥ ``len(self)``)."""
        return self._n

    def __len__(self) -> int:
        return min(self._n, self.size)

    def dump(self) -> List[Dict[str, Any]]:
        if self._n <= self.size:
            return [r for r in self._ring[:self._n]]
        head = self._n % self.size
        return self._ring[head:] + self._ring[:head]

    def reset(self, fold_warm: bool = False) -> None:
        if fold_warm:
            for r in self.dump():
                prog = r.get("prog")
                if prog is not None:
                    self.warm_progs.add(prog)
        self._ring = [None] * self.size
        self._n = 0


def _sliding_worst(recs: List[Dict[str, Any]], field: str, window: int,
                   pred=None) -> Tuple[int, int]:
    """Worst ``window``-wide sliding sum of ``field`` (or of ``pred``
    truthiness) over the records; returns (best_sum, index_of_window_end)."""
    vals = [int(bool(pred(r)) if pred else r.get(field, 0)) for r in recs]
    best, best_i = 0, 0
    run = 0
    for i, v in enumerate(vals):
        run += v
        if i >= window:
            run -= vals[i - window]
        if run > best:
            best, best_i = run, i
    return best, best_i


def watchdog(records: Iterable[Dict[str, Any]], *,
             preempt_window: int = 32, preempt_storm: int = 8,
             stall_window: int = 32, stall_frac: float = 0.5,
             thrash_window: int = 32, thrash_blocks: int = 16,
             warmup_ticks: int = 8,
             warm_progs: Optional[Iterable[str]] = None) \
        -> List[Dict[str, Any]]:
    """SLO analysis over a flight-recorder dump. Returns findings:

    - ``preemption_storm``: ≥ ``preempt_storm`` preemptions inside some
      ``preempt_window``-tick window — thrash, not load balancing.
    - ``pool_pressure_stall``: ≥ ``stall_frac`` of some
      ``stall_window``-tick window stalled on block reservation — the
      pool is undersized for the workload (or the host pool refused).
    - ``tier_thrash``: ≥ ``thrash_blocks`` demotions AND ≥
      ``thrash_blocks`` promotions inside the same
      ``thrash_window``-tick window — blocks ping-ponging across the
      HBM↔warm boundary, paying both copies without netting capacity
      (demotion alone is healthy pressure relief; promotion alone is
      healthy cache reuse; BOTH at volume means the watermarks sit on
      top of the working set).
    - ``steady_state_recompile``: a program build (on the port, a CUDA
      graph capture) on a tick whose program key was ALREADY seen on an
      earlier tick (and past ``warmup_ticks``) — first use of a new
      program (gate flip, turbo tier) legitimately builds once; the same
      program building again is the recompile-storm bug class.
      ``warm_progs`` pre-seeds the seen set with programs compiled
      before the dump started (``FlightRecorder.warm_progs`` after a
      warmup-boundary reset); a compile on one of THOSE is a finding at
      any index — the ``warmup_ticks`` excusal only covers programs
      making their genuine first appearance inside this dump.

    One finding per kind (the worst/first window), so a gate can assert
    ``not findings`` without counting duplicates.
    """
    recs = list(records)
    findings: List[Dict[str, Any]] = []

    worst, at = _sliding_worst(recs, "preemptions", preempt_window)
    if worst >= preempt_storm:
        findings.append({
            "kind": "preemption_storm",
            "count": worst, "window": preempt_window,
            "seq": recs[at]["seq"],
            "detail": f"{worst} preemptions in {preempt_window} ticks "
                      f"(ending seq {recs[at]['seq']}) — raise the pool "
                      f"budget or lower arrival rate"})

    worst, at = _sliding_worst(recs, "stalls", stall_window,
                               pred=lambda r: r.get("stalls", 0) > 0)
    window = min(stall_window, len(recs)) or 1
    if worst / window >= stall_frac and worst > 0:
        findings.append({
            "kind": "pool_pressure_stall",
            "count": worst, "window": stall_window,
            "seq": recs[at]["seq"],
            "detail": f"{worst}/{window} ticks stalled on block "
                      f"reservation — pool (or host pool) undersized"})

    worst_d, at_d = _sliding_worst(recs, "demotions", thrash_window)
    worst_p, at_p = _sliding_worst(recs, "promotions", thrash_window)
    if worst_d >= thrash_blocks and worst_p >= thrash_blocks:
        at = max(at_d, at_p)
        findings.append({
            "kind": "tier_thrash",
            "demotions": worst_d, "promotions": worst_p,
            "window": thrash_window, "seq": recs[at]["seq"],
            "detail": f"{worst_d} demotions and {worst_p} promotions in "
                      f"{thrash_window} ticks — the warm tier is churning "
                      f"the working set; widen the watermark band "
                      f"(tier_demote_low/high) or raise the pool budget"})

    warm = set(warm_progs) if warm_progs else set()
    seen_progs: set = set(warm)
    bad: List[int] = []
    total = 0
    for i, r in enumerate(recs):
        prog = r.get("prog")
        compiles = int(r.get("recompiles", 0))
        if compiles and prog in seen_progs \
                and (prog in warm or i >= warmup_ticks):
            bad.append(r["seq"])
            total += compiles
        if prog is not None:
            seen_progs.add(prog)
    if bad:
        findings.append({
            "kind": "steady_state_recompile",
            "count": total, "seqs": bad, "seq": bad[0],
            "detail": f"{total} program build(s) (CUDA graph "
                      f"captures) on already-warm program(s) at tick "
                      f"seq(s) {bad[:8]} — a shape or static-arg wobble"})
    return findings


def train_watchdog(records: Iterable[Dict[str, Any]], *,
                   warmup_steps: int = 3,
                   warm_progs: Optional[Iterable[str]] = None,
                   regress_window: int = 8, regress_factor: float = 1.5,
                   feed_stall_window: int = 16, feed_stall_frac: float = 0.5,
                   backoff_window: int = 32, backoff_storm: int = 3) \
        -> List[Dict[str, Any]]:
    """Post-mortem analysis over a TRAINING flight-recorder dump
    (records from :meth:`TrainTelemetry.record_step`). Findings:

    - ``steady_state_recompile``: same contract as the serving
      :func:`watchdog` — a compile on a step whose program key (batch
      shape signature) was already seen is a shape/static-arg wobble.
    - ``step_time_regression``: the median wall of the last
      ``regress_window`` steps is ≥ ``regress_factor`` × the median of
      the first post-warmup window — the loop got durably slower
      (fragmentation, a competing process, thermal throttle).
    - ``data_feed_stall``: ≥ ``feed_stall_frac`` of some
      ``feed_stall_window``-step window spent longer feeding data than
      stepping — the loop is input-bound, not compute-bound.
    - ``ckpt_backoff_storm``: ≥ ``backoff_storm`` checkpoint-save
      retries inside ``backoff_window`` steps — the store is flapping
      and the retry ladder is eating step time.

    One finding per kind, so gates can assert ``not findings``.
    """
    recs = list(records)
    findings = [f for f in watchdog(recs, warmup_ticks=warmup_steps,
                                    warm_progs=warm_progs)
                if f["kind"] == "steady_state_recompile"]

    walls = [float(r.get("t_wall_s", 0.0)) for r in recs]
    if len(walls) >= warmup_steps + 2 * regress_window:
        base = float(np.median(
            walls[warmup_steps:warmup_steps + regress_window]))
        recent = float(np.median(walls[-regress_window:]))
        if base > 0 and recent >= regress_factor * base:
            findings.append({
                "kind": "step_time_regression",
                "baseline_s": base, "recent_s": recent,
                "factor": recent / base, "seq": recs[-1]["seq"],
                "detail": f"median step time {recent:.4f}s over the last "
                          f"{regress_window} steps vs {base:.4f}s baseline "
                          f"({recent / base:.2f}x) — the loop got durably "
                          f"slower"})

    worst, at = _sliding_worst(
        recs, "data_feed_s", feed_stall_window,
        pred=lambda r: r.get("data_feed_s", 0.0) > r.get("t_wall_s", 0.0))
    window = min(feed_stall_window, len(recs)) or 1
    if worst / window >= feed_stall_frac and worst > 0:
        findings.append({
            "kind": "data_feed_stall",
            "count": worst, "window": feed_stall_window,
            "seq": recs[at]["seq"],
            "detail": f"{worst}/{window} steps spent longer in data_feed "
                      f"than in the step itself — input-bound; widen the "
                      f"feed (prefetch, more workers)"})

    worst, at = _sliding_worst(recs, "ckpt_backoffs", backoff_window)
    if worst >= backoff_storm:
        findings.append({
            "kind": "ckpt_backoff_storm",
            "count": worst, "window": backoff_window,
            "seq": recs[at]["seq"],
            "detail": f"{worst} checkpoint-save retries in "
                      f"{backoff_window} steps — the checkpoint store is "
                      f"flapping; step time is going to backoff sleeps"})
    return findings


# --------------------------------------------------------------------------- #
# No-op twins (the disabled path) + facades
# --------------------------------------------------------------------------- #


class _NullTracer:
    """Allocation-free stand-in: every recording method is a bare
    ``return None``. Query methods return empty containers (fresh lists —
    queries are off the hot path)."""

    __slots__ = ()
    clock = staticmethod(time.perf_counter)
    dropped = 0

    def set_meta(self, *a, **k):
        return None

    def begin(self, *a, **k):
        return None

    def end(self, *a, **k):
        return None

    def complete(self, *a, **k):
        return None

    def instant(self, *a, **k):
        return None

    def close(self, *a, **k):
        return None

    def open_spans(self, rid):
        return []

    def spans(self, rid=None):
        return []

    def rids(self):
        return []

    def chrome_events(self):
        return []

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return path

    def reset(self):
        return None


class _NullFlight:
    __slots__ = ()
    size = 0
    total = 0
    warm_progs: frozenset = frozenset()

    def record(self, *a, **k):
        return None

    def __len__(self):
        return 0

    def dump(self):
        return []

    def reset(self, *a, **k):
        return None


NULL_TRACER = _NullTracer()
NULL_FLIGHT = _NullFlight()


class ServingTelemetry:
    """The facade ``GenerationServer(telemetry=...)`` holds.

    The registry is ALWAYS real — counters behind ``sched_metrics()`` /
    TTFT-TPOT histograms cost host-dict updates and are the single source
    of truth regardless of ``enabled``. ``enabled`` gates the per-request
    span tracer and the per-tick flight recorder (swapped for shared
    no-op singletons when off, so the disabled hot path allocates
    nothing). Pass ``tracer=`` to share a timeline with another facade
    (e.g. a :class:`TrainTelemetry` in the same process — one chrome
    trace shows training steps and request lifecycles together).
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricsRegistry] = None,
                 flight_size: int = 256, max_samples: int = 8192,
                 max_spans: int = 65536,
                 tracer: Optional[SpanTracer] = None):
        self.clock = clock
        self.registry = registry if registry is not None else \
            MetricsRegistry(clock=clock, max_samples=max_samples)
        self.enabled = bool(enabled)
        if self.enabled:
            self.tracer: Any = tracer if tracer is not None else \
                SpanTracer(clock=clock, max_spans=max_spans)
            self.flight: Any = FlightRecorder(flight_size)
        else:
            self.tracer = NULL_TRACER
            self.flight = NULL_FLIGHT

    def watchdog(self, **kw) -> List[Dict[str, Any]]:
        kw.setdefault("warm_progs", self.flight.warm_progs)
        return watchdog(self.flight.dump(), **kw)

    def export_chrome_trace(self, path: str) -> str:
        return self.tracer.export_chrome_trace(path)

    def snapshot(self) -> Dict[str, Any]:
        """Registry JSON + watchdog findings (one post-mortem blob)."""
        return {"metrics": self.registry.to_json(),
                "watchdog": self.watchdog() if self.enabled else [],
                "flight_ticks": self.flight.total,
                "spans_dropped": getattr(self.tracer, "dropped", 0)}

    def reset(self, counters: bool = False) -> None:
        """Clear histograms, spans, and the flight ring (benchmark
        warmup boundary); surviving flight records' program keys fold
        into ``flight.warm_progs`` first, so the post-boundary watchdog
        neither excuses a warm program's recompile nor resurfaces a
        warmup compile as a finding. ``counters=True`` also zeroes
        counters/gauges — NOT the default, because ``sched_metrics()``
        counters are lifetime semantics."""
        if counters:
            self.registry.reset()
        else:
            self.registry.reset_histograms()
        self.tracer.reset()
        self.flight.reset(fold_warm=True)


# --------------------------------------------------------------------------- #
# Training tier: goodput ledger + TrainTelemetry facade
# --------------------------------------------------------------------------- #


class GoodputLedger:
    """Productive vs. total training wall time.

    ``step(index, wall_s)`` books one optimizer step; running the SAME
    index twice (replay after an elastic restore rolled the step counter
    back) books the earlier run's wall as lost work — only the last run
    of each index is productive. ``recovery(wall_s)`` books
    non-stepping wall the chaos harness attributes to a restart (kill
    detection → rendezvous → restore). The ratio is EXACTLY 1.0 on a
    fault-free run: no replayed index, no recovery segment, so
    productive == total with no float residue.
    """

    def __init__(self):
        self._step_wall: Dict[int, float] = {}
        self.total_s = 0.0
        self.lost_s = 0.0
        self.lost_steps = 0
        self.recovery_s = 0.0
        self.recoveries = 0

    def step(self, index: int, wall_s: float) -> None:
        prev = self._step_wall.get(index)
        if prev is not None:
            self.lost_steps += 1
            self.lost_s += prev
        self._step_wall[int(index)] = float(wall_s)
        self.total_s += float(wall_s)

    def recovery(self, wall_s: float) -> None:
        self.recoveries += 1
        self.recovery_s += float(wall_s)
        self.total_s += float(wall_s)

    @property
    def productive_s(self) -> float:
        return self.total_s - self.lost_s - self.recovery_s

    @property
    def steps(self) -> int:
        return len(self._step_wall)

    def ratio(self) -> float:
        if self.total_s <= 0.0:
            return 1.0
        if not self.lost_s and not self.recovery_s:
            return 1.0
        return self.productive_s / self.total_s

    def snapshot(self) -> Dict[str, Any]:
        return {"ratio": self.ratio(), "total_s": self.total_s,
                "productive_s": self.productive_s, "lost_s": self.lost_s,
                "lost_steps": self.lost_steps,
                "recovery_s": self.recovery_s,
                "recoveries": self.recoveries, "steps": self.steps}


class TrainTelemetry:
    """The facade ``ParallelEngine(telemetry=...)`` holds, shared with
    in the JAX package with ``TrainCheckpointer(telemetry=)``,
    ``CheckpointableDataFeed`` and ``ElasticChaosHarness`` (not ported
    yet; their hooks are here) so one object accumulates the whole loop.

    Mirrors :class:`ServingTelemetry`: the registry is always real,
    ``enabled`` swaps tracer/flight for the shared null singletons. The
    engine itself applies a stronger gate — ``telemetry=None`` (its
    default) skips timestamp reads AND the per-step synchronise of the
    loss that the ``device_wait`` span needs, so the un-instrumented hot
    path is unchanged.

    ``peak_flops`` feeds the MFU gauge via the dense-transformer
    estimate ``6 · model_params · tokens`` per step; it defaults from
    ``PT_PEAK_TFLOPS`` (TFLOP/s) and the gauge is skipped when unset —
    pass the peak of the device the engine runs on.
    ``model_params`` is stamped by the engine on the first recorded
    step. Pass ``tracer=`` to share a :class:`SpanTracer` with a
    :class:`ServingTelemetry` — training spans land on the reserved
    :data:`TRAIN_RID` row of the same chrome-trace timeline.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricsRegistry] = None,
                 flight_size: int = 512, max_samples: int = 8192,
                 max_spans: int = 65536,
                 tracer: Optional[SpanTracer] = None,
                 peak_flops: Optional[float] = None):
        self.clock = clock
        self.registry = registry if registry is not None else \
            MetricsRegistry(clock=clock, max_samples=max_samples)
        self.enabled = bool(enabled)
        if self.enabled:
            self.tracer: Any = tracer if tracer is not None else \
                SpanTracer(clock=clock, max_spans=max_spans)
            self.flight: Any = FlightRecorder(flight_size)
            self.tracer.set_meta(TRAIN_RID, name="train loop")
        else:
            self.tracer = NULL_TRACER
            self.flight = NULL_FLIGHT
        self.goodput = GoodputLedger()
        self.model_params = 0
        if peak_flops is None:
            peak_flops = float(os.environ.get("PT_PEAK_TFLOPS", "0")) * 1e12
        self.peak_flops = float(peak_flops)
        self._pending_feed_s = 0.0
        self._pending_ckpt_backoffs = 0
        # per-step instruments resolved once — record_step rides the train
        # hot path and registry get-or-create per call is measurable on
        # small models; reset() clears instruments in place, so cached
        # references stay valid across warmup-boundary resets
        r = self.registry
        self._h_step = r.histogram(
            "train_step_time_s", "wall per optimizer step (feed excluded)")
        self._c_steps = r.counter("train_steps", "optimizer steps recorded")
        self._c_tokens = r.counter("train_tokens_total", "tokens consumed")
        self._g_tps = r.gauge("train_tokens_per_s",
                              "throughput of the last recorded step")
        self._g_mfu = r.gauge("train_mfu",
                              "model FLOP utilization (6·N·T estimate)")
        self._g_goodput = r.gauge(
            "train_goodput_ratio",
            "productive step wall / total wall (1.0 = fault-free)")

    # -------------------------------------------------------------- hooks
    def record_data_feed(self, t0: float, t1: float, **args) -> None:
        """CheckpointableDataFeed hook: one ``data_feed`` span per batch;
        the duration also folds into the NEXT step's flight record so
        :func:`train_watchdog` can spot input-bound windows."""
        self.tracer.complete(TRAIN_RID, "data_feed", t0, t1, **args)
        self.registry.histogram(
            "train_data_feed_s", "host data-feed wall per batch") \
            .observe(t1 - t0)
        self._pending_feed_s += (t1 - t0)

    def record_ckpt(self, name: str, t0: float, t1: float, **args) -> None:
        """TrainCheckpointer hook: ``name`` is ``ckpt_save`` or
        ``ckpt_restore``; spans share the train timeline row."""
        self.tracer.complete(TRAIN_RID, name, t0, t1, **args)
        self.registry.histogram(
            f"train_{name}_s", f"{name} wall (synchronous portion)") \
            .observe(t1 - t0)

    def note_ckpt_backoff(self, **args) -> None:
        """TrainCheckpointer retry hook: counts toward the next flight
        record so ``ckpt_backoff_storm`` is detectable from the ring."""
        self._pending_ckpt_backoffs += 1
        self.tracer.instant(TRAIN_RID, "ckpt_backoff", **args)

    def record_step(self, *, step: int, prog: Optional[str], tokens: int,
                    t0: float, t_h2d: float, t_dispatch: float,
                    t_wait: float, compiles: int = 0) -> None:
        """Engine hook: one optimizer step's phase timestamps. Emits the
        nested spans, the step gauges/histograms, the flight record, and
        the goodput booking (replayed ``step`` indices become lost work)."""
        wall = t_wait - t0
        tr = self.tracer
        tr.complete(TRAIN_RID, "train_step", t0, t_wait,
                    step=step, tokens=tokens)
        tr.complete(TRAIN_RID, "host_to_device", t0, t_h2d, step=step)
        tr.complete(TRAIN_RID, "dispatch", t_h2d, t_dispatch, step=step)
        tr.complete(TRAIN_RID, "device_wait", t_dispatch, t_wait, step=step)

        self._h_step.observe(wall)
        self._c_steps.inc()
        self._c_tokens.inc(tokens)
        if wall > 0:
            self._g_tps.set(tokens / wall)
            if self.peak_flops and self.model_params:
                mfu = (6.0 * self.model_params * tokens / wall) \
                    / self.peak_flops
                self._g_mfu.set(mfu)

        feed_s = self._pending_feed_s
        self._pending_feed_s = 0.0
        backoffs = self._pending_ckpt_backoffs
        self._pending_ckpt_backoffs = 0
        self.flight.record(step=step, prog=prog, t_wall_s=wall,
                           h2d_s=t_h2d - t0, dispatch_s=t_dispatch - t_h2d,
                           wait_s=t_wait - t_dispatch, data_feed_s=feed_s,
                           tokens=tokens, recompiles=compiles,
                           ckpt_backoffs=backoffs)

        self.goodput.step(step, wall)
        self._g_goodput.set(self.goodput.ratio())

    def record_recovery(self, t0: float, t1: float, **args) -> None:
        """ElasticChaosHarness hook: one restart's non-stepping wall
        (kill detection → rendezvous → restore), booked against goodput."""
        self.tracer.complete(TRAIN_RID, "recovery", t0, t1, **args)
        self.goodput.recovery(t1 - t0)
        r = self.registry
        r.counter("train_recoveries", "elastic restarts recovered").inc()
        r.histogram("train_recovery_s", "restart recovery wall") \
            .observe(t1 - t0)
        self._g_goodput.set(self.goodput.ratio())

    # ------------------------------------------------------------ queries
    def watchdog(self, **kw) -> List[Dict[str, Any]]:
        kw.setdefault("warm_progs", self.flight.warm_progs)
        return train_watchdog(self.flight.dump(), **kw)

    def export_chrome_trace(self, path: str) -> str:
        return self.tracer.export_chrome_trace(path)

    def snapshot(self) -> Dict[str, Any]:
        return {"metrics": self.registry.to_json(),
                "watchdog": self.watchdog() if self.enabled else [],
                "goodput": self.goodput.snapshot(),
                "flight_ticks": self.flight.total,
                "spans_dropped": getattr(self.tracer, "dropped", 0)}

    def reset(self, counters: bool = False) -> None:
        """Warmup-boundary reset, mirroring
        :meth:`ServingTelemetry.reset` (warm program keys fold into the
        flight ring). The goodput ledger also restarts — goodput is a
        per-measured-run statistic."""
        if counters:
            self.registry.reset()
        else:
            self.registry.reset_histograms()
        self.tracer.reset()
        self.flight.reset(fold_warm=True)
        self.goodput = GoodputLedger()
        self._pending_feed_s = 0.0
        self._pending_ckpt_backoffs = 0
