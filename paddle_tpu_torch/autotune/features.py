"""Feature extraction: telemetry snapshot -> one flat trial vector —
port of ``paddle_tpu/autotune/features.py`` over the port's
``ServingTelemetry`` (the same registry, flight ring and watchdog).

The telemetry substrate already measures everything a serving cost model
wants — the registry holds TTFT/TPOT percentiles and pressure counters,
the flight ring holds per-tick occupancy/recompile/spec deltas, and the
watchdog classifies pathologies. :class:`FeatureVector` is the single
flattened view of all three that the autotuner stores per trial, feeds
to calibration (``cost.py``), and tabulates (``telemetry_dump``).

Throughput (tokens/seconds) is supplied by the trial runner — the
registry never sees the runner's measured wall window, only latencies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence


def _mean(xs: Sequence[float]) -> float:
    return float(sum(xs) / len(xs)) if xs else 0.0


@dataclasses.dataclass(frozen=True)
class FeatureVector:
    """One measured trial, flattened. ``None`` means "not observed"
    (e.g. acceptance without speculation), never "zero"."""

    # throughput (runner-measured wall window)
    tokens: int = 0
    seconds: float = 0.0
    tok_s: float = 0.0
    # latency percentiles (registry histograms, post-warmup)
    ttft_p50_s: Optional[float] = None
    ttft_p95_s: Optional[float] = None
    tpot_p50_ms: Optional[float] = None
    tpot_p95_ms: Optional[float] = None
    # per-tick flight aggregates
    ticks: int = 0
    mean_decoding: float = 0.0
    occupancy: float = 0.0          # mean decoding / slots_total (if known)
    mean_blocks_in_use: float = 0.0
    mean_queue_depth: float = 0.0
    # pressure + stability totals over the flight window
    preemptions: int = 0
    stalls: int = 0
    swap_out_blocks: int = 0
    swap_in_blocks: int = 0
    recompiles: int = 0
    # speculation over the flight window
    spec_proposed: int = 0
    spec_accepted: int = 0
    acceptance: Optional[float] = None   # accepted / proposed per window
    # watchdog verdicts ("preemption_storm", "steady_state_recompile", ...)
    watchdog_kinds: tuple = ()

    @property
    def clean(self) -> bool:
        """No watchdog finding — the trial is admissible as a winner."""
        return not self.watchdog_kinds

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["watchdog_kinds"] = list(self.watchdog_kinds)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FeatureVector":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["watchdog_kinds"] = tuple(kw.get("watchdog_kinds", ()))
        return cls(**kw)


def extract(telemetry, *, tokens: int, seconds: float,
            records: Optional[List[Dict[str, Any]]] = None,
            findings: Optional[List[Dict[str, Any]]] = None) \
        -> FeatureVector:
    """Flatten a post-run ``ServingTelemetry`` into a
    :class:`FeatureVector`.

    ``records``/``findings`` override the live flight dump / watchdog
    pass — the benchmark already ran both and the flight ring may have
    wrapped since. ``tokens``/``seconds`` are the runner's measured
    window (percentiles cover the same window because the runner resets
    histograms at the warmup boundary).
    """
    reg = telemetry.registry
    recs = telemetry.flight.dump() if records is None else records
    finds = telemetry.watchdog() if findings is None else findings

    decoding = [float(r.get("decoding", 0)) for r in recs]
    slots_total = None
    g = reg.get("serving_slots_total")
    if g is not None and g.total():
        slots_total = g.total()
    mean_dec = _mean(decoding)

    proposed = int(sum(r.get("spec_proposed", 0) for r in recs))
    accepted = int(sum(r.get("spec_accepted", 0) for r in recs))
    # acceptance per verify window, the gate_low unit — windows are the
    # ticks that actually proposed drafts
    windows = sum(1 for r in recs if r.get("spec_proposed", 0) > 0)
    acceptance = (accepted / windows) if windows else None

    return FeatureVector(
        tokens=int(tokens),
        seconds=float(seconds),
        tok_s=(tokens / seconds) if seconds > 0 else 0.0,
        ttft_p50_s=reg.percentile("serving_ttft_s", 50.0),
        ttft_p95_s=reg.percentile("serving_ttft_s", 95.0),
        tpot_p50_ms=reg.percentile("serving_tpot_ms", 50.0),
        tpot_p95_ms=reg.percentile("serving_tpot_ms", 95.0),
        ticks=len(recs),
        mean_decoding=mean_dec,
        occupancy=(mean_dec / slots_total) if slots_total else mean_dec,
        mean_blocks_in_use=_mean([float(r.get("blocks_in_use", 0))
                                  for r in recs]),
        mean_queue_depth=_mean([float(r.get("queue_depth", 0))
                                for r in recs]),
        preemptions=int(sum(r.get("preemptions", 0) for r in recs)),
        stalls=int(sum(r.get("stalls", 0) for r in recs)),
        swap_out_blocks=int(sum(r.get("swap_out_blocks", 0) for r in recs)),
        swap_in_blocks=int(sum(r.get("swap_in_blocks", 0) for r in recs)),
        recompiles=int(sum(r.get("recompiles", 0) for r in recs)),
        spec_proposed=proposed,
        spec_accepted=accepted,
        acceptance=acceptance,
        watchdog_kinds=tuple(sorted({f.get("kind", "?") for f in finds})),
    )
