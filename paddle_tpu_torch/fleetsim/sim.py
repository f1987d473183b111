"""Discrete-event fleet simulation + real-fleet slice replay — port of
``paddle_tpu/fleetsim/sim.py`` (the same event order and arithmetic: the
same report, byte for byte as JSON, at the same seed).

:class:`FleetSimulation` runs a drawn :class:`~.traffic.SessionTrace`
— typically a million-session day — against an *analytic* replica
service model in virtual time: arrivals route with the same
preferences the real router has (prefix-population affinity, then
load), sessions occupy slots for a prefill+decode service time derived
from a capacity number (a cost model's, or a measured one), queueing
and TTFT/TPOT fall out of the event order, and the
:class:`~..inference.autoscale.ElasticAutoscaler`
runs a control tick on a fixed cadence exactly as a live control loop
would (observed windowed demand + the diurnal forecast + windowed SLO
burn). One million arrivals complete in well under CI budget because
each event is a few dict operations — no engine, no tensors.

Why analytic? A day of real engine traffic is ~10^9 model steps; no CI
runs that. The split mirrors the autotuner's: the *model* explores the
big space (here: a whole day of elasticity), and a *measured slice*
anchors it — :func:`replay_slice` materializes the first N sessions of
the SAME trace into real prompts and pushes them through a real
:class:`~..inference.fleet.FleetRouter` (in-process or subprocess
replicas) in fast-time, where token-exactness, drains and kills are
checked against an undisturbed twin (``chip_smoke.py`` phase 37 (d)
runs one on the card, over subprocess replicas with a kill).

Everything is a pure function of (trace, model, policy): no wall
clock, no sleeps, no unseeded randomness — two runs at one
seed emit byte-identical reports (floats rounded once, at the edge).
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..inference.autoscale import ElasticAutoscaler
from ..inference.fleet import DEFAULT_SLO
from .traffic import SessionTrace, expected_session_rate

__all__ = ["FleetSimulation", "ReplicaServiceModel", "replay_slice"]


@dataclass(frozen=True)
class ReplicaServiceModel:
    """Analytic single-replica service rates — the sim's stand-in for
    one engine, sized from the cost model so the sim and the live
    autoscaler plan with the SAME capacity number."""

    decode_tok_s: float          # aggregate new-token throughput
    prefill_tok_s: float         # prompt-token prefill throughput
    slots: int                   # concurrent sessions per replica
    spawn_delay_s: float = 20.0  # scale-up lead time (boot + compile)

    def __post_init__(self) -> None:
        if self.decode_tok_s <= 0 or self.prefill_tok_s <= 0:
            raise ValueError("service rates must be > 0")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")

    @classmethod
    def from_cost_model(cls, cost_model, config, workload, *,
                        prefill_ratio: float = 8.0,
                        spawn_delay_s: float = 20.0
                        ) -> "ReplicaServiceModel":
        """Derive rates from a cost model — the autotuner's
        :class:`~paddle_tpu_torch.autotune.ServingCostModel` (or any object
        with ``capacity_tok_s(config, workload)`` and ``max_batch``):
        decode capacity is the model's ``capacity_tok_s`` prediction; prefill
        runs ``prefill_ratio`` times faster per token (chunked prefill
        is compute-dense where decode is trip-bound)."""
        tok_s = float(cost_model.capacity_tok_s(config, workload))
        return cls(decode_tok_s=tok_s,
                   prefill_tok_s=prefill_ratio * tok_s,
                   slots=int(cost_model.max_batch),
                   spawn_delay_s=float(spawn_delay_s))


class _SimReplica:
    __slots__ = ("idx", "spawned_t", "ready_t", "retired_t", "state",
                 "busy", "queue", "populations", "served")

    def __init__(self, idx: int, now: float, ready_t: float):
        self.idx = idx
        self.spawned_t = now
        self.ready_t = ready_t
        self.retired_t: Optional[float] = None
        self.state = "live"            # live | draining | retired
        self.busy = 0
        self.queue: deque = deque()    # session indices waiting
        self.populations: set = set()  # prefix populations seen
        self.served = 0


class FleetSimulation:
    """One seeded day of traffic against the analytic fleet (see
    module docstring). ``run()`` returns the JSON-able report."""

    def __init__(self, trace: SessionTrace, model: ReplicaServiceModel,
                 *, autoscaler: Optional[ElasticAutoscaler] = None,
                 initial_replicas: int = 1,
                 control_interval_s: float = 60.0,
                 forecast_horizon_s: float = 900.0,
                 slo: Optional[Dict[str, float]] = None):
        if initial_replicas < 1:
            raise ValueError("initial_replicas must be >= 1")
        self.trace = trace
        self.model = model
        self.autoscaler = autoscaler
        self.initial_replicas = int(initial_replicas)
        self.control_interval_s = float(control_interval_s)
        self.forecast_horizon_s = float(forecast_horizon_s)
        self.slo = dict(DEFAULT_SLO, **(slo or {}))

    # ------------------------------------------------------------ mechanics
    def _admit(self, rep: _SimReplica, i: int, now: float) -> None:
        """Start service for session ``i`` on ``rep`` (a slot is free).
        Service time = prefill of the non-cached prompt + max_new
        decode steps at the replica's per-slot rate under its load at
        admission."""
        spec = self.trace.spec
        pop = self._population[i]
        plen = self._prompt_len[i]
        hit = pop in rep.populations
        rep.populations.add(pop)
        eff_prompt = plen - min(spec.shared_prefix_tokens, plen - 1) \
            if hit else plen
        rep.busy += 1
        prefill_s = eff_prompt / self.model.prefill_tok_s
        per_tok_s = rep.busy / self.model.decode_tok_s
        ttft = (now - self._t[i]) + prefill_s
        tpot_ms = per_tok_s * 1000.0
        done_t = now + prefill_s + self._max_new[i] * per_tok_s
        ten = self._tenant[i]
        row = self._tenant_stats[ten]
        row[0] += 1
        wrow = self._window_stats[ten]
        wrow[0] += 1
        if ttft > self.slo["ttft_s"]:
            row[1] += 1
            wrow[1] += 1
        if tpot_ms > self.slo["tpot_ms"]:
            row[2] += 1
            wrow[2] += 1
        if hit:
            self._prefix_hits += 1
        self._ttft_sum += ttft
        self._tokens_served += plen + self._max_new[i]
        self._order += 1
        heapq.heappush(self._events,
                       (done_t, self._order, "complete", rep.idx))

    def _route(self, i: int, now: float) -> None:
        """Mirror the real router's preference order: a ready replica
        with a free slot that has seen this session's prefix
        population, else the freest ready replica, else queue on the
        shortest backlog."""
        pop = self._population[i]
        ready = [r for r in self._replicas
                 if r.state == "live" and r.ready_t <= now]
        if not ready:
            # every replica still booting/draining: queue on the one
            # that will be ready first (fleet can never be empty)
            candidates = [r for r in self._replicas
                          if r.state != "retired"]
            rep = min(candidates, key=lambda r: (r.ready_t, r.idx))
            rep.queue.append(i)
            self._queued_peak = max(
                self._queued_peak, sum(len(r.queue)
                                       for r in self._replicas))
            return
        free = [r for r in ready if r.busy < self.model.slots]
        if free:
            affine = [r for r in free if pop in r.populations]
            rep = min(affine or free,
                      key=lambda r: (r.busy + len(r.queue), r.idx))
            self._admit(rep, i, now)
            return
        rep = min(ready, key=lambda r: (r.busy + len(r.queue), r.idx))
        rep.queue.append(i)
        self._queued_peak = max(
            self._queued_peak,
            sum(len(r.queue) for r in self._replicas))

    def _complete(self, rep: _SimReplica, now: float) -> None:
        rep.busy -= 1
        rep.served += 1
        self._completed += 1
        if rep.queue and rep.state == "live":
            self._admit(rep, rep.queue.popleft(), now)
        elif rep.state == "draining" and rep.busy == 0 \
                and not rep.queue:
            self._retire(rep, now)

    def _retire(self, rep: _SimReplica, now: float) -> None:
        rep.state = "retired"
        rep.retired_t = now
        self._replica_hours += (now - rep.spawned_t) / 3600.0

    def _spawn(self, now: float) -> None:
        rep = _SimReplica(len(self._replicas), now,
                          now + self.model.spawn_delay_s)
        self._replicas.append(rep)
        self._peak_replicas = max(
            self._peak_replicas,
            sum(1 for r in self._replicas if r.state != "retired"))

    def _drain(self, now: float) -> None:
        """Token-exact scale-down, sim-side: victim stops routing, its
        queue migrates to peers immediately (the evacuate/admit path),
        its in-service sessions finish, then it retires."""
        live = [r for r in self._replicas
                if r.state == "live" and r.ready_t <= now]
        if len(live) <= 1:
            return
        victim = min(live, key=lambda r: (r.busy + len(r.queue),
                                          -r.idx))
        victim.state = "draining"
        moved = list(victim.queue)
        victim.queue.clear()
        self._migrated += len(moved)
        for i in moved:
            self._route(i, now)
        if victim.busy == 0:
            self._retire(victim, now)

    def _worst_window_burn(self) -> float:
        budget = max(1e-9, 1.0 - float(self.slo["target"]))
        worst = 0.0
        for count, tviol, pviol in self._window_stats.values():
            if count:
                worst = max(worst, max(tviol, pviol) / count / budget)
        return worst

    def _control(self, now: float) -> None:
        """One autoscaler control tick: observed windowed token demand,
        the diurnal forecast at ``now + horizon``, windowed burn."""
        if self.autoscaler is None:
            return
        dt = self.control_interval_s
        demand = self._window_tokens / dt
        forecast = (expected_session_rate(self.trace.spec,
                                          now + self.forecast_horizon_s)
                    * self.trace.mean_tokens)
        live = sum(1 for r in self._replicas
                   if r.state == "live")
        d = self.autoscaler.decide(now, live=live,
                                   demand_tok_s=demand,
                                   forecast_tok_s=forecast,
                                   burn_rate=self._worst_window_burn())
        if d.action == "up":
            for _ in range(d.count):
                self._spawn(now)
        elif d.action == "down":
            self._drain(now)
        self._window_tokens = 0.0
        for row in self._window_stats.values():
            row[0] = row[1] = row[2] = 0

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, Any]:
        trace = self.trace
        spec = trace.spec
        n = len(trace)
        # python lists: ~5x faster scalar reads than numpy in the loop
        # (host numpy traffic arrays, never device tensors)
        self._t = trace.t.tolist()
        self._tenant = trace.tenant.tolist()
        self._population = trace.population.tolist()
        self._prompt_len = trace.prompt_len.tolist()
        self._max_new = trace.max_new.tolist()

        self._replicas: List[_SimReplica] = []
        self._events: List = []
        self._order = 0
        self._completed = 0
        self._migrated = 0
        self._queued_peak = 0
        self._prefix_hits = 0
        self._ttft_sum = 0.0
        self._tokens_served = 0
        self._replica_hours = 0.0
        self._peak_replicas = 0
        self._window_tokens = 0.0
        self._tenant_stats = {t: [0, 0, 0]        # [count, ttft_v, tpot_v]
                              for t in range(spec.tenants)}
        self._window_stats = {t: [0, 0, 0]
                              for t in range(spec.tenants)}
        for _ in range(self.initial_replicas):
            self._spawn(0.0)
            self._replicas[-1].ready_t = 0.0      # day starts warm

        if self.autoscaler is not None:
            self._order += 1
            heapq.heappush(self._events,
                           (self.control_interval_s, self._order,
                            "control", -1))

        ai = 0
        now = 0.0
        while ai < n or self._events:
            if self._events and (ai >= n
                                 or self._events[0][0] <= self._t[ai]):
                now, _, kind, idx = heapq.heappop(self._events)
                if kind == "complete":
                    self._complete(self._replicas[idx], now)
                else:
                    self._control(now)
                    if ai < n or any(r.busy or r.queue
                                     for r in self._replicas):
                        self._order += 1
                        heapq.heappush(
                            self._events,
                            (now + self.control_interval_s,
                             self._order, "control", -1))
            else:
                now = self._t[ai]
                self._window_tokens += (self._prompt_len[ai]
                                        + self._max_new[ai])
                self._route(ai, now)
                ai += 1

        end = max(now, spec.day_s)
        for rep in self._replicas:
            if rep.state != "retired":
                self._replica_hours += (end - rep.spawned_t) / 3600.0

        return self._report(end)

    # --------------------------------------------------------------- report
    def _report(self, end: float) -> Dict[str, Any]:
        spec = self.trace.spec
        budget = max(1e-9, 1.0 - float(self.slo["target"]))
        slo_rows: Dict[str, Any] = {}
        attained = True
        for t in sorted(self._tenant_stats):
            count, tviol, pviol = self._tenant_stats[t]
            if not count:
                continue
            row = {"sessions": count}
            for key, viol in (("ttft", tviol), ("tpot", pviol)):
                att = 1.0 - viol / count
                row[key] = {"attainment": round(att, 6),
                            "burn_rate": round(viol / count / budget, 6),
                            "violations": viol}
                attained = attained and att >= float(self.slo["target"])
            slo_rows[f"t{t}"] = row

        # static twin, analytically: a fleet sized for the diurnal PEAK
        # runs that many replicas all day
        peak_demand = (spec.sessions / spec.day_s
                       * (1.0 + spec.diurnal_amplitude)
                       * self.trace.mean_tokens)
        if self.autoscaler is not None:
            util = self.autoscaler.policy.target_utilization
            cap = self.autoscaler.capacity_tok_s
            events = [d.as_dict() for d in self.autoscaler.events]
            for ev in events:
                for k in ("t", "demand_tok_s", "forecast_tok_s",
                          "burn_rate"):
                    ev[k] = round(ev[k], 6)
            ups = sum(1 for d in self.autoscaler.events
                      if d.action == "up")
            downs = sum(1 for d in self.autoscaler.events
                        if d.action == "down")
        else:
            util = 0.75
            cap = self.model.decode_tok_s
            events, ups, downs = [], 0, 0
        static_replicas = max(1, int(math.ceil(
            peak_demand / (cap * util))))
        static_hours = static_replicas * end / 3600.0

        return {
            "sim_sessions": len(self.trace),
            "sim_virtual_hours": round(end / 3600.0, 6),
            "replica_hours": round(self._replica_hours, 6),
            "static_replicas": static_replicas,
            "static_replica_hours": round(static_hours, 6),
            "elastic_beats_static": bool(
                self._replica_hours < static_hours),
            "peak_replicas": self._peak_replicas,
            "replicas_spawned": len(self._replicas),
            "completed": self._completed,
            "migrated": self._migrated,
            "queued_peak": self._queued_peak,
            "prefix_hit_sessions": self._prefix_hits,
            "tokens_served": int(self._tokens_served),
            "mean_ttft_s": round(
                self._ttft_sum / max(1, self._completed), 6),
            "autoscale_events": events,
            "autoscale_event_count": len(events),
            "scale_ups": ups,
            "scale_downs": downs,
            "slo": slo_rows,
            "slo_attained": bool(attained),
            "slo_target": float(self.slo["target"]),
            "traffic_signature": self.trace.signature(),
        }


def replay_slice(trace: SessionTrace, fleet: Any, *, sessions: int,
                 clock: Any, compress: float = 1000.0,
                 tick_s: float = 0.25, max_len: Optional[int] = None,
                 max_new_cap: Optional[int] = None,
                 on_tick: Optional[Callable[[int, float, int], None]]
                 = None) -> Dict[str, Any]:
    """Replay the first ``sessions`` of ``trace`` through a REAL
    :class:`~..inference.fleet.FleetRouter` in fast-time: arrival times
    compress by ``compress``×, the shared ``clock`` (a
    :class:`~.clock.VirtualClock` the router was built on) advances
    ``tick_s`` per router step, and sessions submit the moment virtual
    now passes their compressed arrival. ``on_tick(tick_no, now,
    submitted)`` runs after every router step — the seam a
    harness uses for mid-run kills and autoscaler control.

    Returns ``{"rids": [...in submit order], "results": {rid:
    tokens}, "ticks": int}`` — token streams ready to fingerprint
    against an undisturbed twin."""
    from .traffic import materialize_session

    n = min(int(sessions), len(trace))
    t0 = float(trace.t[0]) if n else 0.0
    arrivals = [(float(trace.t[i]) - t0) / compress for i in range(n)]
    rids: List[int] = []
    si = 0
    ticks = 0
    while True:
        now = clock()
        while si < n and arrivals[si] <= now:
            r = materialize_session(trace, si, max_len=max_len)
            new = (min(r.max_new, max_new_cap) if max_new_cap
                   else r.max_new)
            rids.append(fleet.submit(list(r.prompt), max_new_tokens=new,
                                     tenant=r.tenant))
            si += 1
        remaining = fleet.step()
        ticks += 1
        clock.advance(tick_s)
        if on_tick is not None:
            on_tick(ticks, now, si)
        if si >= n and remaining == 0:
            break
    results = fleet.run()
    return {"rids": rids, "results": results, "ticks": ticks}
