"""Fleet-scale serving: N engines behind one router — port of
``paddle_tpu/inference/fleet.py`` (host code only: the router touches no
tensor; KV payloads pass through it as the servers' snapshots carry them).

A :class:`FleetRouter` composes N unmodified
:class:`~.serving.GenerationServer` replicas — bare in-process servers
or :mod:`~.transport` handles fronting other OS processes; the router
only speaks the shared duck-typed surface — into a *service* that
survives replica loss: scale by composing the same program, not by
writing a new one.
Three mechanisms, all host-side:

- **prefix-aware routing** — each submission is scored against every
  eligible replica: chained-hash prefix overlap from the allocator's
  content-addressed cache (``BlockAllocator.probe_prefix``, a read-only
  walk that takes no refs) blended with load (queue depth + occupied
  slots from ``load_metrics()``) and admission headroom. Routing is a
  *hint*: a misroute costs prefix reuse, never correctness — which is
  what the ``route`` fault site proves.

- **health-checked membership** — per-replica liveness is driven by
  tick-progress heartbeats (``GenerationServer.steps`` must advance
  while the replica holds work) plus periodic flight-recorder watchdog
  probes, against an injectable clock. States move ``live → degraded →
  draining → dead``: degraded replicas are deprioritized by routing and
  recover after a cooldown; wedged or crashed replicas are killed and
  salvaged.

- **live token-exact migration** — ``drain()`` captures a replica via
  ``snapshot()``/``evacuate()`` and re-admits every in-flight request on
  peers through the normal restore/swap-in path
  (``GenerationServer.admit_migrated``): KV payloads ride CRC-checked
  into the peer's host pool and resume via the swap-in path (which
  captures no CUDA graph); a payload corrupted in transit (the
  ``migrate_payload``
  fault site) degrades to token-exact re-prefill. A replica killed
  mid-decode (``replica_down``) is salvaged from host state only
  (``snapshot(trust_kv=False)``) — its requests re-enter peers through
  the re-prefill rung (the prompt by chunked prefill, the generated
  tokens rebuilt through the decode program), so greedy outputs stay
  identical to an undisturbed single-engine run: every decode product is
  batch-invariant, so a request's tokens do not depend on the replica or
  the batchmates it decodes with, provided every replica shares the
  single engine's ``max_len``, ``block_size``, ``prefill_chunk`` and
  ``tick_window``.

Replicas get disjoint rid spaces (``set_rid_base``) so a migrated
request can never collide with a peer's own; the router's rid IS the
replica rid, so results map back without translation. Rids reach
``idx * 2**32`` and stay host Python ints: no rid enters a device buffer
or a graph input.

**Disaggregated prefill/decode fleets** (ROADMAP: multi-chip serving):
replicas constructed with ``role="prefill"`` / ``role="decode"`` split
the fleet into two classes. Fresh submissions route only among the
prefill-capable class; a prefill replica runs chunked prefill, samples
the first token, parks the request (``handoff_ready``), and the
router's per-tick sweep moves it to the decode class over the SAME
CRC-verified ``evacuate(trust_kv=True, rids=...)``/``admit_migrated``
path every other migration uses — no bespoke handoff channel. Decode
replicas refuse nothing (they can re-prefill a salvaged prompt), but a
prefill replica refuses decode-phase admits at the door, so a misroute
fails loudly instead of wedging. When a prefill replica dies
mid-chunk, its requests salvage onto the decode class through the
usual host-state replay rung — token output stays identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..faults import NULL_INJECTOR, EngineFailedError, FaultInjector
from .scheduler import AdmissionError

__all__ = [
    "FleetRouter", "ReplicaInfo",
    "REPLICA_LIVE", "REPLICA_DEGRADED", "REPLICA_DRAINING", "REPLICA_DEAD",
    "RID_STRIDE",
]

REPLICA_LIVE = "live"
REPLICA_DEGRADED = "degraded"
REPLICA_DRAINING = "draining"
REPLICA_DEAD = "dead"

#: Each replica's rid counter starts at ``idx * RID_STRIDE`` — wide
#: enough that no replica can ever walk into a peer's space.
RID_STRIDE = 1 << 32


@dataclass
class ReplicaInfo:
    """Router-side record for one managed engine."""

    idx: int
    server: Any
    state: str = REPLICA_LIVE
    # replica class ("any" | "prefill" | "decode") — copied from the
    # engine's role at construction and NEVER mutated by health
    # transitions: a degraded prefill replica recovers as a prefill
    # replica
    role: str = "any"
    # heartbeat state (router clock / engine step counter)
    last_progress_t: float = 0.0
    last_steps: int = 0
    last_remaining: int = 0
    # last observation freshness marker from a transport-aware handle
    # (``progress_seq``); -1 = never observed, so the first sample is
    # always treated as fresh
    last_seq: int = -1
    stall_ticks: int = 0
    degraded_t: float = 0.0
    last_findings: int = 0
    # (clock, state) transition log — the observable state machine
    history: List[Tuple[float, str]] = field(default_factory=list)


#: default per-tenant latency objectives for the SLO roll-up. A request
#: "attains" when its TTFT / TPOT lands at or under the objective;
#: ``target`` is the attainment goal, so the error budget is
#: ``1 - target`` and ``burn_rate = violating_fraction / (1 - target)``
#: — 1.0 means the tenant is consuming its budget exactly, > 1.0 means
#: the budget will exhaust before the window rolls over. ``window`` is
#: the rolling per-tenant sample count the roll-up looks back over.
DEFAULT_SLO = {"ttft_s": 1.0, "tpot_ms": 200.0, "target": 0.95,
               "window": 256}


class FleetRouter:
    """Prefix-aware, health-checked router over in-process replicas.

    Usage::

        fleet = FleetRouter([srv0, srv1])
        rid = fleet.submit([1, 5, 9], max_new_tokens=16)
        out = fleet.run()          # drain all replicas
        tokens = out[rid]

    ``servers`` must be FRESH (nothing submitted), paged, and
    configuration-homogeneous — the same compiled-shape fingerprint
    everywhere is what makes any replica a valid migration target for
    any other. All timing flows through ``clock`` (injectable; default
    ``time.monotonic``) so chaos replays stay deterministic.
    """

    def __init__(self, servers: Sequence[Any], *,
                 clock: Callable[[], float] = time.monotonic,
                 faults: Optional[FaultInjector] = None,
                 registry=None,
                 prefix_weight: float = 1.0,
                 load_weight: Optional[float] = None,
                 degraded_penalty: float = 1e6,
                 probe_every: int = 16,
                 stall_ticks_degraded: int = 8,
                 stall_ticks_dead: int = 64,
                 heartbeat_timeout_s: Optional[float] = None,
                 degrade_cooldown_s: float = 0.0,
                 slos: Optional[Dict[str, Dict[str, float]]] = None):
        if not servers:
            raise ValueError("FleetRouter needs at least one server")
        if faults is None:
            self._faults = NULL_INJECTOR
        elif isinstance(faults, FaultInjector):
            self._faults = faults
        else:
            raise ValueError(
                f"faults must be None or a FaultInjector, got {faults!r}")
        self.faults = self._faults
        self._clock = clock
        want = None
        for i, srv in enumerate(servers):
            if srv.cache_mode != "paged":
                raise ValueError(
                    f"replica {i} has cache={srv.cache_mode!r} — fleet "
                    f"migration needs the paged per-request KV capture")
            fp = dict(srv._snapshot_fingerprint())
            fp.pop("num_blocks")  # may differ; restore checks >= per move
            if want is None:
                want = fp
            elif fp != want:
                raise ValueError(
                    f"replica {i} config differs from replica 0 — fleet "
                    f"replicas must be homogeneous so any replica can "
                    f"receive any migration ({fp!r} vs {want!r})")
            srv.set_rid_base(i * RID_STRIDE)
        #: the fleet's homogeneity fingerprint (num_blocks excluded) —
        #: every later ``add_replica`` must match it exactly
        self._fp_want = want
        roles = [getattr(srv, "role", "any") for srv in servers]
        #: True when any replica declared a class — the fleet then runs
        #: disaggregated: submissions route to the prefill class, the
        #: per-tick handoff sweep moves finished prefills to decode.
        self.disagg = any(r != "any" for r in roles)
        if self.disagg:
            if not any(r in ("prefill", "any") for r in roles):
                raise ValueError(
                    "disaggregated fleet has no prefill-capable replica "
                    "— nothing could ever accept a submission")
            if not any(r in ("decode", "any") for r in roles):
                raise ValueError(
                    "disaggregated fleet has no decode-capable replica "
                    "— finished prefills would park forever")
        now = self._clock()
        self._replicas = [ReplicaInfo(idx=i, server=srv, role=roles[i],
                                      last_progress_t=now,
                                      history=[(now, REPLICA_LIVE)])
                          for i, srv in enumerate(servers)]
        self.prefix_weight = float(prefix_weight)
        self.load_weight = (float(load_weight) if load_weight is not None
                            else float(servers[0].block_size))
        self.degraded_penalty = float(degraded_penalty)
        self.probe_every = int(probe_every)
        self.stall_ticks_degraded = int(stall_ticks_degraded)
        self.stall_ticks_dead = int(stall_ticks_dead)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.degrade_cooldown_s = float(degrade_cooldown_s)
        self._ticks = 0
        self._home: Dict[int, int] = {}        # rid -> replica idx
        self._results: Dict[int, List[int]] = {}
        self._dropped: Dict[int, str] = {}
        # per-request migration latency samples (seconds on the injected
        # clock), covering evacuate→absorb→admit for handoffs, drains and
        # failovers alike; bounded so a long-lived router can't grow it
        self._migration_lat: List[float] = []
        self._migration_lat_cap = 4096
        self._handoff_requests = 0
        if registry is None:
            from .telemetry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._c_routed = registry.counter(
            "fleet_requests_routed",
            "submissions routed to a replica (replica label)")
        self._c_misroutes = registry.counter(
            "fleet_route_misroutes",
            "submissions deliberately misrouted by an injected route fault")
        self._c_migrated = registry.counter(
            "fleet_migrated_requests",
            "requests re-admitted on a peer (phase label: kv/queued)")
        self._c_migrations = registry.counter(
            "fleet_migrations",
            "replica evacuations performed (reason label: drain/failover)")
        self._c_deaths = registry.counter(
            "fleet_replica_deaths",
            "replicas removed from membership (reason label)")
        self._c_drains = registry.counter(
            "fleet_drains", "graceful drains completed")
        self._c_corrupt = registry.counter(
            "fleet_migrate_corruptions",
            "migrating payloads corrupted in transit (injected; the "
            "receiver's CRC check downgrades each to re-prefill)")
        self._c_degraded = registry.counter(
            "fleet_degraded_events",
            "live->degraded transitions (kind label)")
        self._c_stalls = registry.counter(
            "fleet_heartbeat_stalls",
            "router ticks a replica held work without progressing")
        self._c_quarantined = registry.counter(
            "fleet_quarantined_requests",
            "requests with no surviving migration target (terminal)")
        self._c_handoffs = registry.counter(
            "fleet_prefill_handoffs",
            "prefill→decode handoff sweeps performed (replica label)")
        self._c_warm_migrated = registry.counter(
            "fleet_migrated_warm_blocks",
            "warm-tier prefix blocks adopted by a peer during migration "
            "(a shared prompt prefilled once survives its replica)")
        # per-tenant SLO objectives: ``slos`` maps tenant → overrides of
        # DEFAULT_SLO; the "default" entry re-bases every other tenant
        base_slo = dict(DEFAULT_SLO)
        if slos and "default" in slos:
            base_slo.update(slos["default"])
        self._slo_default = base_slo
        self._slo_overrides = {t: dict(base_slo, **ov)
                               for t, ov in (slos or {}).items()
                               if t != "default"}

    # ---------------------------------------------------------------- routing
    def _eligible(self) -> List[ReplicaInfo]:
        return [r for r in self._replicas
                if r.state in (REPLICA_LIVE, REPLICA_DEGRADED)]

    @staticmethod
    def _prefill_capable(rep: ReplicaInfo) -> bool:
        return rep.role in ("prefill", "any")

    @staticmethod
    def _decode_capable(rep: ReplicaInfo) -> bool:
        return rep.role in ("decode", "any")

    def _score(self, rep: ReplicaInfo, prompt: Sequence[int]) -> float:
        """Routing score: cached-prefix tokens minus load, minus a large
        penalty for degraded replicas. Read-only on the replica."""
        srv = rep.server
        hits = srv.probe_prefix(prompt)
        lm = srv.load_metrics()
        score = (self.prefix_weight * hits * srv.block_size
                 - self.load_weight * (lm["queue_depth"]
                                       + lm["slots_occupied"]))
        if lm.get("blocks_headroom", 1) <= 0:
            score -= 4.0 * self.load_weight   # admission-headroom pressure
        if rep.state == REPLICA_DEGRADED:
            score -= self.degraded_penalty
        return score

    def _route(self, prompt: Sequence[int]) -> List[ReplicaInfo]:
        """Eligible replicas in routing-preference order (best first).
        In a disaggregated fleet only the prefill class is scored — a
        fresh submission always starts with chunked prefill, so scoring
        decode-class peers would just misroute it into a replica whose
        output must immediately hand off right back. If the whole
        prefill class is down, submissions fall through to the decode
        class (which re-prefills — the degradation ladder, not a new
        path). An injected ``route`` fault reverses the preference — a
        misroute must only cost prefix reuse, never correctness."""
        reps = self._eligible()
        if not reps:
            raise EngineFailedError(
                "no live replicas — the fleet is fully dead or draining")
        if self.disagg:
            pre = [r for r in reps if self._prefill_capable(r)]
            reps = pre or [r for r in reps if self._decode_capable(r)]
        reps = sorted(reps, key=lambda r: (-self._score(r, prompt), r.idx))
        if self._faults.fire("route") is not None:
            self._c_misroutes.inc()
            reps = list(reversed(reps))
        return reps

    def submit(self, prompt: Sequence[int], **kw) -> int:
        """Route one request to the best replica; same keyword surface
        as :meth:`~.serving.GenerationServer.submit`, same rid contract
        (the replica's rid IS the fleet rid — spaces are disjoint).
        Falls through to the next-best replica on
        :class:`~.scheduler.AdmissionError` backpressure; re-raises only
        when every eligible replica refused."""
        last: Optional[AdmissionError] = None
        for rep in self._route(prompt):
            try:
                rid = rep.server.submit(prompt, **kw)
            except AdmissionError as e:
                last = e
                continue
            self._home[rid] = rep.idx
            self._c_routed.inc(replica=str(rep.idx))
            return rid
        raise last if last is not None else EngineFailedError(
            "no live replicas accepted the request")

    # ----------------------------------------------------------------- health
    def _set_state(self, rep: ReplicaInfo, state: str) -> None:
        if rep.state != state:
            rep.state = state
            rep.history.append((self._clock(), state))

    def _degrade(self, rep: ReplicaInfo, kind: str) -> None:
        if rep.state == REPLICA_LIVE:
            self._set_state(rep, REPLICA_DEGRADED)
            rep.degraded_t = self._clock()
            self._c_degraded.inc(kind=kind)

    def _kill(self, rep: ReplicaInfo, reason: str) -> None:
        """Remove a replica from membership and fail over: poison the
        engine, salvage its in-flight requests from host state (device
        KV is untrusted after a crash) and re-admit them on peers."""
        rep.server.fail(f"fleet: {reason}")
        self._set_state(rep, REPLICA_DEAD)
        self._c_deaths.inc(reason=reason.split(":")[0])
        t0 = self._clock()
        snap = rep.server.evacuate(trust_kv=False)
        self._absorb(snap)
        moved = self._migrate(snap, exclude=rep.idx, reason="failover")
        self._record_migration_latency(self._clock() - t0, moved)

    def _heartbeat(self, rep: ReplicaInfo, remaining: int) -> None:
        """Tick-progress liveness: a replica holding work must advance
        its step counter; one that doesn't accrues stall ticks →
        degraded → dead. Clock-based timeout (``heartbeat_timeout_s``)
        rides the same injectable clock."""
        steps = rep.server.steps
        now = self._clock()
        # transport-aware handles stamp every observation with a
        # monotone ``progress_seq``; when no FRESH sample has crossed
        # the boundary since the last heartbeat, a repeated step count
        # is *staleness*, not a stall — charging it would let ordinary
        # transport round-trip latency degrade a healthy remote
        # replica. In-process servers have no such attribute and keep
        # the original always-fresh accounting.
        seq = getattr(rep.server, "progress_seq", None)
        if seq is not None:
            if seq == rep.last_seq:
                return
            rep.last_seq = seq
        progressed = (steps != rep.last_steps
                      or remaining < rep.last_remaining)
        if remaining and not progressed:
            rep.stall_ticks += 1
            self._c_stalls.inc()
            timed_out = (self.heartbeat_timeout_s is not None
                         and now - rep.last_progress_t
                         > self.heartbeat_timeout_s)
            if rep.stall_ticks >= self.stall_ticks_dead or (
                    timed_out and rep.state == REPLICA_DEGRADED):
                self._kill(rep, "heartbeat: wedged with work")
                return
            if rep.stall_ticks >= self.stall_ticks_degraded or timed_out:
                self._degrade(rep, "heartbeat_stall")
        else:
            rep.stall_ticks = 0
            if progressed:
                rep.last_progress_t = now
            if (rep.state == REPLICA_DEGRADED
                    and now - rep.degraded_t >= self.degrade_cooldown_s):
                self._set_state(rep, REPLICA_LIVE)
        rep.last_steps = steps
        rep.last_remaining = remaining

    def _probe_watchdog(self, rep: ReplicaInfo) -> None:
        """Flight-recorder probe: any watchdog finding (preemption storm,
        pool-pressure stall, steady-state recompile) flips the replica
        degraded so routing sheds load off it while it recovers."""
        try:
            findings = rep.server.watchdog_findings()
        except Exception:
            return
        # degrade on NEW findings only: the flight dump is cumulative
        # over the ring, and re-penalizing one old storm forever would
        # pin the replica degraded long after it recovered
        if len(findings) > rep.last_findings:
            self._degrade(rep, findings[-1].get("kind", "watchdog"))
        rep.last_findings = len(findings)

    # --------------------------------------------------------------- stepping
    def step(self) -> int:
        """One router tick: probe health, advance every live/degraded
        replica one engine step, harvest results; returns total work
        remaining across the fleet. The ``replica_down`` fault site
        fires once per probed replica per tick (ordinal = probe count),
        so a seeded plan kills a deterministic (tick, replica) pair
        mid-decode."""
        self._ticks += 1
        for rep in self._replicas:
            if rep.state in (REPLICA_DEAD, REPLICA_DRAINING):
                continue
            # sweep BEFORE stepping: requests parked last tick leave
            # before this step runs, so a prefill replica whose only
            # work is parked never reads as "holding work without
            # progressing" to the heartbeat below
            if rep.role == "prefill":
                self._sweep_handoff(rep)
            if self._faults.fire("replica_down") is not None:
                self._kill(rep, "injected replica_down")
                continue
            try:
                remaining = rep.server.step()
            except Exception as e:
                rep.server.fail(f"step raised: {e!r}")
                self._kill(rep, f"step_error: {type(e).__name__}")
                continue
            self._heartbeat(rep, remaining)
            if rep.state == REPLICA_DEAD:
                continue
            if self.probe_every and self._ticks % self.probe_every == 0:
                self._probe_watchdog(rep)
            self._results.update(rep.server.take_results())
        # recount AFTER the sweep, not during: a replica killed mid-loop
        # salvages its requests onto peers that may already have stepped
        # this tick, and their step() return would undercount — run()
        # must not stop while migrated work sits queued on a survivor
        total = 0
        for rep in self._eligible():
            lm = rep.server.load_metrics()
            total += lm["queue_depth"] + lm["slots_occupied"]
        return total

    def run(self) -> Dict[int, List[int]]:
        """Drain every replica; returns {rid: prompt+generated ids}
        merged across the fleet (rid spaces are disjoint)."""
        while self.step():
            pass
        for rep in self._replicas:
            if rep.state == REPLICA_DEAD:
                # evacuated at death — finished work already folded into
                # the router's ledgers, and a dead PROCESS has no socket
                # left to ask
                continue
            self._results.update(rep.server.take_results())
        out, self._results = self._results, {}
        return out

    # -------------------------------------------------------------- migration
    def _sweep_handoff(self, rep: ReplicaInfo) -> int:
        """Move every request this prefill replica has parked
        (``handoff_ready``) to the decode class: a partial
        ``evacuate(trust_kv=True, rids=...)`` captures ONLY the parked
        requests — the replica keeps streaming its other prompts — and
        ``_migrate`` re-admits each KV payload on the best decode peer
        through the standard CRC-verified path. Returns requests moved."""
        rids = rep.server.handoff_ready()
        if not rids:
            return 0
        t0 = self._clock()
        snap = rep.server.evacuate(trust_kv=True, rids=rids)
        self._absorb(snap)
        moved = self._migrate(snap, exclude=rep.idx, reason="handoff")
        self._record_migration_latency(self._clock() - t0, moved)
        self._handoff_requests += moved
        self._c_handoffs.inc(replica=str(rep.idx))
        return moved

    def _record_migration_latency(self, dt: float, moved: int) -> None:
        if moved <= 0:
            return
        lat = self._migration_lat
        lat.extend([dt] * moved)
        if len(lat) > self._migration_lat_cap:
            del lat[:len(lat) - self._migration_lat_cap]

    def _absorb(self, snap: Dict[str, Any]) -> None:
        """Fold an evacuated replica's finished work into the router's
        ledgers so ``status``/``run`` keep answering for it."""
        self._results.update(
            {int(r): list(t) for r, t in snap["results"].items()})
        self._dropped.update(snap["dropped"])

    def _migrate(self, snap: Dict[str, Any], *, exclude: int,
                 reason: str) -> int:
        """Re-admit every captured request on the best-scoring peer
        through the normal restore/swap-in path. KV payloads pass the
        ``migrate_payload`` fault site on the way (an injected bit-flip
        is caught by the receiver's CRC check and degrades to
        re-prefill). Requests with no surviving target are quarantined,
        not silently dropped."""
        self._c_migrations.inc(reason=reason)
        moved = 0
        for d in sorted(snap["requests"], key=lambda d: d["sched"]["seq"]):
            targets = [r for r in self._eligible() if r.idx != exclude]
            if self.disagg:
                # class-aware targeting: decode-phase payloads (a KV
                # handoff, or anything that already generated tokens)
                # MUST land on the decode class — a prefill replica
                # refuses them at the door; pure-prompt payloads prefer
                # the prefill class but fall back to decode, which
                # re-prefills (the chaos-kill salvage path)
                decode_phase = (d["phase"] == "kv"
                                or bool(d.get("generated")))
                if decode_phase:
                    targets = [r for r in targets
                               if self._decode_capable(r)]
                else:
                    pre = [r for r in targets
                           if self._prefill_capable(r)]
                    targets = pre or [r for r in targets
                                      if self._decode_capable(r)]
            if not targets:
                self._dropped[int(d["rid"])] = "failed"
                self._c_quarantined.inc()
                continue
            target = min(targets,
                         key=lambda r: (-self._score(r, d["prompt"]),
                                        r.idx))
            if d["phase"] == "kv":
                if self._faults.fire("migrate_payload") is not None:
                    # the payload may be shared (a parked copy, a view of
                    # the gather buffer): flip a bit of a copy, which keeps
                    # the ORIGINAL checksum, so the receiver's CRC verify
                    # must catch the flip
                    d["kv"]["arrays"] = [
                        a.clone() if isinstance(a, torch.Tensor)
                        else np.array(a) for a in d["kv"]["arrays"]]
                    self._faults.corrupt(d["kv"]["arrays"])
                    self._c_corrupt.inc()
            target.server.admit_migrated(d, source_config=snap["config"])
            self._home[int(d["rid"])] = target.idx
            self._c_migrated.inc(phase=d["phase"])
            moved += 1
        warm = snap.get("warm_tier") or []
        if warm:
            # offer the dead/draining replica's warm prefix blocks to ONE
            # surviving peer (prefill-capable preferred — promotion
            # happens at admission), least loaded first; adopt_warm CRC-
            # verifies per entry, so a corrupted payload just misses
            targets = [r for r in self._eligible() if r.idx != exclude]
            if self.disagg:
                pre = [r for r in targets if self._prefill_capable(r)]
                targets = pre or targets
            if targets:
                def _load(r):
                    lm = r.server.load_metrics()
                    return (lm["queue_depth"] + lm["slots_occupied"], r.idx)
                adopted = min(targets, key=_load).server.adopt_warm(warm)
                if adopted:
                    self._c_warm_migrated.inc(adopted)
        return moved

    def drain(self, idx: int) -> int:
        """Gracefully drain replica ``idx``: stop routing to it, migrate
        every in-flight request (KV payloads included — this is the
        trusted-device path) to peers, then retire it. Returns the
        number of requests migrated."""
        rep = self._replicas[idx]
        if rep.state == REPLICA_DEAD:
            raise ValueError(f"replica {idx} is already dead")
        self._set_state(rep, REPLICA_DRAINING)
        t0 = self._clock()
        snap = rep.server.evacuate(trust_kv=True)
        self._absorb(snap)
        moved = self._migrate(snap, exclude=idx, reason="drain")
        self._record_migration_latency(self._clock() - t0, moved)
        self._set_state(rep, REPLICA_DEAD)
        self._c_drains.inc()
        return moved

    def kill(self, idx: int, reason: str = "operator kill") -> None:
        """Forcibly remove replica ``idx`` as if it crashed: poison the
        engine and fail its requests over to peers via host-state
        salvage (the deterministic twin of the ``replica_down`` fault)."""
        rep = self._replicas[idx]
        if rep.state == REPLICA_DEAD:
            raise ValueError(f"replica {idx} is already dead")
        self._kill(rep, reason)

    # ------------------------------------------------------------- elasticity
    def add_replica(self, server: Any) -> int:
        """Grow the fleet by one FRESH replica mid-flight — the
        autoscaler's scale-up primitive. The newcomer passes the same
        gate the constructor applies (paged, fingerprint-homogeneous,
        nothing submitted) and gets the next disjoint rid space; it is
        immediately live and routable, and every in-flight rid keeps
        its meaning. Returns the new replica index."""
        if server.cache_mode != "paged":
            raise ValueError(
                f"new replica has cache={server.cache_mode!r} — fleet "
                f"migration needs the paged per-request KV capture")
        fp = dict(server._snapshot_fingerprint())
        fp.pop("num_blocks")
        if fp != self._fp_want:
            raise ValueError(
                f"new replica config differs from the fleet — replicas "
                f"must stay homogeneous so any replica can receive any "
                f"migration ({fp!r} vs {self._fp_want!r})")
        idx = len(self._replicas)
        server.set_rid_base(idx * RID_STRIDE)
        now = self._clock()
        rep = ReplicaInfo(idx=idx, server=server,
                          role=getattr(server, "role", "any"),
                          last_progress_t=now,
                          history=[(now, REPLICA_LIVE)])
        self._replicas.append(rep)
        # adding a classed replica can flip the fleet disaggregated;
        # the constructor's capability invariants can only get easier
        self.disagg = any(r.role != "any" for r in self._replicas)
        return idx

    def live_indices(self) -> List[int]:
        """Indices currently accepting work (live or degraded) — the
        autoscaler's census of drainable/routable capacity."""
        return [r.idx for r in self._replicas
                if r.state in (REPLICA_LIVE, REPLICA_DEGRADED)]

    # ------------------------------------------------------------ observation
    def status(self, rid: int) -> str:
        """Fleet-wide request status — the router's ledgers first (they
        answer for dead replicas), then the request's home replica."""
        if rid in self._results:
            return "done"
        if rid in self._dropped:
            return self._dropped[rid]
        idx = self._home.get(rid)
        if idx is None:
            return "unknown"
        return self._replicas[idx].server.status(rid)

    def cancel(self, rid: int) -> bool:
        """Cancel on the request's current home replica."""
        idx = self._home.get(rid)
        if idx is None or rid in self._results or rid in self._dropped:
            return False
        return self._replicas[idx].server.cancel(rid)

    def replica_states(self) -> List[str]:
        return [r.state for r in self._replicas]

    def assert_conserved(self) -> Dict[int, Dict[str, int]]:
        """Run every engine's conservation audit (dead replicas were
        evacuated, so theirs must hold trivially); returns the audited
        numbers per replica index."""
        return {r.idx: r.server.assert_conserved()
                for r in self._replicas}

    def _slo_for(self, tenant: str) -> Dict[str, float]:
        return self._slo_overrides.get(tenant, self._slo_default)

    def slo_rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant TTFT/TPOT SLO attainment and burn rate, rolled up
        across every replica's registry.

        Reads the tenant-labeled ``serving_ttft_s`` / ``serving_tpot_ms``
        histograms each replica's server already records (dead replicas
        included — their completed requests still count against the
        tenant's budget), keeps the last ``window`` samples per tenant,
        and computes ``attainment`` (fraction at or under the objective)
        and ``burn_rate`` (violating fraction / error budget). The
        ``fleet_slo_{ttft,tpot}_{attainment,burn_rate}{tenant=...}``
        gauges land in ``self.registry`` — so the Prometheus exposition
        carries them — and the same rows come back as the ``slo`` key of
        :meth:`fleet_metrics`, which is what a canary-promotion gate
        polls."""
        reg = self.registry
        gathered: Dict[str, Dict[str, List[float]]] = {}
        for rep in self._replicas:
            try:
                obs = rep.server.slo_observations()
            except Exception:
                # a replica whose PROCESS is gone can't ship samples —
                # its completed requests were already harvested; an
                # in-process dead replica still answers from host state
                continue
            for key in ("ttft", "tpot"):
                for tenant, samples in sorted((obs.get(key) or {}).items()):
                    w = int(self._slo_for(tenant)["window"])
                    gathered.setdefault(
                        tenant, {"ttft": [], "tpot": []})[key].extend(
                        list(samples)[-w:])
        out: Dict[str, Dict[str, Any]] = {}
        for tenant in sorted(gathered):
            slo = self._slo_for(tenant)
            budget = max(1e-9, 1.0 - float(slo["target"]))
            row: Dict[str, Any] = {"target": float(slo["target"]),
                                   "window": int(slo["window"])}
            for key, obj_key in (("ttft", "ttft_s"), ("tpot", "tpot_ms")):
                objective = float(slo[obj_key])
                samples = gathered[tenant][key][-int(slo["window"]):]
                viol = (sum(1 for v in samples if v > objective)
                        / len(samples)) if samples else 0.0
                attain = 1.0 - viol
                burn = viol / budget
                row[key] = {"objective": objective,
                            "samples": len(samples),
                            "attainment": attain, "burn_rate": burn}
                reg.gauge(
                    f"fleet_slo_{key}_attainment",
                    f"fraction of the rolling window at or under the "
                    f"{key} objective (tenant label)").set(
                    attain, tenant=tenant)
                reg.gauge(
                    f"fleet_slo_{key}_burn_rate",
                    f"{key} violating fraction / error budget; > 1 "
                    f"exhausts the budget (tenant label)").set(
                    burn, tenant=tenant)
                reg.gauge(
                    f"fleet_slo_{key}_objective",
                    f"configured {key} objective "
                    f"({'seconds' if key == 'ttft' else 'ms'}; "
                    f"tenant label)").set(objective, tenant=tenant)
            out[tenant] = row
        return out

    def fleet_metrics(self) -> Dict[str, Any]:
        """Sync the ``fleet_*`` gauges and return the fleet view: state
        census, router counters, per-tenant SLO roll-up (``slo`` key),
        and one row per replica (state, load, prefix-cache
        effectiveness, routed share) — the ``serving_benchmark
        --fleet N`` table."""
        reg = self.registry
        census = {s: 0 for s in (REPLICA_LIVE, REPLICA_DEGRADED,
                                 REPLICA_DRAINING, REPLICA_DEAD)}
        rows = []
        for rep in self._replicas:
            census[rep.state] += 1
            srv = rep.server
            try:
                lm = srv.load_metrics()
                ks = srv.kv_stats()
            except Exception:
                # a dead process answers nothing; report its row empty
                lm, ks = {"queue_depth": 0, "slots_occupied": 0}, {}
            row = {"replica": rep.idx, "state": rep.state,
                   "role": rep.role,
                   "steps": srv.steps,
                   "queue_depth": lm["queue_depth"],
                   "slots_occupied": lm["slots_occupied"],
                   "blocks_headroom": lm.get("blocks_headroom", 0),
                   "prefix_hit_rate": ks.get("prefix_hit_rate", 0.0),
                   "routed": int(self._c_routed.total(
                       where={"replica": str(rep.idx)})),
                   "stall_ticks": rep.stall_ticks,
                   "transitions": [s for _, s in rep.history]}
            rows.append(row)
            reg.gauge("fleet_replica_queue_depth",
                      "per-replica queue depth").set(
                float(lm["queue_depth"]), replica=str(rep.idx))
            reg.gauge("fleet_replica_slots_occupied",
                      "per-replica occupied slots").set(
                float(lm["slots_occupied"]), replica=str(rep.idx))
            reg.gauge("fleet_replica_up",
                      "1 while the replica accepts work").set(
                1.0 if rep.state in (REPLICA_LIVE, REPLICA_DEGRADED)
                else 0.0, replica=str(rep.idx))
        for s, n in census.items():
            reg.gauge(f"fleet_replicas_{s}",
                      f"replicas in state {s}").set(float(n))
        up = [r for r in self._replicas
              if r.state in (REPLICA_LIVE, REPLICA_DEGRADED)]
        lat = sorted(self._migration_lat)

        def _pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {"replicas": rows, "states": census,
                "slo": self.slo_rollup(),
                "disagg": self.disagg,
                "prefill_replicas": sum(r.role == "prefill" for r in up),
                "decode_replicas": sum(r.role == "decode" for r in up),
                "handoffs": int(self._c_handoffs.total()),
                "handoff_requests": self._handoff_requests,
                "migration_latency_p50_s": _pct(0.50),
                "migration_latency_p95_s": _pct(0.95),
                "migration_latency_samples": len(lat),
                "ticks": self._ticks,
                "routed": int(self._c_routed.total()),
                "misroutes": int(self._c_misroutes.total()),
                "migrations": int(self._c_migrations.total()),
                "migrated_requests": int(self._c_migrated.total()),
                "migrated_kv": int(self._c_migrated.total(
                    where={"phase": "kv"})),
                "migrated_warm_blocks": int(self._c_warm_migrated.total()),
                "migrate_corruptions": int(self._c_corrupt.total()),
                "deaths": int(self._c_deaths.total()),
                "drains": int(self._c_drains.total()),
                "degraded_events": int(self._c_degraded.total()),
                "heartbeat_stalls": int(self._c_stalls.total()),
                "quarantined": int(self._c_quarantined.total())}
