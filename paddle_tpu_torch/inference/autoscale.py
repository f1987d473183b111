"""SLO-driven elastic autoscaling for the replica fleet — port of
``paddle_tpu/inference/autoscale.py`` (host code, no clock, no draws: the
same observation rows give the JAX package's decisions byte for byte).

Two halves, deliberately separated:

- :class:`ElasticAutoscaler` is the *pure decision engine*: given one
  observation row — live replica count, observed token demand, the cost
  model's forecast of demand ahead of the diurnal curve, and the worst
  per-tenant SLO burn rate from the router's roll-up — it returns a
  :class:`ScaleDecision`. It holds no clock and draws no randomness, so
  the same observations always produce the same decisions (the
  determinism contract the traffic simulator's byte-identical runs lean
  on), and every decision is journaled with its full input row so a
  recorded run can be *replayed* and audited (:func:`verify_replay`).

- :class:`FleetAutoscaler` binds those decisions to a live
  :class:`~.fleet.FleetRouter`: scale-up calls a caller-supplied
  ``spawn()`` factory and :meth:`~.fleet.FleetRouter.add_replica`;
  scale-down picks a victim (degraded first, then least loaded, newest
  first) and rides the router's token-exact
  :meth:`~.fleet.FleetRouter.drain` — the same snapshot/swap-in path
  every other migration uses, so elasticity never invents a new
  correctness path.

Sizing logic: desired capacity covers ``max(observed demand, forecast)``
with each replica loaded to at most ``target_utilization`` of the
per-replica capacity ``capacity_tok_s`` (a measured rate, or a cost
model's ``capacity_tok_s`` prediction, such as the autotuner's
``ServingCostModel.capacity_tok_s``).
That makes the *forecast* the proactive half — capacity arrives before
the diurnal peak does — while a burn rate above ``burn_up`` forces a
reactive scale-up even when the model disagrees (the model is a sizing
device, the SLO is the contract). Scale-down is deliberately timid:
blocked while any tenant still burns above ``burn_down``, rate-limited
by ``down_cooldown_s``, one replica per decision, and it refuses to
drain the last live replica no matter what the arithmetic says.

All decisions land in telemetry as ``fleet_autoscale_*`` counters and
gauges.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "AutoscalePolicy", "ElasticAutoscaler", "FleetAutoscaler",
    "ScaleDecision", "verify_replay",
]


@dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs for the decision engine. Defaults suit a diurnal day-scale
    sim; real deployments tune them like any other SLO parameter."""

    #: hard floor/ceiling on live replicas — the floor is also the
    #: "never drain the last replica" guarantee (min 1 enforced)
    min_replicas: int = 1
    max_replicas: int = 8
    #: plan each replica to at most this fraction of predicted capacity
    #: — the headroom that absorbs forecast error and burst
    target_utilization: float = 0.75
    #: any tenant burning above this forces a reactive scale-up
    burn_up: float = 1.0
    #: scale-down is blocked while any tenant burns above this
    burn_down: float = 0.25
    #: seconds between consecutive scale-ups / scale-downs
    up_cooldown_s: float = 60.0
    down_cooldown_s: float = 600.0
    #: most replicas added per decision (downs are always one at a time)
    max_step_up: int = 2

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 — a fleet with "
                             "zero replicas can serve nothing")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})")
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError(
                f"target_utilization must be in (0, 1], got "
                f"{self.target_utilization!r}")


@dataclass(frozen=True)
class ScaleDecision:
    """One journaled decision: the full observation row plus the
    outcome, so a trace replays bit-identically (:func:`verify_replay`)."""

    t: float
    action: str                 # "up" | "down" | "hold"
    count: int                  # replicas added/removed (0 on hold)
    desired: int                # post-clamp desired replica count
    live: int                   # live replicas when observed
    demand_tok_s: float
    forecast_tok_s: float
    burn_rate: float
    reason: str

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


class ElasticAutoscaler:
    """Pure, clock-free, journaling decision engine (see module doc)."""

    def __init__(self, capacity_tok_s: float, *,
                 policy: Optional[AutoscalePolicy] = None,
                 registry=None):
        if capacity_tok_s <= 0:
            raise ValueError(
                f"capacity_tok_s must be > 0, got {capacity_tok_s!r}")
        self.capacity_tok_s = float(capacity_tok_s)
        self.policy = policy or AutoscalePolicy()
        self.events: List[ScaleDecision] = []
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        if registry is None:
            from .telemetry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._c_decisions = registry.counter(
            "fleet_autoscale_decisions",
            "autoscaler control decisions (action label)")
        self._c_blocked = registry.counter(
            "fleet_autoscale_blocked",
            "desired!=live decisions held back (reason label: "
            "cooldown/burn_gate/last_replica/ceiling)")
        self._g_desired = registry.gauge(
            "fleet_autoscale_desired_replicas",
            "replica count the sizing arithmetic wants")
        self._g_live = registry.gauge(
            "fleet_autoscale_live_replicas",
            "live replicas at the last decision")
        self._g_demand = registry.gauge(
            "fleet_autoscale_demand_tok_s",
            "observed token demand at the last decision")
        self._g_forecast = registry.gauge(
            "fleet_autoscale_forecast_tok_s",
            "cost-model demand forecast at the last decision")
        self._g_burn = registry.gauge(
            "fleet_autoscale_burn_rate",
            "worst per-tenant SLO burn rate at the last decision")

    # ------------------------------------------------------------ decisions
    def _raw_want(self, demand_tok_s: float,
                  forecast_tok_s: float) -> int:
        """Unclamped sizing: replicas to cover the larger of observed
        demand and forecast at ``target_utilization``. Zero planning
        load wants zero replicas — the [min, max] clamp (and the
        last-replica refusal in :meth:`decide`) is policy, and keeping
        it OUT of the arithmetic is what lets the decision journal
        distinguish "held at the floor" from "sized to the floor"."""
        p = self.policy
        planning = max(float(demand_tok_s), float(forecast_tok_s), 0.0)
        cap = self.capacity_tok_s * p.target_utilization
        return int(math.ceil(planning / cap)) if planning > 0 else 0

    def desired_replicas(self, demand_tok_s: float,
                         forecast_tok_s: float = 0.0) -> int:
        """Pure sizing arithmetic: replicas to cover the larger of
        observed demand and forecast at ``target_utilization``, clamped
        to the policy's [min, max]."""
        p = self.policy
        want = self._raw_want(demand_tok_s, forecast_tok_s)
        return max(p.min_replicas, min(p.max_replicas, want))

    def decide(self, now: float, *, live: int, demand_tok_s: float,
               forecast_tok_s: float = 0.0,
               burn_rate: float = 0.0) -> ScaleDecision:
        """One control decision from one observation row. ``now`` is
        the CALLER's clock (virtual in the simulator, the router's
        injected clock in a live fleet) — the engine never reads time
        itself."""
        p = self.policy
        live = int(live)
        want = self._raw_want(demand_tok_s, forecast_tok_s)
        desired = max(p.min_replicas, min(p.max_replicas, want))
        reason = ("forecast" if forecast_tok_s > demand_tok_s
                  else "demand")
        if burn_rate > p.burn_up and desired <= live:
            # the SLO is the contract: budget burning faster than the
            # model predicted means the model is wrong, not the tenants
            desired = min(p.max_replicas, live + 1)
            reason = "burn_rate"

        action, count = "hold", 0
        if desired > live or want > live >= p.max_replicas:
            # second disjunct: the arithmetic wants MORE than the
            # ceiling allows while the fleet already sits at it — the
            # clamp hides that from `desired`, but pinned-at-ceiling is
            # an auditable decision (capacity is being refused), not
            # steady state
            if live >= p.max_replicas:
                reason = "ceiling"
                self._c_blocked.inc(reason="ceiling")
            elif (self._last_up_t is not None
                    and now - self._last_up_t < p.up_cooldown_s):
                reason = "up_cooldown"
                self._c_blocked.inc(reason="cooldown")
            else:
                action = "up"
                count = min(desired - live, p.max_step_up,
                            p.max_replicas - live)
                self._last_up_t = now
        elif desired < live or want < live <= max(1, p.min_replicas):
            # the second disjunct is the arithmetic *wanting* to go
            # below the floor (want < min <= live): the clamp hides it
            # from `desired`, but the refusal must still be journaled —
            # "held at the floor" is an auditable decision, not silence
            if live <= max(1, p.min_replicas):
                # never drain the last live replica — even a policy
                # misconfiguration must not scale the fleet to zero
                reason = "last_replica"
                self._c_blocked.inc(reason="last_replica")
            elif burn_rate > p.burn_down:
                reason = "burn_gate"
                self._c_blocked.inc(reason="burn_gate")
            elif (self._last_down_t is not None
                  and now - self._last_down_t < p.down_cooldown_s):
                reason = "down_cooldown"
                self._c_blocked.inc(reason="cooldown")
            else:
                action, count = "down", 1
                self._last_down_t = now
        else:
            reason = "steady"

        d = ScaleDecision(t=float(now), action=action, count=count,
                          desired=desired, live=live,
                          demand_tok_s=float(demand_tok_s),
                          forecast_tok_s=float(forecast_tok_s),
                          burn_rate=float(burn_rate), reason=reason)
        self.events.append(d)
        self._c_decisions.inc(action=action)
        self._g_desired.set(float(desired))
        self._g_live.set(float(live))
        self._g_demand.set(float(demand_tok_s))
        self._g_forecast.set(float(forecast_tok_s))
        self._g_burn.set(float(burn_rate))
        return d


def verify_replay(events: Sequence[Dict[str, Any]],
                  capacity_tok_s: float, *,
                  policy: Optional[AutoscalePolicy] = None) -> bool:
    """Re-run every journaled observation row through a FRESH engine and
    check it reproduces the recorded decisions exactly — the audit that
    a sim trace's ``autoscale_events`` really are a replayable record
    (determinism contract) rather than a log of accidents. Raises
    ``AssertionError`` naming the first diverging event."""
    engine = ElasticAutoscaler(capacity_tok_s, policy=policy)
    for i, ev in enumerate(events):
        d = engine.decide(ev["t"], live=ev["live"],
                          demand_tok_s=ev["demand_tok_s"],
                          forecast_tok_s=ev["forecast_tok_s"],
                          burn_rate=ev["burn_rate"])
        got = d.as_dict()
        for k in ("action", "count", "desired", "reason"):
            if got[k] != ev[k]:
                raise AssertionError(
                    f"autoscale replay diverged at event {i}: "
                    f"{k}={got[k]!r}, recorded {ev[k]!r}")
    return True


class FleetAutoscaler:
    """Bind an :class:`ElasticAutoscaler` to a live
    :class:`~.fleet.FleetRouter`: each :meth:`control` call turns one
    decision into real spawns (``spawn()`` factory + ``add_replica``)
    or one token-exact ``drain``."""

    def __init__(self, fleet: Any, engine: ElasticAutoscaler,
                 spawn: Callable[[], Any]):
        self.fleet = fleet
        self.engine = engine
        self.spawn = spawn
        #: (decision, [replica indices added/drained]) pairs, in order
        self.applied: List[Any] = []

    def worst_burn_rate(self) -> float:
        """Max burn rate across tenants and both objectives, from the
        router's SLO roll-up (``FleetRouter.slo_rollup``)."""
        worst = 0.0
        for row in self.fleet.slo_rollup().values():
            for key in ("ttft", "tpot"):
                worst = max(worst, float(row[key]["burn_rate"]))
        return worst

    def _drain_victim(self) -> int:
        """Degraded first (shed flaky capacity), then least loaded,
        then newest — replica 0 retires last."""
        from .fleet import REPLICA_DEGRADED

        def score(idx: int):
            rep = self.fleet._replicas[idx]
            lm = rep.server.load_metrics()
            return (0 if rep.state == REPLICA_DEGRADED else 1,
                    lm["queue_depth"] + lm["slots_occupied"], -idx)

        return min(self.fleet.live_indices(), key=score)

    def control(self, now: float, *, demand_tok_s: float,
                forecast_tok_s: float = 0.0):
        """One control-loop tick: observe, decide, apply. Returns the
        :class:`ScaleDecision` (with replicas spawned/drained recorded
        in :attr:`applied`)."""
        live = len(self.fleet.live_indices())
        d = self.engine.decide(now, live=live,
                               demand_tok_s=demand_tok_s,
                               forecast_tok_s=forecast_tok_s,
                               burn_rate=self.worst_burn_rate())
        touched: List[int] = []
        if d.action == "up":
            for _ in range(d.count):
                touched.append(self.fleet.add_replica(self.spawn()))
        elif d.action == "down":
            victim = self._drain_victim()
            self.fleet.drain(victim)
            touched.append(victim)
        self.applied.append((d, touched))
        return d
