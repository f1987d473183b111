"""Request scheduling for ``GenerationServer`` — port of
``paddle_tpu/inference/scheduler.py``: priorities, deadlines, weighted fair
queuing, admission control and cancellation.

This is the policy half of overload handling; the mechanism half —
preempting a running request by swapping its KV blocks to host memory and
restoring them later — is ``inference/kv_offload.py``, and the two meet in
``GenerationServer.step``. Pure host Python over small lists: the queue
never touches the device, so no policy decision adds a CUDA graph or a
kernel shape.

Three policies (``GenerationServer(policy=...)``):

- ``"fifo"`` (default): submission order.
- ``"priority"``: strict priority classes (lower value = more urgent),
  FIFO within a class; entries with a deadline order ahead of peers
  without one, earliest first (EDF within the class).
- ``"wfq"``: weighted fair queuing across tenants within each priority
  class: tenant ``t`` of weight ``w_t`` charges each request ``cost / w_t``
  of virtual time past its previous finish tag, and pops are lowest tag
  first, so a tenant's share of admissions tends to ``w_t / sum(w)``.

Preempted requests re-enter the queue with their original ``seq`` and a
``preempted`` flag that orders them ahead of waiting peers of their class.
TTLs bound queue wait, not execution: a never-started entry whose deadline
passes is dropped by :meth:`Scheduler.expire`; a started one (preempted
and requeued included) is never expired, only cancelled.

:meth:`Scheduler.attach_metrics` mirrors the intake counters into the
server's telemetry registry (``sched_requests_*``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

__all__ = ["AdmissionError", "SchedEntry", "Scheduler",
           "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW"]

# Priority classes: plain ints, lower = more urgent. Any int >= 0 works
# (the three names are conventional anchors, not an enum cage).
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

_POLICIES = ("fifo", "priority", "wfq")


class AdmissionError(RuntimeError):
    """Backpressure: the queue is at ``max_queue`` — the caller should
    shed load or retry later, not silently deepen the backlog."""


@dataclass
class SchedEntry:
    """One waiting (or preempted) request as the scheduler sees it. The
    payload ``req`` is opaque — the scheduler never reads token ids."""

    req: Any
    rid: int
    priority: int = PRIORITY_NORMAL
    tenant: str = "default"
    deadline: Optional[float] = None    # absolute clock time; None = no TTL
    seq: int = 0                        # admission order, kept on requeue
    cost: float = 1.0                   # WFQ charge (est. total tokens)
    vtag: float = 0.0                   # WFQ finish tag, set at submit
    preempted: bool = False             # requeued after losing its slot
    started: bool = False               # was admitted at least once
    swap: Any = None                    # kv_offload.SwapHandle, swapped out
    adapter: Optional[str] = None       # LoRA adapter name (None = base model)
    # estimated FRESH device blocks the entry's first allocation burst
    # needs, annotated by the server's admission gate each time it runs —
    # tier-aware: hot prefix hits are subtracted (they re-ref resident
    # blocks), warm-tier hits still count (promotion fills a fresh
    # block). None until the gate has looked at the entry.
    kv_need: Optional[int] = None


class Scheduler:
    """Policy-ordered waiting queue with admission control and TTLs.

    ``clock`` is injectable (default ``time.monotonic``) so deadline
    behavior is deterministic under test. ``weights`` maps tenant name to
    WFQ weight (default 1.0; ignored by fifo/priority).
    """

    def __init__(self, policy: str = "fifo",
                 max_queue: Optional[int] = None,
                 default_ttl_s: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if default_ttl_s is not None and not default_ttl_s > 0:
            raise ValueError(
                f"default_ttl_s must be > 0, got {default_ttl_s}")
        self.policy = policy
        self.max_queue = max_queue
        self.default_ttl_s = default_ttl_s
        self.weights = dict(weights or {})
        for t, w in self.weights.items():
            if not w > 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self._clock = clock
        # monotonic clamp high-water mark (see now()); -inf until first read
        self._last_now = float("-inf")
        self._q: List[SchedEntry] = []
        self._seq = 0
        # WFQ virtual time: advances to each popped entry's finish tag;
        # per-tenant last tag keeps a tenant's backlog serialized
        self._vnow = 0.0
        self._tenant_tag: Dict[str, float] = {}
        # counters (read by GenerationServer.sched_metrics)
        self.submitted = 0
        self.expired = 0
        self.cancelled = 0
        # registry twins (telemetry.py) — None until a server calls
        # attach_metrics; the ints above stay authoritative for direct
        # Scheduler users with no registry
        self._m_submitted = None
        self._m_expired = None
        self._m_cancelled = None

    def attach_metrics(self, registry) -> None:
        """Mirror the intake counters into a
        :class:`~paddle_tpu_torch.telemetry.MetricsRegistry`
        (``sched_requests_*``). Pre-attach history is seeded in so registry
        totals always equal the ints; ``submitted`` is additionally
        labeled by tenant."""
        self._m_submitted = registry.counter(
            "sched_requests_submitted", "requests admitted to the queue")
        self._m_expired = registry.counter(
            "sched_requests_expired", "queued requests dropped by TTL")
        self._m_cancelled = registry.counter(
            "sched_requests_cancelled", "queued requests cancelled")
        for c, n in ((self._m_submitted, self.submitted),
                     (self._m_expired, self.expired),
                     (self._m_cancelled, self.cancelled)):
            if n:
                c.inc(n)

    # ------------------------------------------------------------------- clock
    def now(self) -> float:
        """Monotonically-clamped read of the injectable clock.

        The clock is injectable for tests and chaos plans, which means it
        can stall or jump backwards; an unclamped backwards jump would
        compute negative TTL remainders and make deadlines granted after
        the jump expire before deadlines granted before it. Clamping to
        the high-water mark keeps every timestamp ordering monotone: a
        stalled/backwards clock degrades to "time stands still", which
        TTL logic tolerates (nothing new expires), instead of corrupting
        the ordering invariants."""
        t = self._clock()
        if t > self._last_now:
            self._last_now = t
        return self._last_now

    # ------------------------------------------------------------------ intake
    def submit(self, req: Any, rid: int, *, priority: int = PRIORITY_NORMAL,
               tenant: str = "default", ttl_s: Optional[float] = None,
               cost: float = 1.0,
               adapter: Optional[str] = None) -> SchedEntry:
        """Admit one request to the queue; raises :class:`AdmissionError`
        when the queue is full (backpressure — shed, don't bury)."""
        if isinstance(priority, bool) or not isinstance(priority, int) \
                or priority < 0:
            raise ValueError(f"priority must be an int >= 0 "
                             f"(0 = most urgent), got {priority!r}")
        if ttl_s is not None and not ttl_s > 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s!r}")
        if self.max_queue is not None and len(self._q) >= self.max_queue:
            raise AdmissionError(
                f"queue full ({len(self._q)}/{self.max_queue} waiting) — "
                f"backpressure: retry later or raise max_queue")
        ttl = ttl_s if ttl_s is not None else self.default_ttl_s
        now = self.now()
        w = self.weights.get(tenant, 1.0)
        tag = max(self._vnow, self._tenant_tag.get(tenant, 0.0)) \
            + float(cost) / w
        self._tenant_tag[tenant] = tag
        ent = SchedEntry(req=req, rid=rid, priority=priority, tenant=tenant,
                         deadline=(now + ttl) if ttl is not None else None,
                         seq=self._seq, cost=float(cost), vtag=tag,
                         adapter=adapter)
        self._seq += 1
        self._q.append(ent)
        self.submitted += 1
        if self._m_submitted is not None:
            self._m_submitted.inc(tenant=tenant)
        return ent

    def requeue(self, ent: SchedEntry) -> None:
        """Return a preempted entry to the queue. Never subject to
        admission control (it was already admitted once); its original
        ``seq``/``vtag`` plus the ``preempted`` flag order it ahead of
        waiting peers in its class."""
        ent.preempted = True
        ent.started = True
        self._q.append(ent)

    # ------------------------------------------------------------------ order
    def _key(self, ent: SchedEntry):
        head = (ent.priority, 0 if ent.preempted else 1)
        if self.policy == "fifo":
            return (0 if ent.preempted else 1, ent.seq)
        if self.policy == "priority":
            dl = ent.deadline if ent.deadline is not None else float("inf")
            return head + (dl, ent.seq)
        return head + (ent.vtag, ent.seq)            # wfq

    def peek(self) -> Optional[SchedEntry]:
        if not self._q:
            return None
        return min(self._q, key=self._key)

    def pop(self) -> Optional[SchedEntry]:
        ent = self.peek()
        if ent is None:
            return None
        self._q.remove(ent)
        if self.policy == "wfq":
            self._vnow = max(self._vnow, ent.vtag)
        return ent

    # ---------------------------------------------------------------- restore
    def restore_entry(self, ent: SchedEntry) -> None:
        """Re-enqueue an entry rebuilt from a ``GenerationServer``
        snapshot. Bypasses admission control (the request was admitted on
        the captured server) and preserves its ``seq``/``vtag``/flags so
        pop order survives the migration; the internal seq counter is
        bumped past it so new submissions order after restored work."""
        self._q.append(ent)
        self._seq = max(self._seq, ent.seq + 1)
        self.submitted += 1
        if self._m_submitted is not None:
            self._m_submitted.inc(tenant=ent.tenant)

    def restore_state(self, vnow: float,
                      tenant_tag: Dict[str, float]) -> None:
        """Adopt a snapshot's WFQ virtual time so restored tenants keep
        the fair-share debt they had accrued on the captured server."""
        self._vnow = max(self._vnow, float(vnow))
        for t, tag in tenant_tag.items():
            self._tenant_tag[t] = max(self._tenant_tag.get(t, 0.0),
                                      float(tag))

    # --------------------------------------------------------------- removal
    def remove(self, rid: int) -> Optional[SchedEntry]:
        """Remove a waiting entry by rid without touching the cancelled
        counter — the quarantine path uses this (a quarantined request is
        ``failed``, not ``cancelled``, and the metrics must not lie)."""
        for ent in self._q:
            if ent.rid == rid:
                self._q.remove(ent)
                return ent
        return None

    def cancel(self, rid: int) -> Optional[SchedEntry]:
        """Remove a waiting entry by rid; returns it (or None if the rid
        is not queued — it may be running, finished, or unknown)."""
        ent = self.remove(rid)
        if ent is not None:
            self.cancelled += 1
            if self._m_cancelled is not None:
                self._m_cancelled.inc()
        return ent

    def expire(self) -> List[SchedEntry]:
        """Drop and return every never-started entry whose deadline has
        passed. Preempted entries are exempt: their work (host-side KV,
        or a partial prefill) is already paid for — kill those with
        :meth:`cancel`, not a timer."""
        now = self.now()
        out = [e for e in self._q
               if e.deadline is not None and e.deadline <= now
               and not e.started]
        for e in out:
            self._q.remove(e)
        self.expired += len(out)
        if out and self._m_expired is not None:
            self._m_expired.inc(len(out))
        return out

    def __len__(self) -> int:
        return len(self._q)

    def waiting(self) -> List[SchedEntry]:
        """Current queue in pop order (for introspection/tests)."""
        return sorted(self._q, key=self._key)

    def kv_demand(self) -> int:
        """Aggregate fresh-block demand of the waiting queue — the sum of
        every annotated ``SchedEntry.kv_need``. The admission gate
        refreshes annotations as it scans, so this tracks the tier-aware
        cost of draining the backlog (fleet routing reads it through
        ``GenerationServer.load_metrics`` as ``queued_kv_demand``);
        entries the gate has not seen yet contribute 0."""
        return sum(e.kv_need for e in self._q if e.kv_need is not None)

    def adapter_demand(self) -> List[str]:
        """Distinct adapter names the queue wants, in pop-priority order —
        the policy's view of adapter residency pressure. The server replays
        this through ``AdapterPool.warm`` so that under WFQ the adapters of
        high-share tenants stay most-recently-used in the pool's LRU and
        evict last."""
        out: List[str] = []
        seen = set()
        for ent in self.waiting():
            a = ent.adapter
            if a is not None and a not in seen:
                seen.add(a)
                out.append(a)
        return out
