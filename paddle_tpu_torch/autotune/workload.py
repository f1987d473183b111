"""Seeded serving workloads, decoupled from the serving configuration —
port of ``paddle_tpu/autotune/workload.py`` (host numpy and the standard
library only: the same draws, request for request, at the same spec).

The autotuner's whole premise is that two candidate configs are compared
on *identical* traffic — same prompts, same arrival instants, same
priorities, byte for byte. Before this module, ``serving_benchmark``
drew its traffic lazily from one ``RandomState`` that warmup bursts
also consumed, so the number of warmup requests (a function of
``--slots`` / ``--pool-frac`` — i.e. of the CONFIG) shifted the rng
state under the measured trace: two candidates at the same ``--seed``
saw different workloads and their tok/s were not comparable.

:class:`WorkloadSpec` fixes that by construction. It names only
*workload* knobs (request count, prompt-length ladder, arrival process,
priority mix, adapter fan-out, seed) — no serving knob appears — and
:func:`draw_traffic` derives the complete trace up front from a rng
seeded by the spec alone. Serving-config knobs cannot reach the draw.
``signature()`` hashes the drawn trace, so a tuned profile can record
exactly which workload it was tuned against and a replay can verify it
is measuring the same thing.

Everything here is host-side numpy + stdlib; nothing touches a device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: prompt-length ladders (tokens) — mirror serving_benchmark's buckets
SHORT_PROMPT_LADDER: Tuple[int, ...] = (16, 30, 64, 100, 128)
LONG_PROMPT_LADDER: Tuple[int, ...] = (64, 128, 256, 400, 512)
#: log-spaced long-context rungs (serving_benchmark --long-context);
#: CPU-scale workloads pass an explicit smaller ladder instead
LONG_CONTEXT_LADDER: Tuple[int, ...] = (8192, 16384, 32768, 65536, 131072)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declarative serving workload. Only workload knobs live here —
    adding a serving-config field to this class is a bug (it would
    re-couple traffic to the thing being tuned)."""

    requests: int = 16
    max_new: int = 32
    prompt_ladder: Tuple[int, ...] = SHORT_PROMPT_LADDER
    vocab_size: int = 256
    repeat_suffix: bool = False
    mixed_priority: bool = False
    lora_adapters: int = 0
    #: open-loop arrivals at this rate (req/s) in ``burst``-sized clumps;
    #: None = closed-loop (everything submitted up front)
    arrival_rate: Optional[float] = None
    burst: int = 4
    #: long-context axis: with the default ladder, swaps in the
    #: log-spaced 8k-128k LONG_CONTEXT_LADDER (an explicit ladder — a
    #: CPU-scaled one — always wins)
    long_context: bool = False
    #: fraction [0,1] of every prompt replaced by ONE shared per-seed
    #: token prefix — the cross-request prefix-cache / warm-tier workload
    shared_prefix_frac: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.long_context \
                and tuple(self.prompt_ladder) == SHORT_PROMPT_LADDER:
            object.__setattr__(self, "prompt_ladder", LONG_CONTEXT_LADDER)
        if not (0.0 <= self.shared_prefix_frac <= 1.0):
            raise ValueError(
                f"shared_prefix_frac must be in [0, 1], got "
                f"{self.shared_prefix_frac}")
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1, got {self.requests}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.vocab_size < 2:
            raise ValueError(
                f"vocab_size must be >= 2, got {self.vocab_size}")
        if not self.prompt_ladder:
            raise ValueError("prompt_ladder must be non-empty")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["prompt_ladder"] = list(self.prompt_ladder)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadSpec":
        kw = dict(d)
        kw["prompt_ladder"] = tuple(kw.get("prompt_ladder",
                                           SHORT_PROMPT_LADDER))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})

    def truncated(self, requests: int) -> "WorkloadSpec":
        """Same spec, fewer requests — the successive-halving short rung.
        The drawn trace is a strict prefix of the full trace (the draws
        are per-request and order-stable), so short-rung measurements
        see the same opening traffic the full rung does."""
        return dataclasses.replace(self, requests=min(requests,
                                                      self.requests))


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One pre-drawn request: everything ``submit()`` needs."""

    prompt: Tuple[int, ...]
    max_new: int
    priority: int
    tenant: str
    adapter: Optional[str]


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A fully-drawn trace: requests in submit order plus the open-loop
    arrival schedule ``[(t_seconds, n_requests), ...]`` (empty =
    closed-loop burst)."""

    requests: Tuple[TrafficRequest, ...]
    schedule: Tuple[Tuple[float, int], ...]
    motif: Tuple[int, ...]

    def signature(self) -> str:
        """Stable hash of the trace — two configs replaying the same
        signature measured the same workload."""
        blob = json.dumps(
            [[list(r.prompt), r.max_new, r.priority, r.tenant, r.adapter]
             for r in self.requests]
            + [[round(t, 9), n] for t, n in self.schedule],
            sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def _draw_request(rng: np.random.RandomState, spec: WorkloadSpec,
                  index: int, motif: Sequence[int],
                  shared: Sequence[int] = ()) -> TrafficRequest:
    ln = int(rng.choice(spec.prompt_ladder))
    if spec.repeat_suffix:
        # tile one shared motif: greedy decoding locks onto the
        # repetition (the speculative showcase) and the shared prefix
        # exercises the prefix cache
        prompt = tuple((list(motif) * (ln // len(motif) + 1))[:ln])
    else:
        prompt = tuple(int(t) for t in
                       rng.randint(1, spec.vocab_size, ln))
    if spec.shared_prefix_frac > 0.0:
        # overlay the per-seed shared prefix (prompt lengths still come
        # from the ladder draw above, so the stream stays order-stable)
        k = int(ln * spec.shared_prefix_frac)
        prompt = tuple(shared[:k]) + prompt[k:]
    prio, tenant, adapter = 1, "default", None
    if spec.mixed_priority:
        prio = (0, 1, 2)[index % 3]
        tenant = ("a", "b")[index % 2]
    if spec.lora_adapters:
        adapter = f"a{index % spec.lora_adapters}"
        tenant = f"t{index % spec.lora_adapters}"
    return TrafficRequest(prompt=prompt, max_new=spec.max_new,
                          priority=prio, tenant=tenant, adapter=adapter)


def draw_traffic(spec: WorkloadSpec) -> Traffic:
    """Derive the complete trace from the spec — deterministically, up
    front, from a rng only the spec seeds. The serving config is not an
    input; it *cannot* perturb the draw."""
    rng = np.random.RandomState(spec.seed)
    motif = tuple(int(t) for t in
                  rng.randint(1, spec.vocab_size, 8))
    shared: Tuple[int, ...] = ()
    if spec.shared_prefix_frac > 0.0:
        # drawn only when the knob is on, from its own xor-seeded
        # stream — enabling it must not shift the per-request draws,
        # and specs without it keep their historical signatures
        srng = np.random.RandomState((spec.seed + 0x5AFE) & 0x7FFFFFFF)
        shared = tuple(int(t) for t in srng.randint(
            1, spec.vocab_size, max(spec.prompt_ladder)))
    reqs = tuple(_draw_request(rng, spec, i, motif, shared)
                 for i in range(spec.requests))
    schedule: List[Tuple[float, int]] = []
    if spec.arrival_rate is not None:
        t, left = 0.0, spec.requests
        while left > 0:
            n = min(spec.burst, left)
            schedule.append((t, n))
            left -= n
            t += float(rng.exponential(spec.burst / spec.arrival_rate))
    return Traffic(requests=reqs, schedule=tuple(schedule), motif=motif)


def warmup_traffic(spec: WorkloadSpec, n: int) -> Tuple[TrafficRequest, ...]:
    """Warmup requests from a rng stream DISJOINT from the measured
    trace (seed xor'd) — however many a config's warmup consumes, the
    measured traffic above is already fully drawn and untouched."""
    rng = np.random.RandomState((spec.seed ^ 0x5EED) & 0x7FFFFFFF)
    motif = tuple(int(t) for t in rng.randint(1, spec.vocab_size, 8))
    shared: Tuple[int, ...] = ()
    if spec.shared_prefix_frac > 0.0:
        # the SAME shared prefix as the measured trace — warmup re-hits
        # are the point of the knob (prefix cache + warm tier warm)
        srng = np.random.RandomState((spec.seed + 0x5AFE) & 0x7FFFFFFF)
        shared = tuple(int(t) for t in srng.randint(
            1, spec.vocab_size, max(spec.prompt_ladder)))
    return tuple(_draw_request(rng, spec, i, motif, shared)
                 for i in range(n))


def submit_traffic(server, requests: Sequence[TrafficRequest]) \
        -> Dict[int, TrafficRequest]:
    """Submit pre-drawn requests in order; returns {rid: request}."""
    out: Dict[int, TrafficRequest] = {}
    for r in requests:
        rid = server.submit(list(r.prompt), max_new_tokens=r.max_new,
                            priority=r.priority, tenant=r.tenant,
                            adapter=r.adapter)
        out[rid] = r
    return out
