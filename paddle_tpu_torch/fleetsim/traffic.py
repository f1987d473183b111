"""Day-scale synthetic traffic: millions of seeded session arrivals — port
of ``paddle_tpu/fleetsim/traffic.py`` (the same numpy ``RandomState``
draws, array for array, at the same spec).

This is ``autotune/workload.py`` lifted to fleet scale. A
:class:`DayTrafficSpec` names only *traffic* knobs — session count,
diurnal curve shape, tenant Zipf skew, shared-prefix populations,
long-tail context mix, seed — and :func:`draw_day` derives the whole
day in a handful of vectorized numpy passes: one million arrivals draw
in well under a second, and the result is a :class:`SessionTrace` of
parallel arrays (times sorted ascending) that the event loop walks
with an index, no per-session Python objects.

Distributions:

- **arrival times** — an inhomogeneous Poisson-like process with a
  diurnal intensity ``λ(t) ∝ 1 + a·cos(2π(t - peak)/day)`` drawn by
  inverse-CDF over a fine grid (vectorized, deterministic). The
  analytic form is exported as :func:`expected_session_rate` — the
  autoscaler's forecast looks *ahead* on this curve, which is exactly
  the "cost model predicting capacity ahead of the diurnal curve"
  contract;
- **tenants** — Zipf over ``tenants`` ranks (heavy head, long tail),
  like real multi-tenant serving;
- **prefix populations** — Zipf over ``populations`` shared-prompt
  groups; sessions in one population share a prompt prefix (system
  prompt / few-shot header), the fleet's prefix-cache workload;
- **context lengths** — the workload ladders, with a ``longtail_frac``
  mixture of the long ladder for the heavy tail.

:func:`materialize_session` turns trace row *i* into concrete token
ids on demand — seeded per (population, session), so any slice of the
trace materializes identically regardless of which sessions execute.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..autotune.workload import (LONG_PROMPT_LADDER, SHORT_PROMPT_LADDER,
                                 TrafficRequest)

__all__ = [
    "DayTrafficSpec", "SessionTrace", "draw_day", "expected_session_rate",
    "materialize_session", "zipf_weights",
]


@dataclasses.dataclass(frozen=True)
class DayTrafficSpec:
    """Declarative day of fleet traffic. Only traffic knobs live here —
    the serving config cannot reach the draw (same contract as
    :class:`~paddle_tpu_torch.autotune.workload.WorkloadSpec`)."""

    sessions: int = 1_000_000
    day_s: float = 86_400.0
    #: diurnal amplitude a in [0, 1): intensity swings (1-a)..(1+a)
    #: around the mean — 0 is flat, 0.8 is a pronounced peak
    diurnal_amplitude: float = 0.6
    #: peak time as a fraction of the day (0.58 ≈ early afternoon)
    peak_frac: float = 0.58
    tenants: int = 8
    tenant_zipf_s: float = 1.1
    populations: int = 64
    population_zipf_s: float = 1.05
    #: shared tokens at the head of every prompt in a population,
    #: truncated to prompt_len - 1 so every session keeps unique tail
    shared_prefix_tokens: int = 32
    prompt_ladder: Tuple[int, ...] = SHORT_PROMPT_LADDER
    longtail_ladder: Tuple[int, ...] = LONG_PROMPT_LADDER
    #: fraction of sessions drawing from the long-tail context ladder
    longtail_frac: float = 0.05
    max_new_ladder: Tuple[int, ...] = (8, 16, 32, 64)
    vocab_size: int = 128
    seed: int = 0

    def __post_init__(self) -> None:
        if self.sessions < 1:
            raise ValueError(f"sessions must be >= 1, got {self.sessions}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(
                f"diurnal_amplitude must be in [0, 1), got "
                f"{self.diurnal_amplitude}")
        if not 0.0 <= self.longtail_frac <= 1.0:
            raise ValueError(
                f"longtail_frac must be in [0, 1], got "
                f"{self.longtail_frac}")
        if self.tenants < 1 or self.populations < 1:
            raise ValueError("tenants and populations must be >= 1")
        if self.day_s <= 0:
            raise ValueError(f"day_s must be > 0, got {self.day_s}")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("prompt_ladder", "longtail_ladder", "max_new_ladder"):
            d[k] = list(d[k])
        return d


@dataclasses.dataclass(frozen=True)
class SessionTrace:
    """One drawn day as parallel arrays (index = session, times sorted).
    ``mean_tokens`` is the per-session expected token work (prompt +
    new) — the bridge from session rate to token demand."""

    spec: DayTrafficSpec
    t: np.ndarray            # float64, ascending arrival seconds
    tenant: np.ndarray       # int32 tenant rank
    population: np.ndarray   # int32 prefix-population rank
    prompt_len: np.ndarray   # int32
    max_new: np.ndarray      # int32

    def __len__(self) -> int:
        return int(self.t.shape[0])

    @property
    def mean_tokens(self) -> float:
        return float(np.mean(self.prompt_len + self.max_new))

    def tokens(self, i: int) -> int:
        return int(self.prompt_len[i] + self.max_new[i])

    def signature(self) -> str:
        """Stable hash over every drawn array — two sims replaying the
        same signature saw byte-identical traffic."""
        h = hashlib.sha256()
        for a in (self.t, self.tenant, self.population,
                  self.prompt_len, self.max_new):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n: p(r) ∝ r^-s."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def expected_session_rate(spec: DayTrafficSpec, t: float) -> float:
    """Analytic arrival intensity (sessions/second) at virtual time
    ``t`` — the diurnal curve the draw inverts. The autoscaler's
    forecast evaluates this at ``t + horizon``: capacity decisions lead
    the curve instead of chasing it."""
    a = spec.diurnal_amplitude
    phase = 2.0 * np.pi * ((t / spec.day_s) - spec.peak_frac)
    return float(spec.sessions / spec.day_s * (1.0 + a * np.cos(phase)))


def draw_day(spec: DayTrafficSpec) -> SessionTrace:
    """Draw the complete day, vectorized and seeded by the spec alone.

    Arrival times come from inverse-CDF sampling of the diurnal
    intensity on a 1-minute grid; attribute draws are independent
    vectorized passes on the same rng, so the whole trace is a pure
    function of the spec."""
    rng = np.random.RandomState(spec.seed & 0x7FFFFFFF)
    n = spec.sessions

    # inverse-CDF arrival times on a fine grid: cumulative intensity
    # Λ(t) is strictly increasing (amplitude < 1), so interp is exact
    # to grid resolution and vectorizes over all n draws at once
    grid = np.linspace(0.0, spec.day_s, 1441)
    lam = 1.0 + spec.diurnal_amplitude * np.cos(
        2.0 * np.pi * (grid / spec.day_s - spec.peak_frac))
    cum = np.concatenate([[0.0], np.cumsum((lam[1:] + lam[:-1]) * 0.5)])
    cum /= cum[-1]
    u = rng.uniform(0.0, 1.0, n)
    t = np.sort(np.interp(u, cum, grid))

    tenant = rng.choice(spec.tenants, size=n,
                        p=zipf_weights(spec.tenants,
                                       spec.tenant_zipf_s)).astype(np.int32)
    population = rng.choice(
        spec.populations, size=n,
        p=zipf_weights(spec.populations,
                       spec.population_zipf_s)).astype(np.int32)

    short = np.asarray(spec.prompt_ladder, dtype=np.int32)
    long_ = np.asarray(spec.longtail_ladder, dtype=np.int32)
    prompt_len = short[rng.randint(0, len(short), n)]
    tail = rng.uniform(0.0, 1.0, n) < spec.longtail_frac
    if tail.any():
        prompt_len = np.where(
            tail, long_[rng.randint(0, len(long_), n)], prompt_len)
    max_new = np.asarray(spec.max_new_ladder, dtype=np.int32)[
        rng.randint(0, len(spec.max_new_ladder), n)]

    return SessionTrace(spec=spec, t=t, tenant=tenant,
                        population=population,
                        prompt_len=prompt_len.astype(np.int32),
                        max_new=max_new.astype(np.int32))


def materialize_session(trace: SessionTrace, i: int,
                        max_len: Optional[int] = None) -> TrafficRequest:
    """Concrete token ids for trace row ``i`` — a shared per-population
    prefix (seeded by the population, identical across every session in
    it: the prefix-cache workload) followed by a per-session unique
    tail. Deterministic per (spec.seed, population, i) so ANY slice of
    the trace materializes the same prompts. ``max_len`` clips
    prompt+new to a CPU-scale engine's window."""
    spec = trace.spec
    ln = int(trace.prompt_len[i])
    new = int(trace.max_new[i])
    if max_len is not None:
        ln = max(1, min(ln, max_len - new))
    pop = int(trace.population[i])
    k = min(spec.shared_prefix_tokens, ln - 1)
    prng = np.random.RandomState((spec.seed ^ 0x50C1A1 ^ pop) & 0x7FFFFFFF)
    prefix = prng.randint(1, spec.vocab_size, max(k, 1))[:k]
    srng = np.random.RandomState((spec.seed ^ 0x7AF1 ^ (i * 2654435761)) & 0x7FFFFFFF)
    tail = srng.randint(1, spec.vocab_size, ln - k)
    prompt = tuple(int(x) for x in prefix) + tuple(int(x) for x in tail)
    return TrafficRequest(prompt=prompt, max_new=new, priority=1,
                          tenant=f"t{int(trace.tenant[i])}", adapter=None)
