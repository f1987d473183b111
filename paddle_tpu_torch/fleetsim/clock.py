"""Virtual time for fast-time simulation — port of
``paddle_tpu/fleetsim/clock.py``.

The whole serving stack already accepts ``clock=`` callables (that is
what makes chaos replays deterministic); a
:class:`VirtualClock` is the simulation's implementation of that seam:
a number that only moves when the event loop moves it. A simulated day
is 86_400 *virtual* seconds and however few wall milliseconds the loop
needs. Monotonicity is enforced — an event popped out of order would
otherwise silently corrupt every latency metric downstream.
"""
from __future__ import annotations

__all__ = ["VirtualClock"]


class VirtualClock:
    """Injectable fast-time source: ``clock()`` reads, ``advance_to``
    moves. Reading never advances — unlike the autotuner's counting
    clock, simulation time belongs to the EVENT LOOP, not to whoever
    happens to look at the clock most often."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        """Jump to absolute virtual time ``t`` (monotone)."""
        t = float(t)
        if t < self._now:
            raise ValueError(
                f"virtual clock cannot run backwards: at {self._now}, "
                f"asked to advance_to {t}")
        self._now = t
        return self._now

    def advance(self, dt: float) -> float:
        """Advance by ``dt`` virtual seconds (non-negative)."""
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self._now += float(dt)
        return self._now
