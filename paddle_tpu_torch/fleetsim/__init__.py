"""fleetsim: seeded discrete-event traffic simulation for the fleet — port
of ``paddle_tpu/fleetsim/`` (host numpy and the standard library; the same
draws and the same reports as the JAX package at one seed).

A "day" of traffic from millions of synthetic users, compressed into
seconds of host time: :mod:`traffic` draws the whole day's session
arrivals in one vectorized, seeded pass (diurnal arrival curve, tenant
Zipf, shared-prefix populations, long-tail context lengths — the
``autotune/workload.py`` distributions at fleet scale); :mod:`sim`
replays them against an analytic replica service model under the virtual
clock in :mod:`clock`, driving the elastic autoscaler
(:mod:`paddle_tpu_torch.inference.autoscale`) exactly as a live control
loop would; and :func:`~paddle_tpu_torch.fleetsim.sim.replay_slice`
materializes a slice of the same trace into real prompts and pushes
them through a real :class:`~paddle_tpu_torch.inference.fleet.FleetRouter`
(in-process or subprocess replicas) so the simulator's claims stay
anchored to token-exact execution.

Everything in this package is deterministic at a seed and runs in
*virtual* seconds — no ``time.sleep``, no wall-clock reads: two runs at
one seed produce byte-identical JSON.
"""
from .clock import VirtualClock
from .sim import FleetSimulation, ReplicaServiceModel, replay_slice
from .traffic import (DayTrafficSpec, SessionTrace, draw_day,
                      expected_session_rate, materialize_session)

__all__ = [
    "DayTrafficSpec", "FleetSimulation", "ReplicaServiceModel",
    "SessionTrace", "VirtualClock", "draw_day", "expected_session_rate",
    "materialize_session", "replay_slice",
]
