"""Deterministic fault injection for the serving stack — re-export shim
(as ``paddle_tpu/inference/faults.py``): the substrate lives in
:mod:`paddle_tpu_torch.faults`, which the training stack shares; the hook
sites and the fire-before-replay rule are documented there."""
from __future__ import annotations

from ..faults import (NULL_INJECTOR, SITES, DataFeedFault,  # noqa: F401
                      EngineFailedError, FaultInjector, FaultPlan,
                      FaultSpec, SimulatedKill, StepFault, TickFault)

__all__ = [
    "SITES", "TickFault", "StepFault", "DataFeedFault", "SimulatedKill",
    "EngineFailedError", "FaultSpec", "FaultPlan", "FaultInjector",
    "NULL_INJECTOR",
]
