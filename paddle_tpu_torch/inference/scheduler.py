"""Request queue for ``GenerationServer`` — the FIFO policy of
``paddle_tpu/inference/scheduler.py`` (what ``policy=None`` selects there).

Host-only: the queue never touches the device. Priorities, deadlines,
weighted fair queuing, admission control and preemption requeue are not
ported yet; :meth:`Scheduler.adapter_demand` ranks waiting LoRA adapters
in FIFO order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

__all__ = ["SchedEntry", "Scheduler"]


@dataclass
class SchedEntry:
    """One waiting request as the scheduler sees it; ``req`` is opaque."""

    req: Any
    rid: int
    adapter: Optional[str] = None


class Scheduler:
    """Submission-order waiting queue."""

    def __init__(self):
        self._q: List[SchedEntry] = []

    def submit(self, req: Any, rid: int,
               adapter: Optional[str] = None) -> SchedEntry:
        ent = SchedEntry(req=req, rid=rid, adapter=adapter)
        self._q.append(ent)
        return ent

    def peek(self) -> Optional[SchedEntry]:
        return self._q[0] if self._q else None

    def pop(self) -> Optional[SchedEntry]:
        return self._q.pop(0) if self._q else None

    def adapter_demand(self) -> List[str]:
        """Distinct adapter names the queue wants, in pop order — replayed
        through ``AdapterPool.warm`` so the adapters of the next requests
        evict last."""
        out: List[str] = []
        seen = set()
        for ent in self._q:
            a = ent.adapter
            if a is not None and a not in seen:
                seen.add(a)
                out.append(a)
        return out

    def __len__(self) -> int:
        return len(self._q)
