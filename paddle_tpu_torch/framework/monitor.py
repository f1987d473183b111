"""Runtime stat counters — a copy of ``paddle_tpu/framework/monitor.py``
(which imports no JAX): named int64 counters the runtime bumps and
monitoring code scrapes (Paddle's ``StatRegistry``)."""
from __future__ import annotations

import threading
from typing import Dict


class _StatRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {}

    def add(self, name: str, delta: int = 1) -> int:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + int(delta)
            return self._stats[name]

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._stats[name] = int(value)

    def get(self, name: str) -> int:
        with self._lock:
            return self._stats.get(name, 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def reset(self, name: str = None) -> None:
        with self._lock:
            if name is None:
                self._stats.clear()
            else:
                self._stats.pop(name, None)


_registry = _StatRegistry()


def stat_registry() -> _StatRegistry:
    return _registry


def monitor_add(name: str, delta: int = 1) -> int:
    return _registry.add(name, delta)


def monitor_get(name: str) -> int:
    return _registry.get(name)
