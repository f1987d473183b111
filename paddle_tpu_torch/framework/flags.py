"""Global flag registry — a copy of ``paddle_tpu/framework/flags.py``
(which imports no JAX; the port keeps its own copy rather than import the
JAX package): one typed registry with ``FLAGS_<name>`` environment
overrides, the same flag names and defaults, and ``set_flags`` /
``get_flags``.

One addition: a flag may carry a hook (:meth:`FlagRegistry.on_set`),
called with the flag's value when it is defined and whenever it is set.
``check_nan_inf``'s hook (``framework/dispatch.py``) turns the scan of
every operator's output on and off.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]
    value: Any = None
    hook: Optional[Callable[[Any], None]] = None


def _parse_bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes", "on")


class FlagRegistry:
    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "") -> None:
        if isinstance(default, bool):
            parser: Callable[[str], Any] = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
        with self._lock:
            if name in self._flags:
                return
            flag = _Flag(name=name, default=default, help=help, parser=parser)
            env = os.environ.get(f"FLAGS_{name}")
            flag.value = parser(env) if env is not None else default
            self._flags[name] = flag

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"Unknown flag: {name!r}")
            f = self._flags[name]
            f.value = f.parser(value) if isinstance(value, str) else value
        if f.hook is not None:
            f.hook(f.value)

    def on_set(self, name: str, hook: Callable[[Any], None]) -> None:
        """Call ``hook(value)`` now and whenever ``name`` is set."""
        with self._lock:
            f = self._flags[name]
            f.hook = hook
        hook(f.value)

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"Unknown flag: {name!r}")
            return self._flags[name].value

    def has(self, name: str) -> bool:
        return name in self._flags

    def all(self) -> Dict[str, Any]:
        with self._lock:
            return {k: f.value for k, f in self._flags.items()}


GLOBAL_FLAGS = FlagRegistry()

# Core flags (subset mirroring the reference's most-used ones).
GLOBAL_FLAGS.define("check_nan_inf", False,
                    "Scan op outputs for NaN/Inf (ref FLAGS_check_nan_inf)")
GLOBAL_FLAGS.define("deterministic", False, "Force deterministic execution")
GLOBAL_FLAGS.define("default_dtype", "float32", "Default floating dtype")
GLOBAL_FLAGS.define("eager_delete_tensor_gb", 0.0,
                    "Compat no-op: the caching allocator manages memory")
GLOBAL_FLAGS.define("use_pallas_kernels", True,
                    "Use the hand-written kernels for hot ops (the JAX "
                    "package's name)")
GLOBAL_FLAGS.define("log_level", "WARNING", "Python logging level")
GLOBAL_FLAGS.define("profiler_trace_dir", "",
                    "Directory for profiler trace dumps")


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags parity (ref python/paddle/fluid/framework.py:7629)."""
    for k, v in flags.items():
        name = k[6:] if k.startswith("FLAGS_") else k
        GLOBAL_FLAGS.set(name, v)


def get_flags(flags) -> Dict[str, Any]:
    """paddle.get_flags parity."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        name = k[6:] if k.startswith("FLAGS_") else k
        out[k] = GLOBAL_FLAGS.get(name)
    return out
