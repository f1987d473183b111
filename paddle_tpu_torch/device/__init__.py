"""Device API — port of ``paddle_tpu/device/__init__.py`` with its CUDA
meaning: the port is a CUDA build (``is_compiled_with_cuda()`` is True),
``device_count`` counts CUDA devices, :class:`Stream` / :class:`Event` /
:func:`current_stream` / :func:`synchronize` / :func:`stream_guard` wrap
``torch.cuda``'s, and :func:`memory_stats` and the ``*_memory_*``
functions read ``torch.cuda.memory_stats`` under the JAX package's key
names (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
``peak_bytes_reserved``, ``bytes_limit``), so monitoring code ports.

:func:`set_device` keeps the JAX package's meaning: it records the name
that :func:`get_device` returns and does not move where the port's entry
points run (``device=None`` still means the CUDA card, and raises without
one).
"""
from __future__ import annotations

import contextlib

import torch

_current_device = None


def _cuda(device=None) -> torch.device:
    """``None`` | int | ``"gpu:1"`` / ``"cuda:1"`` | ``torch.device`` → a
    CUDA ``torch.device`` (raising where there is no card)."""
    from .. import resolve_device

    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, str):
        plat, _, idx = device.partition(":")
        if plat not in ("gpu", "cuda"):
            raise ValueError(f"not a CUDA device: {device!r}")
        return torch.device("cuda", int(idx) if idx else 0)
    return resolve_device(device)


def get_device() -> str:
    """The name :func:`set_device` recorded, else ``"gpu:<current>"`` with
    a card and ``"cpu"`` without."""
    if _current_device is not None:
        return _current_device
    if torch.cuda.is_available():
        return f"gpu:{torch.cuda.current_device()}"
    return "cpu"


def set_device(device: str) -> str:
    """Record ``device`` as :func:`get_device`'s answer (entry points
    still default to the CUDA card, as the JAX package's do to its
    accelerator)."""
    global _current_device
    _current_device = device
    return device


def get_all_custom_device_type():
    return []


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


class Stream:
    """A CUDA stream (``torch.cuda.Stream``) with Paddle's methods."""

    def __init__(self, device=None, priority=2):
        self.device = _cuda(device)
        # Paddle's priorities: 1 high, 2 normal; CUDA's: lower is higher
        self._stream = torch.cuda.Stream(self.device,
                                         priority=-1 if priority == 1 else 0)

    @classmethod
    def _wrap(cls, stream):
        out = cls.__new__(cls)
        out.device, out._stream = stream.device, stream
        return out

    def synchronize(self):
        self._stream.synchronize()

    def wait_event(self, event):
        self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def query(self) -> bool:
        return self._stream.query()


class Event:
    """A CUDA event (``torch.cuda.Event``)."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._event = torch.cuda.Event(enable_timing=enable_timing,
                                       blocking=blocking,
                                       interprocess=interprocess)

    def record(self, stream=None):
        self._event.record(None if stream is None else stream._stream)

    def query(self) -> bool:
        return self._event.query()

    def synchronize(self):
        self._event.synchronize()

    def elapsed_time(self, end) -> float:
        return self._event.elapsed_time(end._event)


def current_stream(device=None) -> Stream:
    return Stream._wrap(torch.cuda.current_stream(_cuda(device)))


def synchronize(device=None):
    torch.cuda.synchronize(_cuda(device))


@contextlib.contextmanager
def stream_guard(stream):
    """Make ``stream`` current within the block."""
    with torch.cuda.stream(stream._stream):
        yield


# the JAX package's (PJRT's) names for the caching allocator's counters
_STAT_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
              "peak_bytes_in_use": "allocated_bytes.all.peak",
              "bytes_reserved": "reserved_bytes.all.current",
              "peak_bytes_reserved": "reserved_bytes.all.peak",
              "num_allocs": "allocation.all.allocated"}


def memory_stats(device=None) -> dict:
    """The caching allocator's counters for ``device`` under the JAX
    package's key names, with ``bytes_limit`` the card's memory."""
    dev = _cuda(device)
    raw = torch.cuda.memory_stats(dev)
    out = {k: int(raw.get(v, 0)) for k, v in _STAT_KEYS.items()}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(dev)
                             .total_memory)
    return out


def max_memory_allocated(device=None) -> int:
    return memory_stats(device)["peak_bytes_in_use"]


def memory_allocated(device=None) -> int:
    return memory_stats(device)["bytes_in_use"]


def max_memory_reserved(device=None) -> int:
    """The allocator's reserved peak."""
    return memory_stats(device)["peak_bytes_reserved"]


def memory_reserved(device=None) -> int:
    return memory_stats(device)["bytes_reserved"]


def empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class cuda:
    """``paddle.device.cuda``: the CUDA devices and their memory."""

    @staticmethod
    def device_count():
        return device_count()

    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_reserved = staticmethod(max_memory_reserved)
    memory_reserved = staticmethod(memory_reserved)
    empty_cache = staticmethod(empty_cache)
    synchronize = staticmethod(synchronize)
    current_stream = staticmethod(current_stream)
    stream_guard = staticmethod(stream_guard)
    Stream = Stream
    Event = Event
