"""Optimizer state in pinned host memory — port of the JAX engine's
``offload_opt_state=True`` (``paddle_tpu/parallel/engine.py:66-160``, the
windowed transfer chain of ``_offloaded_update`` ``:480-566``).

Every trainable parameter's slots (AdamW's moments, a master weight) live
in one pinned host allocation (``graphs.pinned_zeros``: a plain CPU
allocation pinned in place; the caching host allocator would round each
block up to a power of two). An update walks the parameters in ``PT_OFFLOAD_ORDER``
(``backward``, the default: reversed sorted names, so that the last
layers' gradients, made first by the backward, are updated first;
``forward``: sorted names) and, for each, copies its slots into one of
``PT_OFFLOAD_WINDOW`` (default 2) preallocated staging sets on the device,
runs the optimizer's per-parameter rule on them (the AdamW kernel, row
10) and copies them back:

* host to device on a copy stream, in order; parameter i's copy waits for
  the copy back of parameter i - W, the previous user of its staging set
  (at most W sets of slots on the device);
* the update on the compute stream, after its slots have arrived;
* device to host on a second copy stream, after the update.

The two copy streams are forked from the compute stream at the start and
joined into it at the end, so the whole chain can be captured in a CUDA
graph (the engine's train graph): the buffers are preallocated and the
host side pinned. The values are those of the resident update, bit for
bit: the same rule on the same numbers. :func:`schedule` is the chain's
plan as data (the order, the staging set of each parameter and the
copy-back it waits for), which the CPU tests hold to the JAX rule; on CPU
tensors (the tests) the copies are plain copies.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from ..graphs import pinned_zeros


def window_and_order() -> Tuple[int, str]:
    """``PT_OFFLOAD_WINDOW`` (at least 1, default 2) and
    ``PT_OFFLOAD_ORDER`` (``backward`` or ``forward``; anything else raises
    ValueError, as in JAX)."""
    window = max(1, int(os.environ.get("PT_OFFLOAD_WINDOW", "2")))
    order = os.environ.get("PT_OFFLOAD_ORDER", "backward")
    if order not in ("backward", "forward"):
        raise ValueError(f"PT_OFFLOAD_ORDER must be 'backward' or "
                         f"'forward', got {order!r}")
    return window, order


def schedule(names, window: int, order: str) -> List[Tuple[str, int,
                                                            Optional[int]]]:
    """The chain's plan: ``[(name, staging set, waits_for)]`` in update
    order, where ``waits_for`` is the index (in this list) of the update
    whose copy back must finish before this parameter's slots may be
    copied into the same staging set (None for the first ``window``)."""
    names = sorted(names)
    if order == "backward":
        names = names[::-1]
    return [(n, i % window, i - window if i >= window else None)
            for i, n in enumerate(names)]


def _aligned(n: int) -> int:
    """``n`` fp32 elements rounded up to 16 bytes (the AdamW kernel's
    vector access)."""
    return -(-n // 4) * 4


class OffloadedState:
    """The host-resident slots of ``named`` ([(name, param)]) for
    ``optimizer``, their staging sets and the per-step update chain.

    ``host``: {name: {slot: host tensor}} (views of one pinned
    allocation); the optimizer's ``_accumulators`` is set to it, so its
    ``state_dict`` and the engine's ``engine_state_dict`` read it, and its
    updates walk the parameters through :meth:`run`."""

    def __init__(self, optimizer, named, window: int = 2,
                 order: str = "backward"):
        self.optimizer = optimizer
        self.params = dict(named)
        self.plan = schedule(self.params, window, order)
        self.window = window
        dev = next(iter(self.params.values())).device
        self.device = dev
        # the slots' sizes from meta tensors (nothing allocated), then one
        # parameter's slots made on the device at a time and copied to
        # their place in the host allocation
        sizes = {}
        for name, p in self.params.items():
            with torch.no_grad():
                slots = optimizer._create_slots(
                    torch.empty_like(p, device="meta"))
            sizes[name] = sum(_aligned(v.numel()) for v in slots.values())
        total = sum(v for v in sizes.values())
        self.host_bytes = 4 * total
        self.pinned = dev.type == "cuda"
        self._flat = (pinned_zeros(total, torch.float32) if self.pinned
                      else torch.empty(total, dtype=torch.float32))
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}
        off = 0
        for name, p in self.params.items():
            with torch.no_grad():
                slots = optimizer._create_slots(p)
            self.host[name] = {}
            for k, v in slots.items():
                if v.dtype != torch.float32:
                    raise TypeError(f"offload_opt_state keeps fp32 slots, "
                                    f"{name}.{k} is {v.dtype}")
                h = self._flat[off:off + v.numel()].view(v.shape)
                h.copy_(v)
                self.host[name][k] = h
                off += _aligned(v.numel())
            del slots
        optimizer._accumulators = self.host
        optimizer._runner = self.run
        # W staging sets, each as large as the largest parameter's slots
        most = max(sizes.values())
        self.staging = [torch.empty(most, dtype=torch.float32, device=dev)
                        for _ in range(min(window, len(self.plan)))]
        self.staging_bytes = 4 * most * len(self.staging)
        self._streams = ((torch.cuda.Stream(dev), torch.cuda.Stream(dev))
                         if dev.type == "cuda" else None)

    def _staged(self, name, k):
        off = 0
        out = {}
        for slot, h in self.host[name].items():
            out[slot] = self.staging[k][off:off + h.numel()].view(h.shape)
            off += _aligned(h.numel())
        return out

    def run(self, named_params_grads, lr, step):
        """The optimizer's walk over the parameters (``Optimizer.
        _runner``): every parameter's update through the windowed chain."""
        grads = {n: (p, g) for n, p, g in named_params_grads}
        opt = self.optimizer
        if self._streams is None:
            for name, k, _ in self.plan:
                p, g = grads[name]
                staged = self._staged(name, k)
                for slot, h in self.host[name].items():
                    staged[slot].copy_(h)
                opt._apply_one(name, p, g, lr, step, staged)
                for slot, h in self.host[name].items():
                    h.copy_(staged[slot])
            return
        h2d, d2h = self._streams
        main = torch.cuda.current_stream(self.device)
        h2d.wait_stream(main)
        d2h.wait_stream(main)
        back = []
        for i, (name, k, waits) in enumerate(self.plan):
            p, g = grads[name]
            staged = self._staged(name, k)
            with torch.cuda.stream(h2d):
                if waits is not None:
                    h2d.wait_event(back[waits])
                for slot, h in self.host[name].items():
                    staged[slot].copy_(h, non_blocking=True)
                arrived = torch.cuda.Event()
                arrived.record(h2d)
            main.wait_event(arrived)
            opt._apply_one(name, p, g, lr, step, staged)
            updated = torch.cuda.Event()
            updated.record(main)
            with torch.cuda.stream(d2h):
                d2h.wait_event(updated)
                for slot, h in self.host[name].items():
                    h.copy_(staged[slot], non_blocking=True)
                done = torch.cuda.Event()
                done.record(d2h)
            back.append(done)
        main.wait_stream(h2d)
        main.wait_stream(d2h)

    def bytes_per_step(self) -> int:
        """Bytes copied each way a step (every slot once)."""
        return sum(h.numel() * 4 for slots in self.host.values()
                   for h in slots.values())
