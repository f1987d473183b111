"""CUDA graph capture and replay, shared by the serving executor
(``inference/executor.py``) and the train engine (``parallel/engine.py``):
the port's counterpart of the JAX package's compiled programs.

A program is a Python body over static tensors (inputs copied in before
each run, outputs read after). :func:`warm_up` runs a body once eagerly on
a side stream, which creates what a capture cannot (the libraries' handles
and workspaces, a kernel library's first build, tensor maps cached on the
host); :func:`capture` records a body into a ``torch.cuda.CUDAGraph``,
registering the ``torch.Generator``s it draws from so that each replay
advances them as an eager run would; :class:`Graph` replays it. A capture
launches nothing, so the launches its wrappers count are taken back
(``ops.captured_launches``) and each replay adds them again: N replays
count what N eager runs would. A capture that fails raises: nothing here
falls back to an eager run. While ``FLAGS_check_nan_inf`` is set, a
graphed program refuses to run (:func:`refuse_scan`): the scan reads
every operator's output on the host, which a capture forbids, and the
JAX package's compiled programs raise under the flag too.

:func:`pinned_zeros` makes the host buffers a graph copies to and from: a
plain CPU allocation pinned in place (``cudaHostRegister``) rather than a
block of PyTorch's caching host allocator, which rounds each block up to
a power of two and tracks its blocks' uses with events.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref

import torch

__all__ = ["Graph", "capture", "pinned_zeros", "refuse_scan", "warm_up",
           "weights_key"]


def refuse_scan() -> None:
    """Raise RuntimeError while ``FLAGS_check_nan_inf`` is set: a graphed
    program cannot read its operators' outputs on the host."""
    from .framework.flags import GLOBAL_FLAGS

    if GLOBAL_FLAGS.get("check_nan_inf"):
        raise RuntimeError(
            "FLAGS_check_nan_inf is set: its scan reads every operator's "
            "output on the host, which a CUDA graph cannot (the JAX "
            "package's compiled programs raise under the flag too); clear "
            "the flag, or run the program eagerly (graphs = False)")


def warm_up(body, device):
    """Run ``body`` eagerly on a side stream (ordered after the current
    stream's work, and the current stream after it); returns its
    output. The first run of a graphed program: refused while
    ``FLAGS_check_nan_inf`` is set (:func:`refuse_scan`)."""
    refuse_scan()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = body()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def capture(body, generators=(), pool=None) -> "Graph":
    """Capture ``body`` into a CUDA graph (in ``pool``, a
    ``graph_pool_handle``, when given) that draws from ``generators``
    (the default CUDA generator is registered by PyTorch itself)."""
    from . import ops

    refuse_scan()
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with ops.captured_launches() as launches:
        with torch.cuda.graph(graph, pool=pool):
            out = body()
    return Graph(graph, out, launches, tuple(generators))


@dataclasses.dataclass
class Graph:
    """One captured program: the graph, its static output, the launches
    one replay makes ({kernel: launches}) and the generators it draws
    from."""

    graph: object
    out: object
    launches: dict
    generators: tuple

    def replay(self):
        """Replay the graph, count its launches; returns its outputs
        (refused while ``FLAGS_check_nan_inf`` is set)."""
        from . import ops

        refuse_scan()
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.out


def weights_key(*tensors) -> tuple:
    """Each tensor's address, dtype and shape: what a graph reads by
    address. ``tensors``: iterables of tensors."""
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in itertools.chain(*tensors))


def pinned_zeros(shape, dtype) -> torch.Tensor:
    """A zeroed CPU tensor pinned in place for the card's copies (unpinned
    when it is collected); raises when pinning fails. The zero fill runs
    on every intra-op thread, so the pages are faulted in in parallel
    before ``cudaHostRegister`` pins them."""
    t = torch.zeros(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return t
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(getattr(err, "value", err)) != 0:
        raise RuntimeError(f"pinning {nbytes / 2 ** 30:.2f} GiB of host "
                           f"memory failed ({err})")
    weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
    return t
