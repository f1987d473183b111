"""Eager op dispatch — port of ``paddle_tpu/framework/dispatch.py``.

The JAX package runs every tensor function through ``apply_op``: it
unwraps its ``Tensor``s, applies AMP's cast rule, runs the jnp function,
scans the outputs under ``FLAGS_check_nan_inf`` and records a tape node
(a ``jax.vjp`` closure) for its own autograd. The port's tensor is
``torch.Tensor`` and its autograd is PyTorch's, so no tape is recorded and
nothing is unwrapped; what :func:`apply_op` keeps is the rest:

- **AMP at dispatch.** Under ``auto_cast`` O1 the floating tensor inputs
  of a white-listed op are cast to the AMP dtype; under O2 those of every
  op that is not black-listed (``paddle_tpu_torch.amp``'s lists, as the
  JAX package's). Every tensor function of ``paddle_tpu_torch.tensor``
  goes through it, as in JAX.
- **A static ``Variable``** (the JAX package's ``paddle.static`` graph
  builder) is not ported: one reaching :func:`apply_op` raises
  NotImplementedError.

``FLAGS_check_nan_inf`` covers every operator, not only those that reach
:func:`apply_op`: a layer of the port calls torch directly, where the JAX
package's layers all dispatch through ``apply_op``. While the flag is set,
a ``TorchDispatchMode`` (:class:`NanInfScan`) is active on the thread that
set it (and on the autograd engine's threads, which inherit it): it reads
every floating output of every ATen operator on the host and raises
FloatingPointError naming the operator. A host read is illegal under CUDA
graph capture: the graphed engine and server refuse to capture while the
flag is set (``graphs.refuse_scan``), as the JAX engine's compiled step
raises under the flag; the scan itself raises if it meets a capture. The
scan is never skipped.

The JAX package scans the outputs of its Paddle-level ops; the port scans
each ATen operator's, so a value that is not finite by design inside one
Paddle op (max pooling's -inf padding) would trip it. Such code runs under
:func:`scan_paused` and scans its own result (:func:`scan`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_leaves

from .. import amp as _amp
from .flags import GLOBAL_FLAGS

__all__ = ["NanInfScan", "apply_op", "defop", "scan", "scan_paused"]


def _is_static_variable(a) -> bool:
    t = type(a)
    return t.__name__ == "Variable" and ".static" in t.__module__


def apply_op(fn: Callable, *args, n_outputs: Optional[int] = None,
             op_name: str = "", **kwargs):
    """``fn(*args, **kwargs)`` under AMP's rule for ``op_name`` (default:
    ``fn``'s name): positional tensors are the op's inputs, keyword
    arguments static. A list result comes back as a tuple, as in the JAX
    package."""
    if any(_is_static_variable(a) for a in args):
        raise NotImplementedError(
            "paddle.static graphs are not ported (ROADMAP A11: static/): "
            "a static Variable reached an eager op")
    state = _amp.amp_state()
    if state.level != "O0" and _amp.should_cast_to_low_precision(
            op_name or getattr(fn, "__name__", "")):
        tgt = state.dtype
        args = tuple(a.to(tgt) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() and a.dtype != tgt else a
                     for a in args)
    out = fn(*args, **kwargs)
    return tuple(out) if isinstance(out, list) else out


def defop(fn: Callable, op_name: str = ""):
    """Lift a torch function into an op that dispatches through
    :func:`apply_op` under ``op_name``."""

    def op(*args, **kwargs):
        return apply_op(fn, *args, op_name=op_name, **kwargs)

    op.__name__ = op_name or getattr(fn, "__name__", "op")
    op.__doc__ = getattr(fn, "__doc__", None)
    return op


# operators whose floating output is uninitialised memory, or is the
# input itself rebound: nothing to scan
_UNSCANNED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_", "set_", "detach",
                        "alias", "lift_fresh"})


def _check(name, out) -> None:
    """Raise FloatingPointError naming ``name`` when a floating (or
    complex) tensor of ``out`` holds a NaN or an Inf (the JAX package's
    ``_check_nan_inf``); read on the host."""
    for t in tree_leaves(out):
        if not isinstance(t, torch.Tensor) or t.numel() == 0 or not (
                t.is_floating_point() or t.is_complex()):
            continue
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"FLAGS_check_nan_inf reads op {name!r}'s output on the "
                f"host, which a CUDA graph capture forbids: run the "
                f"graphed program eagerly (graphs = False) to scan it")
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op {name!r} "
                f"(FLAGS_check_nan_inf=1)")


class NanInfScan(TorchDispatchMode):
    """Scans each output of every ATen operator (:func:`_check`), except
    inside :func:`scan_paused`."""

    paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not self.paused and name not in _UNSCANNED:
            _check(name, out)
        return out


_scan: Optional[NanInfScan] = None


@contextlib.contextmanager
def scan_paused():
    """No operator inside is scanned (its caller scans the result with
    :func:`scan`); a no-op while the flag is clear."""
    mode = _scan
    if mode is None:
        yield
        return
    mode.paused += 1
    try:
        yield
    finally:
        mode.paused -= 1


def scan(name: str, out):
    """``out``, scanned as op ``name``'s output while the flag is set."""
    if _scan is not None:
        _check(name, out)
    return out


def _set_scan(on) -> None:
    """``check_nan_inf``'s hook: enter the scan when it is set, leave it
    when it is cleared."""
    global _scan
    if on and _scan is None:
        _scan = NanInfScan()
        _scan.__enter__()
    elif not on and _scan is not None:
        if _get_current_dispatch_mode() is not _scan:
            raise RuntimeError(
                "FLAGS_check_nan_inf cleared inside another dispatch mode "
                "entered after it was set: leave that mode first")
        mode, _scan = _scan, None
        mode.__exit__(None, None, None)


GLOBAL_FLAGS.on_set("check_nan_inf", _set_scan)
