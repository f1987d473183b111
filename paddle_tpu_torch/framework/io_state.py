"""``save`` / ``load`` — port of ``paddle_tpu/framework/io_state.py``
(``paddle.save`` / ``paddle.load``), pickle-compatible with it both ways.

The JAX package pickles an object with each tensor replaced by a
``paddle_tpu.framework.io_state._TensorPayload`` (a numpy array, its
``trainable`` flag, its name and whether it is a parameter), through dicts,
lists and tuples. :func:`save` writes the same stream: its payloads are
pickled under the JAX class's module and name, without importing the JAX
package (a pure-Python pickler writes that reference itself), so
``paddle_tpu.load`` reads it. :func:`load` reads such a stream with an
unpickler that maps the JAX class's name to this module's class, so it
reads a ``paddle_tpu.save`` file without importing the JAX package.

numpy has no bfloat16 of its own: a bf16 tensor is saved as an
``ml_dtypes.bfloat16`` array of the same bits, as the JAX package saves
its bf16 arrays, so a bf16 tensor loads back as bf16 in either package.
Unpickle only files this program or the JAX package wrote: unpickling
can run code.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .core import Parameter

__all__ = ["from_numpy", "load", "save"]

# the class a JAX-package pickle names for each tensor
_JAX_MODULE = "paddle_tpu.framework.io_state"
_JAX_NAME = "_TensorPayload"


class _TensorPayload:
    """One tensor in a saved object, as the JAX package's class of the
    same name."""

    def __init__(self, array: np.ndarray, trainable: bool, name: str = "",
                 is_param=False):
        self.array = array
        self.trainable = trainable
        self.name = name
        self.is_param = is_param


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the bits as they are, under ml_dtypes' bfloat16 (the JAX
        # package's numpy bf16); never widened
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.nn.Parameter):     # a plain one: trainable
        return _TensorPayload(_host(obj), getattr(obj, "trainable", True),
                              getattr(obj, "name", None) or "", True)
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(_host(obj), obj.requires_grad, "", False)
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def from_numpy(array: np.ndarray, device) -> torch.Tensor:
    """A copy of ``array`` on ``device``; a JAX file's bf16 array
    (``ml_dtypes.bfloat16``, which torch cannot read) as bf16."""
    if array.dtype.name == "bfloat16":     # ml_dtypes, from the JAX package
        t = torch.from_numpy(np.ascontiguousarray(array).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(array)).to(device)


def _unpack(obj: Any, return_numpy: bool, device) -> Any:
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        t = from_numpy(obj.array, device)
        if obj.is_param:
            return Parameter(t, trainable=obj.trainable, name=obj.name)
        return t.requires_grad_(bool(obj.trainable)
                                and t.is_floating_point())
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, return_numpy, device))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing :class:`_TensorPayload` as the JAX
    package's class (the C pickler would import that module to check
    it)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_JAX_MODULE)
            self.save(_JAX_NAME)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_JAX_MODULE}\n{_JAX_NAME}\n"
                       .encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == (_JAX_MODULE, _JAX_NAME):
            return _TensorPayload
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """Pickle ``obj`` (tensors in dicts, lists and tuples: a
    ``state_dict()``, an optimizer's) to ``path`` as ``paddle_tpu.save``
    does; makes the parent directory."""
    if protocol < 2:
        raise ValueError(f"protocol must be >= 2, got {protocol}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path: str, return_numpy: bool = False, device=None,
         **configs) -> Any:
    """Read a file :func:`save` or ``paddle_tpu.save`` wrote: its tensors
    as numpy arrays (``return_numpy``) or as tensors on ``device`` (None:
    the CUDA card, raising without one) — a parameter as a
    :class:`Parameter` with its ``trainable`` and name, another tensor
    with ``requires_grad`` its saved ``trainable``."""
    device = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, device)
