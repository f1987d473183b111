"""TensorArray functions — port of ``paddle_tpu/tensor/array.py``: the
array is a Python list of tensors, as in the JAX package (writes grow
it, reads index it). Numbers and arrays written to it become tensors on
``device`` (None: the card, raising without one)."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..framework.dtype import convert_dtype

__all__ = ["array_length", "array_read", "array_write", "create_array",
           "create_tensor"]


def _idx(i) -> int:
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


def create_array(dtype="float32", initialized_list=None, *, device=None):
    """A new array, seeded from ``initialized_list`` when given
    (``dtype`` is advisory: elements keep their own)."""
    out = []
    for v in initialized_list or ():
        if not isinstance(v, torch.Tensor):
            from ..framework.io_state import from_numpy

            v = from_numpy(np.asarray(v), resolve_device(device))
        out.append(v)
    return out


def array_write(x, i, array=None):
    """Write ``x`` at position ``i``, growing the array as needed;
    returns the array."""
    if array is None:
        array = []
    i = _idx(i)
    if i < len(array):
        array[i] = x
    else:
        while len(array) < i:
            array.append(None)
        array.append(x)
    return array


def array_read(array, i):
    return array[_idx(i)]


def array_length(array, *, device=None):
    """The length as an int64 0-d tensor, on the device of the array's
    first tensor (else ``device``)."""
    dev = next((t.device for t in array if isinstance(t, torch.Tensor)),
               None) or resolve_device(device)
    return torch.tensor(len(array), dtype=torch.int64, device=dev)


def create_tensor(dtype, name=None, persistable=False, *, device=None):
    """A 0-d zero tensor of ``dtype``, to be filled later (``assign``)."""
    return torch.zeros((), dtype=convert_dtype(dtype),
                       device=resolve_device(device))
