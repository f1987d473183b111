"""Helpers the port's tensor functions share: axis and int arguments,
Python scalars and arrays as tensors, the JAX package's inexact dtype
of an integer input, and a tensor read back as numpy (the metrics and the
host ops of ``vision.ops``)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import get_default_dtype


def ints(x):
    """An int, or a list of ints, from ints, tensors or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.tolist()
    if isinstance(x, (int, np.integer)):
        return int(x)
    return [int(v.item()) if isinstance(v, torch.Tensor) else int(v)
            for v in x]


def axis_arg(axis):
    """None, an int, or a tuple of ints (``axis`` as a list, a tuple or a
    tensor)."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis if axis is None else int(axis)


def all_dims(x, axis):
    """``axis`` as a tuple of dims, every dim of ``x`` when None."""
    a = axis_arg(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def as_tensor(v, like: torch.Tensor = None) -> torch.Tensor:
    """``v`` as a tensor: a tensor as it is; a numpy array in its own
    dtype; a Python bool / int / float in ``like``'s dtype when it is of
    the same kind or lower (a float in an integer tensor's company takes
    the default floating dtype), on ``like``'s device (else the CPU)."""
    if isinstance(v, torch.Tensor):
        return v
    dev = like.device if like is not None else None
    if isinstance(v, (np.ndarray, np.generic)):
        from ..framework.io_state import from_numpy

        return from_numpy(np.asarray(v), dev)
    if like is not None and isinstance(v, (bool, int, float, complex)):
        if isinstance(v, bool):
            d = like.dtype
        elif isinstance(v, int):
            d = like.dtype if like.dtype != torch.bool else torch.int64
        elif isinstance(v, float):
            d = like.dtype if (like.is_floating_point()
                               or like.is_complex()) else get_default_dtype()
        else:
            d = like.dtype if like.is_complex() else torch.complex64
        return torch.tensor(v, dtype=d, device=dev)
    t = torch.as_tensor(np.asarray(v), device=dev)
    return t.to(get_default_dtype()) if t.dtype == torch.float64 else t


def inexact(dtype: torch.dtype) -> torch.dtype:
    """The floating dtype the JAX package computes an integer (or bool)
    input's mean, root or exponential in: float64 for int64, float32
    for the narrower ones; a floating dtype as it is."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32


def to_inexact(x: torch.Tensor) -> torch.Tensor:
    d = inexact(x.dtype)
    return x if x.dtype == d else x.to(d)


def host_numpy(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array, a list) as a numpy array
    read back to the host; a bf16 tensor widened to fp32, which keeps
    every value and so every order (numpy has no bf16 of its own)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)
