"""Tensor attributes — port of ``paddle_tpu/tensor/attribute.py``:
``shape`` and ``rank`` as int64 tensors on the input's device."""
from __future__ import annotations

import torch

from ..framework.dtype import is_floating_point
from .math import imag, real  # noqa: F401


def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def rank(x):
    return torch.tensor(x.dim(), dtype=torch.int64, device=x.device)


def is_floating_point_fn(x):
    return is_floating_point(x.dtype)


def is_integer_fn(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex_fn(x):
    return x.is_complex()
