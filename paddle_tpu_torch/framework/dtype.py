"""Dtype names — port of ``paddle_tpu/framework/dtype.py``.

Maps Paddle's dtype names (``"float32"``, ``"bf16"``, …), numpy dtypes and
torch dtypes onto torch dtypes, and keeps the default floating dtype that
layers and creation functions use when given none (fp32, as the JAX
package's).
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
    # paddle aliases
    "fp16": float16,
    "bf16": bfloat16,
    "fp32": float32,
    "fp64": float64,
}

_FLOATING = {float16, bfloat16, float32, float64}


def convert_dtype(dtype):
    """A Paddle dtype name, a numpy dtype (or type) or a torch dtype as a
    torch dtype; None stays None. An unknown name raises ValueError."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR2DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _STR2DTYPE[name]


def dtype_name(dtype) -> str:
    """The Paddle name of a dtype (``torch.float32`` → ``"float32"``)."""
    d = convert_dtype(dtype)
    return next(k for k, v in _STR2DTYPE.items() if v == d)


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


_default_dtype = float32


def set_default_dtype(d):
    """``paddle.set_default_dtype``: a floating dtype, else TypeError."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError(f"Default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype
