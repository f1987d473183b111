"""Comparisons, logical and bitwise ops — port of
``paddle_tpu/tensor/logic.py``. ``equal_all``, ``allclose`` and
``is_empty`` return 0-d bool tensors on the input's device (not Python
bools), as the JAX package's return tensors; the shifts are arithmetic on
signed integers whatever ``is_arithmetic`` says, as jnp's."""
from __future__ import annotations

import torch

from ..framework.dispatch import apply_op
from .math import _binary, _pair

equal = _binary(torch.eq, "equal")
not_equal = _binary(torch.ne, "not_equal")
greater_than = _binary(torch.gt, "greater")
greater_equal = _binary(torch.ge, "greater_equal")
less_than = _binary(torch.lt, "less")
less_equal = _binary(torch.le, "less_equal")


def logical_and(x, y, out=None, name=None):
    return apply_op(torch.logical_and, *_pair(x, y), op_name="logical_and")


def logical_or(x, y, out=None, name=None):
    return apply_op(torch.logical_or, *_pair(x, y), op_name="logical_or")


def logical_xor(x, y, out=None, name=None):
    return apply_op(torch.logical_xor, *_pair(x, y), op_name="logical_xor")


def logical_not(x, out=None, name=None):
    return apply_op(torch.logical_not, x, op_name="logical_not")


def bitwise_and(x, y, out=None, name=None):
    return apply_op(torch.bitwise_and, *_pair(x, y), op_name="bitwise_and")


def bitwise_or(x, y, out=None, name=None):
    return apply_op(torch.bitwise_or, *_pair(x, y), op_name="bitwise_or")


def bitwise_xor(x, y, out=None, name=None):
    return apply_op(torch.bitwise_xor, *_pair(x, y), op_name="bitwise_xor")


def bitwise_not(x, out=None, name=None):
    return apply_op(torch.bitwise_not, x, op_name="bitwise_not")


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return apply_op(torch.bitwise_left_shift, *_pair(x, y),
                    op_name="left_shift")


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    return apply_op(torch.bitwise_right_shift, *_pair(x, y),
                    op_name="right_shift")


def equal_all(x, y, name=None):
    """Whether ``x`` and ``y`` have one shape and equal entries."""
    def f(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.eq(a, b).all()

    return apply_op(f, x, y, op_name="equal_all")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: isclose(a, b, rtol, atol, equal_nan).all(),
                    x, y, op_name="allclose")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """``|x - y| <= atol + rtol · |y|`` (numpy's rule), in the two
    inputs' common dtype."""
    def f(a, b):
        d = torch.promote_types(a.dtype, b.dtype)
        return torch.isclose(a.to(d), b.to(d), rtol, atol, equal_nan)

    return apply_op(f, *_pair(x, y), op_name="isclose")


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
