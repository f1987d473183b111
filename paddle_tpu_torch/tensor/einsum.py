"""Einsum — port of ``paddle_tpu/tensor/einsum.py``: ``torch.einsum``
under AMP's ``einsum`` entry (the white list)."""
from __future__ import annotations

import torch

from ..framework.dispatch import apply_op


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op(lambda *vs: torch.einsum(equation, *vs), *operands,
                    op_name="einsum")
