"""Paddle's top-level odds and ends — the part of ``paddle_tpu/compat.py``
the ported tensor surface needs: ``cast``. The rest of that module is not
ported yet (ROADMAP A11)."""
from __future__ import annotations

import torch

from .framework.dtype import convert_dtype


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype`` (a Paddle name, a numpy or a torch dtype)."""
    return x.to(convert_dtype(dtype))
