"""``linear`` and ``dropout`` — port of
``paddle_tpu/nn/functional/common.py``."""
from __future__ import annotations

import torch

from ...amp import cast_inputs


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` stored (in, out), Paddle's
    layout (under ``amp.auto_cast``: the ``linear`` rule)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Zero each element with probability ``p`` in training and scale the
    kept ones by 1/(1 - p) (``"upscale_in_train"``), drawing from
    ``generator`` (a ``torch.Generator`` on x's device; None takes
    PyTorch's default one). Outside training, or at p = 0, x is returned
    unchanged, as the JAX package's ``dropout`` does. The JAX package
    draws from ``jax.random``: the two never give the same mask from one
    seed. ``axis`` (a mask shared along the other axes) and
    ``"downscale_in_infer"`` are not ported."""
    if mode != "upscale_in_train" or axis is not None:
        raise NotImplementedError(f"dropout(axis={axis!r}, mode={mode!r}) "
                                  f"is not ported yet")
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
