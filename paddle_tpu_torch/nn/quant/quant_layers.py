"""Weight-only int8 linear — port of ``Int8Linear`` from
``paddle_tpu/nn/quant/quant_layers.py`` (the fake-quant and QAT layers of
that file are not ported).

The int8 codes ``weight_q`` (in, out) and the per-column f32
``weight_scale`` (out,) are buffers, named as in the JAX package, so a
quantized JAX state dict loads name for name (``models/convert.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.int8 import quantize_per_channel, w8_matmul


class Int8Linear(nn.Module):
    """``y = x @ dequant(weight_q, weight_scale)`` through
    :func:`~paddle_tpu_torch.ops.int8.w8_matmul`: up to 128 rows stream the
    int8 weight through the kernel, more rows dequantize once; :meth:`stream`
    (decode and verify) streams at every row count. Built
    from a trained bias-free ``Linear`` with :meth:`from_linear`."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if w_q.dtype != torch.int8 or w_q.dim() != 2 or \
                scale.shape != (w_q.shape[1],):
            raise ValueError(f"Int8Linear: want int8 (in, out) codes and an "
                             f"(out,) scale, got {w_q.dtype} "
                             f"{tuple(w_q.shape)} and {tuple(scale.shape)}")
        self.register_buffer("weight_q", w_q)
        self.register_buffer("weight_scale", scale.float())
        self.in_features = int(w_q.shape[0])
        self.out_features = int(w_q.shape[1])

    @classmethod
    def from_linear(cls, linear) -> "Int8Linear":
        w_q, scale = quantize_per_channel(linear.weight.detach())
        return cls(w_q, scale)

    def forward(self, x):
        return w8_matmul(x, self.weight_q, self.weight_scale)

    def stream(self, x):
        """The decode and verify paths' product: the int8 weight streams
        at every row count (``w8_matmul(any_rows=True)``), so a row's
        result does not depend on the rows beside it."""
        return w8_matmul(x, self.weight_q, self.weight_scale, any_rows=True)
