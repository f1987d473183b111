"""``LayerNorm`` — port of ``paddle_tpu/nn/layer/norm.py``."""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from .. import functional as F
from .common import _unported_attr


class LayerNorm(nn.Module):
    """LayerNorm over ``normalized_shape`` (an int or a list of the last
    axes' sizes): ``weight`` ones and ``bias`` zeros, each left out when
    its attr is False. One normalised axis with both parameters is the
    hand-written kernel's form on the card (``F.layer_norm``)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        _unported_attr(weight_attr, "LayerNorm weight_attr")
        _unported_attr(bias_attr, "LayerNorm bias_attr")
        ns = normalized_shape if isinstance(normalized_shape,
                                            (list, tuple)) \
            else [normalized_shape]
        self._normalized_shape = [int(n) for n in ns]
        self._epsilon = epsilon
        device = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, dtype=dtype, device=device))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, dtype=dtype, device=device))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
               f"epsilon={self._epsilon}"
