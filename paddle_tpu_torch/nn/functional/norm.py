"""``layer_norm`` — port of ``paddle_tpu/nn/functional/norm.py``.

The JAX package's ``F.layer_norm`` is a jnp composition (XLA fuses it); its
Pallas LayerNorm kernel (``ops.fused_norm._ln_pallas``) is reached only
through ``fused_layer_norm``. Both compute one function, so the port sends
the form every transformer uses — one normalised axis, with a weight and a
bias — through ``ops.fused_layer_norm``: on a CUDA tensor every such
LayerNorm launches the hand-written kernel. The other forms (several
normalised axes, or no weight or no bias) take the plain composition
below, on any device.
"""
from __future__ import annotations

import torch

from ...ops.fused_norm import fused_layer_norm


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the last ``len(normalized_shape)`` axes: fp32 mean and
    variance about the mean, ``(x - mean) * rsqrt(var + epsilon)``, times
    ``weight`` and plus ``bias`` when given, cast to x's dtype."""
    ns = list(normalized_shape) if isinstance(normalized_shape,
                                              (list, tuple)) \
        else [normalized_shape]
    if len(ns) == 1 and weight is not None and bias is not None:
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - len(ns), x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
