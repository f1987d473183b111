"""Fused norms of ``paddle_tpu/incubate/nn/functional.py``
(``fused_rms_norm``, ``fused_layer_norm``): thin functions on tensors over
``ops.fused_norm`` — the hand-written kernels on a CUDA tensor, their
plain twins on a CPU one. The rest of the JAX module (fused attention,
feed-forward and MoE blocks) is not ported yet."""
from __future__ import annotations

from ...ops import fused_norm as _fused_norm


def fused_rms_norm(x, weight, epsilon=1e-6):
    return _fused_norm.fused_rms_norm(x, weight, epsilon)


def fused_layer_norm(x, weight, bias, epsilon=1e-5):
    return _fused_norm.fused_layer_norm(x, weight, bias, epsilon)
