"""Activations — port of ``paddle_tpu/nn/functional/activation.py``: the
functions the activation layers call (``relu``, ``relu6``, ``gelu``,
``sigmoid``, ``tanh``, ``silu`` / ``swish``, ``mish``, ``hardswish``,
``hardsigmoid``, ``tanhshrink``, ``softsign``, ``log_sigmoid``, ``elu``,
``selu``, ``celu``, ``leaky_relu``, ``prelu``, ``rrelu``, ``hardtanh``,
``hardshrink``, ``softshrink``, ``thresholded_relu``, ``softplus``,
``maxout``, ``softmax``, ``log_softmax``, ``glu``) and
``gumbel_softmax``, each the JAX package's formula. ``rrelu`` in
training and ``gumbel_softmax`` draw from
``generator`` (a ``torch.Generator`` on x's device; None takes the
default one): the draws never equal ``jax.random``'s."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...framework.dtype import convert_dtype


def gelu(x, approximate=False, name=None):
    """GELU; exact (erf) unless ``approximate`` (the tanh form), as
    ``jax.nn.gelu(v, approximate=approximate)`` with the JAX package's
    default ``approximate=False``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return F.silu(x)


swish = silu


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, name=None):
    return torch.clamp(x / 6 + 0.5, 0, 1)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softsign(x, name=None):
    return x / (1 + x.abs())


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha=alpha)


def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where non-negative, else ``weight · x``: one slope, or one a
    channel (axis 1 for ``"NCHW"``, the last otherwise)."""
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None,
          generator=None):
    if training:
        a = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        a = a.uniform_(lower, upper, generator=generator).to(x.dtype)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x, F.softplus(x * beta) / beta)


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = list(x.shape[:ax]) + [c // groups, groups] + \
        list(x.shape[ax + 1:])
    return x.reshape(shape).amax(ax + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.softmax(x if d is None else x.to(d), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.log_softmax(x if d is None else x.to(d), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """``softmax((x + g) / temperature)`` with Gumbel(0, 1) noise g drawn
    from ``generator`` (None: the device's default one; never
    ``jax.random``'s draw); ``hard`` returns the one-hot of its argmax
    with the soft gradient (straight through)."""
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def glu(x, axis=-1, name=None):
    return F.glu(x, dim=axis)
