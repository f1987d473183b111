"""Weight initializers — port of ``paddle_tpu/nn/initializer``.

Each initializer is a callable ``init(shape, dtype=None, device=None,
generator=None) -> torch.Tensor``: it draws in fp32 on ``device`` (None:
the CUDA card, raising without one) from ``generator`` (a
``torch.Generator`` on that device; None takes the device's default one,
which ``paddle_tpu_torch.seed`` seeds) and casts to ``dtype`` (None: the
default dtype). The distributions, fans and gains are the JAX package's;
the draws never equal ``jax.random``'s, so tests hold them by their
statistics, and ``Constant``, ``Assign`` and ``Bilinear`` exactly.

``_fan_in_out`` reads Paddle's layouts: a matrix (in, out), a conv kernel
(out, in, *spatial) with the receptive field in both fans.
:func:`set_global_initializer` sets the defaults ``Layer.create_parameter``
falls back to when neither a ``ParamAttr`` initializer nor a layer's
default is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import resolve_device
from ...framework.dtype import convert_dtype, get_default_dtype
from ...framework.random import default_generator

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "constant", "normal", "set_global_initializer",
           "uniform"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle uses [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Base: a subclass fills an fp32 tensor in :meth:`_fill`."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or get_default_dtype()
        gen = generator if generator is not None else \
            default_generator(device)
        t = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                        device=device)
        with torch.no_grad():
            self._fill(t, gen)
        return t.to(dtype)

    def _fill(self, t, gen):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t, gen):
        t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, t, gen):
        t.normal_(0.0, 1.0, generator=gen).mul_(self.std).add_(self.mean)


class TruncatedNormal(Initializer):
    """N(mean, std²) cut to [a, b] (absolute bounds, as the JAX package's),
    drawn by the inverse CDF of a uniform over the bounds' CDF values."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, t, gen):
        lo = (self.a - self.mean) / self.std
        hi = (self.b - self.mean) / self.std
        cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa
        t.uniform_(2.0 * cdf(lo) - 1.0, 2.0 * cdf(hi) - 1.0, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)
        t.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _fill(self, t, gen):
        t.uniform_(self.low, self.high, generator=gen)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t, gen):
        fi, fo = _fan_in_out(t.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        t.normal_(0.0, 1.0, generator=gen).mul_(
            self.gain * math.sqrt(2.0 / (fi + fo)))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t, gen):
        fi, fo = _fan_in_out(t.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        t.uniform_(-limit, limit, generator=gen)


def _kaiming_gain(nonlinearity, negative_slope):
    return math.sqrt(2.0 / (1 + negative_slope ** 2)) \
        if nonlinearity in ("relu", "leaky_relu") else 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, t, gen):
        fi = self.fan_in or _fan_in_out(t.shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        t.normal_(0.0, 1.0, generator=gen).mul_(std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, t, gen):
        fi = self.fan_in or _fan_in_out(t.shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        t.uniform_(-limit, limit, generator=gen)


class Assign(Initializer):
    """The given value (an array, a list or a tensor) of exactly the
    requested shape (ValueError otherwise), cast to the dtype."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or get_default_dtype()
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {tuple(v.shape)} != "
                             f"{tuple(shape)}")
        return v.to(device=device, dtype=dtype, copy=True)


class Bilinear(Initializer):
    """Bilinear upsampling kernel (for a transposed conv), as the JAX
    package computes it on the host."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or get_default_dtype()
        weight = np.zeros(tuple(shape), dtype=np.float32)
        f = math.ceil(shape[-1] / 2)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[-2:]))):
            x = i % shape[-1]
            y = (i // shape[-1]) % shape[-2]
            weight[..., y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device=device, dtype=dtype)


def _orthogonal(shape, gain, gen, device):
    """``jax.nn.initializers.orthogonal(gain)`` over the last axis: the
    Q of a normal matrix's QR, signs fixed by R's diagonal."""
    n_rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    n_cols = shape[-1]
    a = torch.empty(max(n_rows, n_cols), min(n_rows, n_cols),
                    dtype=torch.float32, device=device)
    a.normal_(0.0, 1.0, generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return gain * q.reshape(shape)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _fill(self, t, gen):
        t.copy_(_orthogonal(tuple(t.shape), self.gain, gen, t.device))


class Dirac(Initializer):
    """The JAX package's ``Dirac``: ``jax.nn.initializers.
    delta_orthogonal()`` over the shape as given — an orthogonal matrix
    over the last two axes, at the centre of the leading ones (3-5 axes,
    ``shape[-2] <= shape[-1]``; ValueError otherwise). ``groups`` is
    accepted and unused, as there."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _fill(self, t, gen):
        shape = tuple(t.shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError("Dirac needs a 3-5 axis shape")
        if shape[-2] > shape[-1]:
            raise ValueError("Dirac needs shape[-2] <= shape[-1]")
        t.zero_()
        centre = tuple(k // 2 for k in shape[:-2])
        t[centre] = _orthogonal(shape[-2:], 1.0, gen, t.device)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


# functional aliases matching paddle.nn.initializer names
constant = Constant
normal = Normal
uniform = Uniform

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Process-wide default initializers that ``Layer.create_parameter``
    falls back to when neither a ``ParamAttr`` initializer nor a
    ``default_initializer`` is given; ``None`` resets."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _global_initializer(is_bias: bool):
    return _global_bias_init if is_bias else _global_weight_init
