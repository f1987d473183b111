"""Activation layers — port of ``paddle_tpu/nn/layer/activation.py``,
each over the ``F`` function of its name with the JAX package's
arguments. ``PReLU`` builds its slopes (``init``, one or one a channel)
through ``Layer.create_parameter`` on ``device`` (``place`` its alias;
None: the CUDA card, raising without one); ``RReLU`` draws its training
slopes from ``generator`` (None: the default one)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from ..layer_base import Layer


class _Act(Layer):
    """Calls ``F.<fn>(x, *args)`` with the arguments the layer was built
    with."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, x):
        return getattr(F, self._fn)(x, *self._args)


def _plain(fn):
    class _Plain(_Act):
        _fn = fn

        def __init__(self, name=None):
            super().__init__()

    return _Plain


ReLU = type("ReLU", (_plain("relu"),), {})
ReLU6 = type("ReLU6", (_plain("relu6"),), {})
Sigmoid = type("Sigmoid", (_plain("sigmoid"),), {})
Tanh = type("Tanh", (_plain("tanh"),), {})
Silu = type("Silu", (_plain("silu"),), {})
Swish = type("Swish", (Silu,), {})
Mish = type("Mish", (_plain("mish"),), {})
Hardswish = type("Hardswish", (_plain("hardswish"),), {})
Hardsigmoid = type("Hardsigmoid", (_plain("hardsigmoid"),), {})
Softsign = type("Softsign", (_plain("softsign"),), {})
Tanhshrink = type("Tanhshrink", (_plain("tanhshrink"),), {})
LogSigmoid = type("LogSigmoid", (_plain("log_sigmoid"),), {})


class GELU(_Act):
    _fn = "gelu"

    def __init__(self, approximate=False, name=None):
        super().__init__(approximate)


class Softmax(_Act):
    _fn = "softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class LogSoftmax(_Act):
    _fn = "log_softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class LeakyReLU(_Act):
    _fn = "leaky_relu"

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__(negative_slope)


class ELU(_Act):
    _fn = "elu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class SELU(_Act):
    _fn = "selu"

    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__(scale, alpha)


class CELU(_Act):
    _fn = "celu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class Hardtanh(_Act):
    _fn = "hardtanh"

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__(min, max)


class Hardshrink(_Act):
    _fn = "hardshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Softshrink(_Act):
    _fn = "softshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Softplus(_Act):
    _fn = "softplus"

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__(beta, threshold)


class ThresholdedReLU(_Act):
    _fn = "thresholded_relu"

    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__(threshold, value)


class Maxout(_Act):
    _fn = "maxout"

    def __init__(self, groups, axis=1, name=None):
        super().__init__(groups, axis)


class GLU(_Act):
    _fn = "glu"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, place=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training,
                       generator=self.generator)
