"""Pooling layers — port of ``paddle_tpu/nn/layer/pooling.py`` over
``F.max_pool*d``, ``F.avg_pool*d``, ``F.adaptive_*_pool*d`` and
``F.max_unpool2d``, with the JAX package's arguments and order."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer


class _Pool(Layer):
    """Calls ``F.<fn>(x, *args)`` with the arguments the layer was built
    with."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self.a = args

    def forward(self, x):
        return getattr(F, self._fn)(x, *self.a)


class MaxPool1D(_Pool):
    _fn = "max_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode)


class MaxPool2D(_Pool):
    _fn = "max_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class MaxPool3D(_Pool):
    _fn = "max_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode)


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AdaptiveAvgPool1D(_Pool):
    _fn = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Pool):
    _fn = "adaptive_avg_pool2d"

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveAvgPool3D(_Pool):
    _fn = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Pool):
    _fn = "adaptive_max_pool1d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool2D(_Pool):
    _fn = "adaptive_max_pool2d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool3D(_Pool):
    _fn = "adaptive_max_pool3d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, *self.a)
