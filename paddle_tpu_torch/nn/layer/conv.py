"""Conv layers — port of ``paddle_tpu/nn/layer/conv.py``: ``Conv1D`` /
``Conv2D`` / ``Conv3D`` and their ``Transpose`` forms over
``F.conv*d``. The weight is (out, in / groups, *k) — (in, out / groups,
*k) transposed — and, with the bias, starts ``Uniform(-k, k)``, ``k =
1 / sqrt(in / groups · prod(kernel))``, as the JAX package's, unless a
``ParamAttr`` / callable attr says otherwise; ``bias_attr=False`` builds
no bias. Parameters are built on ``device`` (``place`` its alias; None:
the CUDA card, raising without one) in ``dtype`` (None: the default
dtype), drawn from ``generator``. ``padding_mode`` other than
``"zeros"`` is not ported (NotImplementedError: the JAX package pads
with zeros whatever it says)."""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import Uniform
from ..layer_base import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0, *, device=None, place=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is not "
                                      f"ported (zeros only)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * dims
        self._kernel_size = [int(k) for k in ks]
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        self._transposed = transposed
        if transposed:
            shape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        k = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=Uniform(-k, k))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-k, k))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1, **kw)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3, **kw)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
