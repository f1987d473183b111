"""MobileNetV1 — port of ``paddle_tpu/vision/models/mobilenetv1.py``."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Conv2D, Flatten, Layer, Linear, ReLU,
                   Sequential)
from ._common import bn, layer_kw, no_pretrained


class ConvBNLayer(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._conv = Conv2D(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding, groups=groups,
                            bias_attr=False, **kw)
        self._norm_layer = bn(out_channels, kw)
        self._act = ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, **kw):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride=stride,
            padding=1, groups=int(num_groups * scale), **kw)
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1, **kw)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 **kw)
        # (in, out1, out2, groups, stride) of each block
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
               (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
               (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
               (1024, 1024, 1024, 1024, 1)]
        self.dwsl = Sequential(*[
            DepthwiseSeparable(int(i * scale), o1, o2, g, s, scale, **kw)
            for i, o1, o2, g, s in cfg])
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.flatten = Flatten()
            self.fc = Linear(int(1024 * scale), num_classes, **kw)

    def forward(self, x):
        x = self.dwsl(self.conv1(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
