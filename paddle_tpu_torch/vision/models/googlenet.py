"""GoogLeNet (Inception v1) — port of
``paddle_tpu/vision/models/googlenet.py``. ``forward`` returns (the
logits, the first auxiliary head's, the second's), as the JAX package's
does in eval too."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Conv2D, Dropout, Flatten,
                   Layer, Linear, MaxPool2D, ReLU)
from ._common import layer_kw, no_pretrained


class ConvLayer(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 groups=1, **kw):
        super().__init__()
        self._conv = Conv2D(num_channels, num_filters, filter_size,
                            stride=stride, padding=(filter_size - 1) // 2,
                            groups=groups, bias_attr=False,
                            **layer_kw(**kw))
        self._relu = ReLU()

    def forward(self, x):
        return self._relu(self._conv(x))


class Inception(Layer):
    def __init__(self, input_channels, output_channels, filter1, filter3R,
                 filter3, filter5R, filter5, proj, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._conv1 = ConvLayer(input_channels, filter1, 1, **kw)
        self._conv3r = ConvLayer(input_channels, filter3R, 1, **kw)
        self._conv3 = ConvLayer(filter3R, filter3, 3, **kw)
        self._conv5r = ConvLayer(input_channels, filter5R, 1, **kw)
        self._conv5 = ConvLayer(filter5R, filter5, 5, **kw)
        self._pool = MaxPool2D(kernel_size=3, stride=1, padding=1)
        self._convprj = ConvLayer(input_channels, proj, 1, **kw)

    def forward(self, x):
        return torch.cat([self._conv1(x), self._conv3(self._conv3r(x)),
                          self._conv5(self._conv5r(x)),
                          self._convprj(self._pool(x))], 1)


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def inc(*a):
            return Inception(*a, **kw)

        self._conv = ConvLayer(3, 64, 7, 2, **kw)
        self._pool = MaxPool2D(kernel_size=3, stride=2)
        self._conv_1 = ConvLayer(64, 64, 1, **kw)
        self._conv_2 = ConvLayer(64, 192, 3, **kw)
        self._ince3a = inc(192, 192, 64, 96, 128, 16, 32, 32)
        self._ince3b = inc(256, 256, 128, 128, 192, 32, 96, 64)
        self._ince4a = inc(480, 480, 192, 96, 208, 16, 48, 64)
        self._ince4b = inc(512, 512, 160, 112, 224, 24, 64, 64)
        self._ince4c = inc(512, 512, 128, 128, 256, 24, 64, 64)
        self._ince4d = inc(512, 512, 112, 144, 288, 32, 64, 64)
        self._ince4e = inc(528, 528, 256, 160, 320, 32, 128, 128)
        self._ince5a = inc(832, 832, 256, 160, 320, 32, 128, 128)
        self._ince5b = inc(832, 832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self._pool_5 = AdaptiveAvgPool2D(1)
        self._drop = Dropout(p=0.4)
        if num_classes > 0:
            self._fc_out = Linear(1024, num_classes, **kw)
            self._flatten = Flatten()
        # the auxiliary classifiers
        self._pool_o1 = AvgPool2D(kernel_size=5, stride=3)
        self._conv_o1 = ConvLayer(512, 128, 1, **kw)
        self._fc_o1 = Linear(1152, 1024, **kw)
        self._drop_o1 = Dropout(p=0.7)
        self._out1 = Linear(1024, num_classes, **kw) if num_classes > 0 \
            else None
        self._relu = ReLU()
        self._pool_o2 = AvgPool2D(kernel_size=5, stride=3)
        self._conv_o2 = ConvLayer(528, 128, 1, **kw)
        self._fc_o2 = Linear(1152, 1024, **kw)
        self._drop_o2 = Dropout(p=0.7)
        self._out2 = Linear(1024, num_classes, **kw) if num_classes > 0 \
            else None

    def forward(self, x):
        x = self._pool(self._conv(x))
        x = self._pool(self._conv_2(self._conv_1(x)))
        x = self._pool(self._ince3b(self._ince3a(x)))
        ince4a = self._ince4a(x)
        ince4d = self._ince4d(self._ince4c(self._ince4b(ince4a)))
        x = self._pool(self._ince4e(ince4d))
        x = self._ince5b(self._ince5a(x))
        if self.with_pool:
            x = self._pool_5(x)
        x = self._drop(x)
        if self.num_classes <= 0:
            return x
        out = self._fc_out(self._flatten(x))
        o1 = self._conv_o1(self._pool_o1(ince4a))
        o1 = self._relu(self._fc_o1(self._flatten(o1)))
        out1 = self._out1(self._drop_o1(o1))
        o2 = self._conv_o2(self._pool_o2(ince4d))
        o2 = self._relu(self._fc_o2(self._flatten(o2)))
        out2 = self._out2(self._drop_o2(o2))
        return out, out1, out2


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
