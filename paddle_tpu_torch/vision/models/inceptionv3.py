"""InceptionV3 — port of ``paddle_tpu/vision/models/inceptionv3.py``
(3 x 299 x 299 inputs)."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Conv2D, Dropout, Flatten,
                   Layer, Linear, MaxPool2D, ReLU, Sequential)
from ._common import bn, layer_kw, no_pretrained


class ConvBNLayer(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.conv = Conv2D(num_channels, num_filters, filter_size,
                           stride=stride, padding=padding, groups=groups,
                           bias_attr=False, **kw)
        self.bn = bn(num_filters, kw)
        self.act = ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class InceptionStem(Layer):
    def __init__(self, **kw):
        super().__init__()
        self.conv_1a_3x3 = ConvBNLayer(3, 32, 3, stride=2, **kw)
        self.conv_2a_3x3 = ConvBNLayer(32, 32, 3, **kw)
        self.conv_2b_3x3 = ConvBNLayer(32, 64, 3, padding=1, **kw)
        self.max_pool = MaxPool2D(kernel_size=3, stride=2)
        self.conv_3b_1x1 = ConvBNLayer(64, 80, 1, **kw)
        self.conv_4a_3x3 = ConvBNLayer(80, 192, 3, **kw)

    def forward(self, x):
        x = self.conv_2b_3x3(self.conv_2a_3x3(self.conv_1a_3x3(x)))
        x = self.max_pool(x)
        x = self.conv_4a_3x3(self.conv_3b_1x1(x))
        return self.max_pool(x)


class InceptionA(Layer):
    def __init__(self, num_channels, pool_features, **kw):
        super().__init__()
        self.branch1x1 = ConvBNLayer(num_channels, 64, 1, **kw)
        self.branch5x5_1 = ConvBNLayer(num_channels, 48, 1, **kw)
        self.branch5x5_2 = ConvBNLayer(48, 64, 5, padding=2, **kw)
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 64, 1, **kw)
        self.branch3x3dbl_2 = ConvBNLayer(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = ConvBNLayer(96, 96, 3, padding=1, **kw)
        self.branch_pool = AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, pool_features, 1,
                                            **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(Layer):
    """Grid reduction 35 → 17."""

    def __init__(self, num_channels, **kw):
        super().__init__()
        self.branch3x3 = ConvBNLayer(num_channels, 384, 3, stride=2, **kw)
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 64, 1, **kw)
        self.branch3x3dbl_2 = ConvBNLayer(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = ConvBNLayer(96, 96, 3, stride=2, **kw)
        self.branch_pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch3x3(x), self.branch3x3dbl_3(
            self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(x)], 1)


class InceptionC(Layer):
    def __init__(self, num_channels, channels_7x7, **kw):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = ConvBNLayer(num_channels, 192, 1, **kw)
        self.branch7x7_1 = ConvBNLayer(num_channels, c7, 1, **kw)
        self.branch7x7_2 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7_3 = ConvBNLayer(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_1 = ConvBNLayer(num_channels, c7, 1, **kw)
        self.branch7x7dbl_2 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0),
                                          **kw)
        self.branch7x7dbl_3 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3),
                                          **kw)
        self.branch7x7dbl_4 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0),
                                          **kw)
        self.branch7x7dbl_5 = ConvBNLayer(c7, 192, (1, 7), padding=(0, 3),
                                          **kw)
        self.branch_pool = AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, 192, 1, **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b7d = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b7, b7d, bp], 1)


class InceptionD(Layer):
    """Grid reduction 17 → 8."""

    def __init__(self, num_channels, **kw):
        super().__init__()
        self.branch3x3_1 = ConvBNLayer(num_channels, 192, 1, **kw)
        self.branch3x3_2 = ConvBNLayer(192, 320, 3, stride=2, **kw)
        self.branch7x7x3_1 = ConvBNLayer(num_channels, 192, 1, **kw)
        self.branch7x7x3_2 = ConvBNLayer(192, 192, (1, 7), padding=(0, 3),
                                         **kw)
        self.branch7x7x3_3 = ConvBNLayer(192, 192, (7, 1), padding=(3, 0),
                                         **kw)
        self.branch7x7x3_4 = ConvBNLayer(192, 192, 3, stride=2, **kw)
        self.branch_pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3_2(self.branch3x3_1(x)),
            self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
                self.branch7x7x3_1(x)))),
            self.branch_pool(x)], 1)


class InceptionE(Layer):
    def __init__(self, num_channels, **kw):
        super().__init__()
        self.branch1x1 = ConvBNLayer(num_channels, 320, 1, **kw)
        self.branch3x3_1 = ConvBNLayer(num_channels, 384, 1, **kw)
        self.branch3x3_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1),
                                        **kw)
        self.branch3x3_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0),
                                        **kw)
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 448, 1, **kw)
        self.branch3x3dbl_2 = ConvBNLayer(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1),
                                           **kw)
        self.branch3x3dbl_3b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0),
                                           **kw)
        self.branch_pool = AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, 192, 1, **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        b3d = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3d = torch.cat([self.branch3x3dbl_3a(b3d),
                         self.branch3x3dbl_3b(b3d)], 1)
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b3, b3d, bp], 1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inception_stem = InceptionStem(**kw)
        self.inception_block_list = Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw), InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw), InceptionE(1280, **kw),
            InceptionE(2048, **kw))
        if with_pool:
            self.avg_pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(p=0.2)
            self.flatten = Flatten()
            self.fc = Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.inception_block_list(self.inception_stem(x))
        if self.with_pool:
            x = self.avg_pool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(self.dropout(x)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
