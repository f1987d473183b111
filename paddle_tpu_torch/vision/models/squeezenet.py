"""SqueezeNet 1.0 and 1.1 — port of
``paddle_tpu/vision/models/squeezenet.py``."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Flatten, Layer,
                   MaxPool2D, ReLU, Sequential)
from ._common import layer_kw, no_pretrained


class MakeFireConv(Layer):
    def __init__(self, input_channels, output_channels, filter_size,
                 padding=0, **kw):
        super().__init__()
        self._conv = Conv2D(input_channels, output_channels, filter_size,
                            padding=padding, **layer_kw(**kw))
        self._relu = ReLU()

    def forward(self, x):
        return self._relu(self._conv(x))


class MakeFire(Layer):
    def __init__(self, input_channels, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._conv = MakeFireConv(input_channels, squeeze_channels, 1, **kw)
        self._conv_path1 = MakeFireConv(squeeze_channels, expand1x1_channels,
                                        1, **kw)
        self._conv_path2 = MakeFireConv(squeeze_channels, expand3x3_channels,
                                        3, padding=1, **kw)

    def forward(self, x):
        x = self._conv(x)
        return torch.cat([self._conv_path1(x), self._conv_path2(x)], 1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 **kw):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"version must be '1.0' or '1.1', got "
                             f"{version!r}")
        kw = layer_kw(**kw)
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool

        def fire(*a):
            return MakeFire(*a, **kw)

        if version == "1.0":
            self._conv = Conv2D(3, 96, 7, stride=2, **kw)
            fires = [fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                     fire(128, 32, 128, 128)]
            fires2 = [fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                      fire(384, 48, 192, 192), fire(384, 64, 256, 256)]
            fires3 = [fire(512, 64, 256, 256)]
        else:
            self._conv = Conv2D(3, 64, 3, stride=2, padding=1, **kw)
            fires = [fire(64, 16, 64, 64), fire(128, 16, 64, 64)]
            fires2 = [fire(128, 32, 128, 128), fire(256, 32, 128, 128)]
            fires3 = [fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                      fire(384, 64, 256, 256), fire(512, 64, 256, 256)]
        self._pool = MaxPool2D(3, stride=2)
        self._relu = ReLU()
        self._stage1 = Sequential(*fires)
        self._stage2 = Sequential(*fires2)
        self._stage3 = Sequential(*fires3)
        if num_classes > 0:
            self._drop = Dropout(p=0.5)
            self._conv9 = Conv2D(512, num_classes, 1, **kw)
            self._flatten = Flatten()
        if with_pool:
            self._avg_pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self._pool(self._relu(self._conv(x)))
        x = self._pool(self._stage1(x))
        x = self._stage2(x)
        if self.version == "1.1":
            x = self._pool(x)
        x = self._stage3(x)
        if self.num_classes > 0:
            x = self._relu(self._conv9(self._drop(x)))
        if self.with_pool:
            x = self._avg_pool(x)
        if self.num_classes > 0:
            x = self._flatten(x)
        return x


def _squeezenet(version, pretrained, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet(version=version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
