"""VGG — port of ``paddle_tpu/vision/models/vgg.py``: configurations A,
B, D and E (VGG-11 / 13 / 16 / 19), with or without BatchNorm."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Layer, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...tensor.manipulation import flatten
from ._common import bn, layer_kw, no_pretrained

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, **kw):
    kw = layer_kw(**kw)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_channels, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(bn(v, kw))
            layers.append(ReLU())
            in_channels = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, device=None, place=None,
         dtype=None, generator=None, **kwargs):
    no_pretrained(pretrained)
    kw = layer_kw(device, place, dtype, generator)
    return VGG(make_layers(cfgs[cfg], batch_norm, **kw), **kwargs, **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
