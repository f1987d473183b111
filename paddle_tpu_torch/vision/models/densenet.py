"""DenseNet — port of ``paddle_tpu/vision/models/densenet.py`` (121, 161,
169, 201, 264)."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Conv2D, Dropout, Flatten,
                   Layer, Linear, MaxPool2D, ReLU, Sequential)
from ._common import bn, layer_kw, no_pretrained


class BNACConvLayer(Layer):
    """BN → ReLU → Conv (pre-activation)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 pad=0, groups=1, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._batch_norm = bn(num_channels, kw)
        self._act = ReLU()
        self._conv = Conv2D(num_channels, num_filters, filter_size,
                            stride=stride, padding=pad, groups=groups,
                            bias_attr=False, **kw)

    def forward(self, x):
        return self._conv(self._act(self._batch_norm(x)))


class DenseLayer(Layer):
    def __init__(self, num_channels, growth_rate, bn_size, dropout, **kw):
        super().__init__()
        self.dropout = dropout
        self.bn_ac_func1 = BNACConvLayer(num_channels, bn_size * growth_rate,
                                         1, **kw)
        self.bn_ac_func2 = BNACConvLayer(bn_size * growth_rate, growth_rate,
                                         3, pad=1, **kw)
        if dropout:
            self.dropout_func = Dropout(p=dropout)

    def forward(self, x):
        conv = self.bn_ac_func2(self.bn_ac_func1(x))
        if self.dropout:
            conv = self.dropout_func(conv)
        return torch.cat([x, conv], 1)


class DenseBlock(Layer):
    def __init__(self, num_channels, num_layers, bn_size, growth_rate,
                 dropout, **kw):
        super().__init__()
        ch = num_channels
        layers = []
        for _ in range(num_layers):
            layers.append(DenseLayer(ch, growth_rate, bn_size, dropout,
                                     **kw))
            ch += growth_rate
        self.layers = Sequential(*layers)
        self.out_channels = ch

    def forward(self, x):
        return self.layers(x)


class TransitionLayer(Layer):
    def __init__(self, num_channels, num_output_features, **kw):
        super().__init__()
        self.conv_ac_func = BNACConvLayer(num_channels, num_output_features,
                                          1, **kw)
        self.pool2d_avg = AvgPool2D(kernel_size=2, stride=2)

    def forward(self, x):
        return self.pool2d_avg(self.conv_ac_func(x))


class ConvBNLayer(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 pad=0, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._conv = Conv2D(num_channels, num_filters, filter_size,
                            stride=stride, padding=pad, bias_attr=False,
                            **kw)
        self._batch_norm = bn(num_filters, kw)
        self._act = ReLU()

    def forward(self, x):
        return self._act(self._batch_norm(self._conv(x)))


_CFG = {121: (64, 32, [6, 12, 24, 16]),
        161: (96, 48, [6, 12, 36, 24]),
        169: (64, 32, [6, 12, 32, 32]),
        201: (64, 32, [6, 12, 48, 32]),
        264: (64, 32, [6, 12, 64, 48])}


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"layers must be one of {list(_CFG)}, got "
                             f"{layers}")
        kw = layer_kw(**kw)
        num_init_features, growth_rate, block_config = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1_func = ConvBNLayer(3, num_init_features, 7, stride=2,
                                      pad=3, **kw)
        self.pool2d_max = MaxPool2D(kernel_size=3, stride=2, padding=1)
        blocks = []
        ch = num_init_features
        for i, num_layers in enumerate(block_config):
            block = DenseBlock(ch, num_layers, bn_size, growth_rate, dropout,
                               **kw)
            blocks.append(block)
            ch = block.out_channels
            if i != len(block_config) - 1:
                blocks.append(TransitionLayer(ch, ch // 2, **kw))
                ch = ch // 2
        self.blocks = Sequential(*blocks)
        self.batch_norm = bn(ch, kw)
        self.relu = ReLU()
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.flatten = Flatten()
            self.out = Linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.pool2d_max(self.conv1_func(x))
        x = self.relu(self.batch_norm(self.blocks(x)))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.out(self.flatten(x))
        return x


def _densenet(layers, pretrained, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
