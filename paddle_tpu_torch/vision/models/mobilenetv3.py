"""MobileNetV3 small and large — port of
``paddle_tpu/vision/models/mobilenetv3.py``."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Flatten, Hardsigmoid,
                   Hardswish, Layer, Linear, ReLU, Sequential)
from ._common import bn, layer_kw, no_pretrained


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvNormActivation(Sequential):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, activation_layer=ReLU, **kw):
        kw = layer_kw(**kw)
        if padding is None:
            padding = (kernel_size - 1) // 2
        layers = [Conv2D(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, groups=groups,
                         bias_attr=False, **kw),
                  bn(out_channels, kw)]
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)


class SqueezeExcitation(Layer):
    def __init__(self, input_channels, squeeze_channels, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(input_channels, squeeze_channels, 1, **kw)
        self.fc2 = Conv2D(squeeze_channels, input_channels, 1, **kw)
        self.relu = ReLU()
        self.hardsigmoid = Hardsigmoid()

    def forward(self, x):
        scale = self.relu(self.fc1(self.avgpool(x)))
        return x * self.hardsigmoid(self.fc2(scale))


class InvertedResidualConfig:
    def __init__(self, in_channels, kernel, expanded_channels, out_channels,
                 use_se, activation, stride, scale=1.0):
        self.in_channels = _make_divisible(in_channels * scale)
        self.kernel = kernel
        self.expanded_channels = _make_divisible(expanded_channels * scale)
        self.out_channels = _make_divisible(out_channels * scale)
        self.use_se = use_se
        self.use_hs = activation == "hardswish"
        self.stride = stride


class InvertedResidual(Layer):
    def __init__(self, cfg: InvertedResidualConfig, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.use_res_connect = cfg.stride == 1 and \
            cfg.in_channels == cfg.out_channels
        act = Hardswish if cfg.use_hs else ReLU
        layers = []
        if cfg.expanded_channels != cfg.in_channels:
            layers.append(ConvNormActivation(
                cfg.in_channels, cfg.expanded_channels, kernel_size=1,
                activation_layer=act, **kw))
        layers.append(ConvNormActivation(
            cfg.expanded_channels, cfg.expanded_channels,
            kernel_size=cfg.kernel, stride=cfg.stride,
            groups=cfg.expanded_channels, activation_layer=act, **kw))
        if cfg.use_se:
            layers.append(SqueezeExcitation(
                cfg.expanded_channels,
                _make_divisible(cfg.expanded_channels // 4), **kw))
        layers.append(ConvNormActivation(
            cfg.expanded_channels, cfg.out_channels, kernel_size=1,
            activation_layer=None, **kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        if self.use_res_connect:
            out = out + x
        return out


class MobileNetV3(Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.config = config
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        firstconv_out = config[0].in_channels
        lastconv_in = config[-1].out_channels
        lastconv_out = 6 * lastconv_in
        self.conv = ConvNormActivation(3, firstconv_out, kernel_size=3,
                                       stride=2, activation_layer=Hardswish,
                                       **kw)
        self.blocks = Sequential(*[InvertedResidual(c, **kw)
                                   for c in config])
        self.lastconv = ConvNormActivation(lastconv_in, lastconv_out,
                                           kernel_size=1,
                                           activation_layer=Hardswish, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(lastconv_out, last_channel, **kw), Hardswish(),
                Dropout(0.2), Linear(last_channel, num_classes, **kw))
            self.flatten = Flatten()

    def forward(self, x):
        x = self.lastconv(self.blocks(self.conv(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(self.flatten(x))
        return x


def _small_cfg(scale):
    def c(*a):
        return InvertedResidualConfig(*a, scale=scale)

    return [c(16, 3, 16, 16, True, "relu", 2),
            c(16, 3, 72, 24, False, "relu", 2),
            c(24, 3, 88, 24, False, "relu", 1),
            c(24, 5, 96, 40, True, "hardswish", 2),
            c(40, 5, 240, 40, True, "hardswish", 1),
            c(40, 5, 240, 40, True, "hardswish", 1),
            c(40, 5, 120, 48, True, "hardswish", 1),
            c(48, 5, 144, 48, True, "hardswish", 1),
            c(48, 5, 288, 96, True, "hardswish", 2),
            c(96, 5, 576, 96, True, "hardswish", 1),
            c(96, 5, 576, 96, True, "hardswish", 1)]


def _large_cfg(scale):
    def c(*a):
        return InvertedResidualConfig(*a, scale=scale)

    return [c(16, 3, 16, 16, False, "relu", 1),
            c(16, 3, 64, 24, False, "relu", 2),
            c(24, 3, 72, 24, False, "relu", 1),
            c(24, 5, 72, 40, True, "relu", 2),
            c(40, 5, 120, 40, True, "relu", 1),
            c(40, 5, 120, 40, True, "relu", 1),
            c(40, 3, 240, 80, False, "hardswish", 2),
            c(80, 3, 200, 80, False, "hardswish", 1),
            c(80, 3, 184, 80, False, "hardswish", 1),
            c(80, 3, 184, 80, False, "hardswish", 1),
            c(80, 3, 480, 112, True, "hardswish", 1),
            c(112, 3, 672, 112, True, "hardswish", 1),
            c(112, 5, 672, 160, True, "hardswish", 2),
            c(160, 5, 960, 160, True, "hardswish", 1),
            c(160, 5, 960, 160, True, "hardswish", 1)]


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_small_cfg(scale), _make_divisible(1024 * scale),
                         scale=scale, num_classes=num_classes,
                         with_pool=with_pool, **kw)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_large_cfg(scale), _make_divisible(1280 * scale),
                         scale=scale, num_classes=num_classes,
                         with_pool=with_pool, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
