"""ShuffleNetV2 — port of ``paddle_tpu/vision/models/shufflenetv2.py``
(scales 0.25-2.0, ReLU or swish)."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, ChannelShuffle, Conv2D, Flatten, Layer,
                   Linear, MaxPool2D, ReLU, Sequential, Swish)
from ._common import bn, layer_kw, no_pretrained

_STAGE_OUT = {0.25: [-1, 24, 24, 48, 96, 512],
              0.33: [-1, 24, 32, 64, 128, 512],
              0.5: [-1, 24, 48, 96, 192, 1024],
              1.0: [-1, 24, 116, 232, 464, 1024],
              1.5: [-1, 24, 176, 352, 704, 1024],
              2.0: [-1, 24, 244, 488, 976, 2048]}


def _conv_bn_act(inp, oup, k, stride, padding, groups=1, act=ReLU, kw=None):
    layers = [Conv2D(inp, oup, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **kw), bn(oup, kw)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class InvertedResidual(Layer):
    def __init__(self, in_channels, out_channels, stride, act=ReLU, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self._stride = stride
        bf = out_channels // 2
        self._conv_pw = _conv_bn_act(in_channels // 2, bf, 1, 1, 0, act=act,
                                     kw=kw)
        self._conv_dw = _conv_bn_act(bf, bf, 3, stride, 1, groups=bf,
                                     act=None, kw=kw)
        self._conv_linear = _conv_bn_act(bf, bf, 1, 1, 0, act=act, kw=kw)
        self._shuffle = ChannelShuffle(2)

    def forward(self, x):
        x1, x2 = x.chunk(2, 1)
        out = torch.cat([x1, self._conv_linear(self._conv_dw(
            self._conv_pw(x2)))], 1)
        return self._shuffle(out)


class InvertedResidualDS(Layer):
    """The downsampling block: both branches convolve, stride 2."""

    def __init__(self, in_channels, out_channels, stride, act=ReLU, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        bf = out_channels // 2
        self._conv_dw_1 = _conv_bn_act(in_channels, in_channels, 3, stride,
                                       1, groups=in_channels, act=None,
                                       kw=kw)
        self._conv_linear_1 = _conv_bn_act(in_channels, bf, 1, 1, 0,
                                           act=act, kw=kw)
        self._conv_pw_2 = _conv_bn_act(in_channels, bf, 1, 1, 0, act=act,
                                       kw=kw)
        self._conv_dw_2 = _conv_bn_act(bf, bf, 3, stride, 1, groups=bf,
                                       act=None, kw=kw)
        self._conv_linear_2 = _conv_bn_act(bf, bf, 1, 1, 0, act=act, kw=kw)
        self._shuffle = ChannelShuffle(2)

    def forward(self, x):
        x1 = self._conv_linear_1(self._conv_dw_1(x))
        x2 = self._conv_linear_2(self._conv_dw_2(self._conv_pw_2(x)))
        return self._shuffle(torch.cat([x1, x2], 1))


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        act_layer = Swish if act == "swish" else ReLU
        if scale not in _STAGE_OUT:
            raise NotImplementedError(f"unsupported scale {scale}")
        stage_out = _STAGE_OUT[scale]
        self._conv1 = _conv_bn_act(3, stage_out[1], 3, 2, 1, act=act_layer,
                                   kw=kw)
        self._max_pool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        blocks = []
        in_c = stage_out[1]
        for stage_id, num_repeat in enumerate([4, 8, 4]):
            out_c = stage_out[stage_id + 2]
            for i in range(num_repeat):
                if i == 0:
                    blocks.append(InvertedResidualDS(in_c, out_c, 2,
                                                     act=act_layer, **kw))
                else:
                    blocks.append(InvertedResidual(out_c, out_c, 1,
                                                   act=act_layer, **kw))
            in_c = out_c
        self._blocks = Sequential(*blocks)
        self._last_conv = _conv_bn_act(in_c, stage_out[-1], 1, 1, 0,
                                       act=act_layer, kw=kw)
        if with_pool:
            self._pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self._flatten = Flatten()
            self._fc = Linear(stage_out[-1], num_classes, **kw)

    def forward(self, x):
        x = self._max_pool(self._conv1(x))
        x = self._last_conv(self._blocks(x))
        if self.with_pool:
            x = self._pool2d_avg(x)
        if self.num_classes > 0:
            x = self._fc(self._flatten(x))
        return x


def _shufflenet(scale, act, pretrained, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, "relu", pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, "swish", pretrained, **kwargs)
