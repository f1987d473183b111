"""AlexNet — port of ``paddle_tpu/vision/models/alexnet.py``."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Flatten, Layer,
                   Linear, MaxPool2D, ReLU, Sequential)
from ._common import layer_kw, no_pretrained


class AlexNet(Layer):
    def __init__(self, num_classes=1000, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
            Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
            Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(0.5), Linear(256 * 6 * 6, 4096, **kw), ReLU(),
            Dropout(0.5), Linear(4096, 4096, **kw), ReLU(),
            Linear(4096, num_classes, **kw))
        self.flatten = Flatten()

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(self.flatten(x))


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
