"""LeNet — port of ``paddle_tpu/vision/models/lenet.py`` (1 x 28 x 28
inputs), with the JAX package's layer names."""
from __future__ import annotations

from ...nn import Conv2D, Flatten, Layer, Linear, MaxPool2D, ReLU, Sequential
from ._common import layer_kw


class LeNet(Layer):
    def __init__(self, num_classes=10, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Flatten(), Linear(400, 120, **kw),
                                 Linear(120, 84, **kw),
                                 Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
