"""``paddle.vision`` — port of ``paddle_tpu/vision`` (the ResNet family of
``vision/models`` so far)."""
from . import models

__all__ = ["models"]
