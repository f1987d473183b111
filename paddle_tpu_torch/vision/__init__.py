"""``paddle.vision`` — port of ``paddle_tpu/vision``: ``vision.models``
(the ResNet family, the rest of the zoo and the OCR pair). ``vision/ops``,
``datasets`` and ``transforms`` are not ported yet (ROADMAP item 8d)."""
from . import models

__all__ = ["models"]
