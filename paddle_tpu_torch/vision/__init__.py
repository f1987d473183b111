"""``paddle.vision`` — port of ``paddle_tpu/vision``: ``vision.models``
(the ResNet family, the rest of the zoo and the OCR pair), ``vision.ops``
(the RoI family, deformable convolution, the box utilities, the YOLO head
and loss, the NMS family), ``vision.datasets`` and ``vision.transforms``."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401

__all__ = ["datasets", "models", "ops", "transforms"]
