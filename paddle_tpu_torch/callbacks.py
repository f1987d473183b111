"""``paddle.callbacks`` — the ``hapi`` callbacks (port of
``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                             ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                             VisualDL)
