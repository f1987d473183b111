"""``paddle.nn`` — port of ``paddle_tpu/nn``: ``Layer``, the layers, the
functional ops, the initializers and the gradient clips."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer_base import HookRemoveHelper, Layer

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "HookRemoveHelper", "Layer", "functional", "initializer",
           *_layers]
