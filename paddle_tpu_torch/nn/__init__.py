"""``paddle.nn`` — port of ``paddle_tpu/nn``: ``Layer``, the layers, the
functional ops, the initializers, the gradient clips, ``nn.utils``, LoRA
and the int8 layers, under every name the JAX package exports."""
from . import functional, initializer, quant, utils
from ..framework.param_attr import ParamAttr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer.extras import dynamic_decode
from .layer_base import HookRemoveHelper, Layer
from .lora import (LoRALinear, attach_lora, export_adapter, load_adapter,
                   lora_parameters, merge_lora)
from .utils import spectral_norm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "HookRemoveHelper", "Layer", "LoRALinear", "ParamAttr",
           "attach_lora", "clip_grad_norm_", "clip_grad_value_",
           "dynamic_decode", "export_adapter", "functional", "initializer",
           "load_adapter", "lora_parameters", "merge_lora", "quant",
           "spectral_norm", "utils", *_layers]
