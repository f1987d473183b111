"""Framework core — port of ``paddle_tpu/framework`` (``dtype``, ``random``,
``param_attr``, the user-facing part of ``core``, ``io_state``, ``flags``,
``monitor``, ``dispatch`` and ``containers``)."""
from .containers import SelectedRows, TensorArray
from .core import Parameter, enable_grad, grad, is_grad_enabled, no_grad
from .dispatch import apply_op, defop
from .dtype import (bfloat16, complex64, complex128, convert_dtype, float16,
                    float32, float64, get_default_dtype, int8, int16, int32,
                    int64, set_default_dtype, uint8)
from .flags import GLOBAL_FLAGS, get_flags, set_flags
from .io_state import load, save
from .monitor import monitor_add, monitor_get, stat_registry
from .param_attr import ParamAttr, WeightNormParamAttr
from .random import get_rng_state, seed, set_rng_state

__all__ = ["GLOBAL_FLAGS", "ParamAttr", "Parameter", "SelectedRows",
           "TensorArray", "WeightNormParamAttr", "apply_op", "bfloat16",
           "complex64", "complex128", "convert_dtype", "defop",
           "enable_grad", "float16", "float32", "float64",
           "get_default_dtype", "get_flags", "get_rng_state", "grad", "int8",
           "int16", "int32", "int64", "is_grad_enabled", "load",
           "monitor_add", "monitor_get", "no_grad", "save", "seed",
           "set_default_dtype", "set_flags", "set_rng_state",
           "stat_registry", "uint8"]
