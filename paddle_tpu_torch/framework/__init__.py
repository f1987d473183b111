"""Framework core — port of ``paddle_tpu/framework`` (``dtype``, ``random``,
``param_attr``, the user-facing part of ``core`` and ``io_state``)."""
from .core import Parameter, enable_grad, grad, is_grad_enabled, no_grad
from .dtype import (bfloat16, complex64, complex128, convert_dtype, float16,
                    float32, float64, get_default_dtype, int8, int16, int32,
                    int64, set_default_dtype, uint8)
from .io_state import load, save
from .param_attr import ParamAttr, WeightNormParamAttr
from .random import get_rng_state, seed, set_rng_state

__all__ = ["ParamAttr", "Parameter", "WeightNormParamAttr", "bfloat16",
           "complex64", "complex128", "convert_dtype", "enable_grad",
           "float16", "float32", "float64", "get_default_dtype",
           "get_rng_state", "grad", "int8", "int16", "int32", "int64",
           "is_grad_enabled", "load", "no_grad", "save", "seed",
           "set_default_dtype", "set_rng_state", "uint8"]
