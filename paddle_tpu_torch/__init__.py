"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find (``paddle_tpu_torch.ops.
fused_norm`` ports ``paddle_tpu.ops.fused_norm``, and so on). It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing from
``paddle_tpu``.

The first slice is paged continuous-batching serving of a Llama model:

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.inference.serving import GenerationServer

    model = LlamaForCausalLM(llama3_8b_config())          # on the card
    srv = GenerationServer(model, cache="paged", max_batch=8)
    rid = srv.submit(prompt_ids, max_new_tokens=32)
    out = srv.run()[rid]

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with ``device=None`` and no CUDA device they raise instead of quietly
running on the CPU (:func:`resolve_device`).

The framework core and the layer surface are exported here as a Paddle
program calls them (``import paddle_tpu_torch as paddle``):
``paddle.to_tensor``, ``paddle.seed``, ``paddle.save`` / ``paddle.load``,
``paddle.no_grad``, ``paddle.grad``, ``paddle.set_flags`` /
``get_flags``, the dtypes, every ``paddle.tensor`` function
(``paddle.matmul``, ``paddle.topk`` …), ``paddle.linalg``,
``paddle.device``, ``paddle.nn`` (``paddle.nn.Conv2D``, ``paddle.nn.LSTM``,
``paddle.nn.functional.ctc_loss`` …, ``paddle.nn.utils``),
``paddle.optimizer``, ``paddle.amp``, ``paddle.vision`` (``models``: the
zoo and the OCR pair; ``ops``, ``datasets``, ``transforms``), the data
pipeline (``paddle.io``, ``paddle.reader``, ``paddle.batch``),
``paddle.metric`` and the high-level API (``paddle.Model``,
``paddle.callbacks``, ``paddle.summary``); the tensor is ``torch.Tensor``:

    import paddle_tpu_torch as paddle

    model = paddle.vision.models.resnet50(num_classes=10)   # on the card
    x = paddle.to_tensor(images)                            # on the card

    model = paddle.Model(paddle.vision.models.LeNet())      # on the card
    model.prepare(paddle.optimizer.Adam(parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    model.fit(paddle.vision.datasets.MNIST(transform=...), num_workers=2)

The loader yields CPU tensors (its workers never touch CUDA); ``Model``
moves each batch to its network's device. ``paddle.dataset`` (the legacy
readers) is not ported yet: reaching it raises NotImplementedError.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_place"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises when there is none.
    An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    returned as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: paddle_tpu_torch runs on the "
                "card by default — pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def resolve_place(device=None, place=None) -> torch.device:
    """:func:`resolve_device` of ``device`` or of Paddle's ``place`` (its
    alias: ``"gpu"`` / ``"gpu:1"`` name the CUDA devices); both given and
    different raise ValueError."""
    if place is not None:
        if isinstance(place, str):
            place = place.replace("gpu", "cuda")
        place = torch.device(place)
        if device is not None and torch.device(device) != place:
            raise ValueError(f"device={device!r} and place={place!r} "
                             f"disagree")
        device = place
    return resolve_device(device)


# the Paddle surface, after the two functions above, which its modules
# import
from . import (amp, device, framework, linalg, nn, optimizer,  # noqa: E402
               tensor, vision)
from . import callbacks, io, metric, reader  # noqa: E402
from .batch import batch  # noqa: E402
from .hapi import Model, summary  # noqa: E402
from .compat import cast  # noqa: E402
from .cost_model import flops  # noqa: E402
from .device import (get_device, is_compiled_with_cuda,  # noqa: E402
                     is_compiled_with_xpu, set_device)
from .framework import (ParamAttr, Parameter, bfloat16, complex64,  # noqa
                        complex128, enable_grad, float16, float32, float64,
                        get_default_dtype, get_flags, get_rng_state, grad,
                        int8, int16, int32, int64, is_grad_enabled, load,
                        no_grad, save, seed, set_default_dtype, set_flags,
                        set_rng_state, uint8)
from .tensor import *  # noqa: E402,F401,F403
from .tensor import __all__ as _tensor_all  # noqa: E402

__all__ += ["Model", "ParamAttr", "Parameter", "amp", "batch",
            "bfloat16", "callbacks", "cast",
            "complex64", "complex128", "device", "enable_grad", "float16",
            "float32", "float64", "flops", "framework", "get_default_dtype",
            "get_device", "get_flags", "get_rng_state", "grad", "int8",
            "int16", "int32", "int64", "io", "is_compiled_with_cuda",
            "is_compiled_with_xpu", "is_grad_enabled", "linalg", "load",
            "metric", "nn", "no_grad", "optimizer", "reader", "save", "seed",
            "summary",
            "set_default_dtype", "set_device", "set_flags", "set_rng_state",
            "tensor", "uint8", "vision", *_tensor_all]


def __getattr__(name):
    if name == "dataset":
        raise NotImplementedError(
            "paddle.dataset (the legacy dataset readers) is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
