"""``Layer`` — port of ``paddle_tpu/nn/layer_base.py``.

``Layer`` is a ``torch.nn.Module`` that adds Paddle's methods; PyTorch's
own stay (``forward`` hooks, ``train(mode)``, ``apply``, ``load_state_dict``
…), so a ``Layer`` nests in a plain module and a plain module in a
``Layer``. It adds:

- :meth:`Layer.create_parameter` (``shape, attr, dtype, is_bias,
  default_initializer``): the initializer of a ``ParamAttr`` (or a callable
  ``attr``), else ``default_initializer``, else the global one
  (``initializer.set_global_initializer``), else ``Constant(0)`` for a bias
  and ``XavierUniform`` for a weight, as in the JAX package; the attr's
  ``trainable``, ``learning_rate`` (stored in ``optimize_attr``),
  ``regularizer`` and name. It builds on the layer's
  ``device`` (``place`` its alias; None: the CUDA card, raising without
  one), drawing from its ``generator`` (None: the device's default one).
- ``register_buffer(name, tensor, persistable=True)``;
- ``parameters()`` / ``buffers()`` as lists and ``named_parameters`` /
  ``named_buffers`` with ``include_sublayers``, ``sublayers``,
  ``named_sublayers``, ``add_sublayer``, ``add_parameter``;
- ``state_dict`` (parameters and persistable buffers by structured name)
  and ``set_state_dict`` (``set_dict``, ``load_dict``): values copied IN
  PLACE, cast to each target's dtype (a CUDA graph reads the tensors by
  address), a shape mismatch raising ValueError; returns (missing,
  unexpected);
- ``register_forward_post_hook`` (its handle's ``remove()`` drops it),
  ``clear_gradients``, ``astype``, and ``to`` taking Paddle's ``place``,
  ``blocking`` and dtype names.

Divergences from the JAX package, kept visible: ``state_dict()`` holds
detached tensors that share the parameters' storage (JAX's holds the
``Parameter`` objects); ``sublayers()`` leaves the layer itself out (the
JAX package's includes it at the empty prefix, which Paddle's does not).
The parameter order is the JAX package's: a layer's own in creation
order, then each sublayer's, depth first, each shared tensor once.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from .. import resolve_place
from ..framework.core import Parameter
from ..framework.dtype import _STR2DTYPE, convert_dtype, get_default_dtype
from ..framework.io_state import from_numpy

__all__ = ["HookRemoveHelper", "Layer"]


# the handle a hook registration returns: ``remove()`` drops the hook
HookRemoveHelper = RemovableHandle


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return from_numpy(np.asarray(v), "cpu")


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype=None, *, device=None,
                 place=None, generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._name_scope = name_scope or type(self).__name__.lower()
        # resolved where a tensor is made: a layer that makes none (an
        # activation, a container) needs no card
        self._device_arg = (device, place)
        self._generator = generator

    # -------------------------------------------------------------- creation
    def _make_device(self) -> torch.device:
        return resolve_place(*self._device_arg)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        from . import initializer as I
        from ..framework.param_attr import ParamAttr

        dtype = convert_dtype(dtype) or self._dtype
        init = default_initializer
        name, learning_rate, trainable = None, 1.0, True
        if attr is not None and attr is not False:
            if isinstance(attr, ParamAttr):
                init = attr.initializer or init
                name = attr.name
                learning_rate = attr.learning_rate
                trainable = attr.trainable
            elif isinstance(attr, str):
                name = attr
            elif callable(attr):
                init = attr
        if init is None:
            init = I._global_initializer(is_bias)
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        value = init([int(s) for s in shape], dtype,
                     device=self._make_device(), generator=self._generator)
        p = Parameter(value, trainable=trainable, name=name or "")
        p.optimize_attr["learning_rate"] = learning_rate
        if getattr(attr, "regularizer", None) is not None:
            p.regularizer = attr.regularizer
        return p

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None) -> None:
        """A buffer; ``persistable=False`` (PyTorch's ``persistent``) keeps
        it out of ``state_dict``."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)

    # ------------------------------------------------------------- traversal
    def parameters(self, include_sublayers=True, recurse=True
                   ) -> List[torch.Tensor]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers and recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=True, remove_duplicate=True
                         ) -> Iterator[Tuple[str, torch.Tensor]]:
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers and recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=True
                ) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers and recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=True,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers and recurse,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(str(name), parameter)
        return parameter

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        """Parameters and persistable buffers by structured name (detached
        tensors sharing their storage). Also called by a PyTorch parent
        with ``prefix=`` / ``keep_vars=``."""
        prefix = structured_name_prefix or prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        out = {} if destination is None else destination
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors, arrays, Parameters) into
        the parameters and buffers of the same names, in place and in
        their dtypes; returns (missing, unexpected) name lists."""
        own = self.state_dict(keep_vars=True)
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt, val = own[k], _as_tensor(v)
            if tuple(val.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt "
                                 f"{tuple(val.shape)} vs model "
                                 f"{tuple(tgt.shape)}")
            tgt.copy_(val.to(tgt.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ----------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, output)``; a non-None result replaces the
        output (PyTorch's forward hook; ``register_forward_pre_hook`` is
        PyTorch's own, with Paddle's ``hook(layer, inputs)``)."""
        return self.register_forward_hook(hook)

    # ------------------------------------------------------------- utilities
    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def to(self, *args, device=None, dtype=None, blocking=None, place=None,
           **kwargs):
        """PyTorch's ``to`` (floating parameters and buffers cast, in the
        same Parameter objects), also taking Paddle's ``place``, dtype
        names and ``blocking``."""
        args = tuple(convert_dtype(a) if isinstance(a, str) and a in
                     _STR2DTYPE else a for a in args)
        if place is not None or device is not None:
            kwargs["device"] = resolve_place(device, place)
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        out = super().to(*args, **kwargs)
        new = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if new is not None and new.is_floating_point:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = new
        return out

    def astype(self, dtype):
        return self.to(dtype=convert_dtype(dtype))

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def half(self):
        return self.to(dtype=torch.float16)

    def full_name(self) -> str:
        return self._name_scope
