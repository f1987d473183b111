"""Grad mode, ``grad`` and ``Parameter`` — port of the user-facing part of
``paddle_tpu/framework/core.py``.

The JAX package wraps each ``jax.Array`` in a ``Tensor`` and records an
eager tape of ``jax.vjp`` closures, swept in reverse by its own
``backward``. The port has no counterpart of either: its tensor is
``torch.Tensor`` and its autograd is PyTorch's (``loss.backward()``,
``torch.autograd.grad``). What stays is the surface a Paddle program
calls: :class:`no_grad` (a context manager and a decorator),
:func:`enable_grad`, :func:`is_grad_enabled`, :func:`grad` and
:class:`Parameter`.

Divergences from Paddle that the port keeps visible rather than papers
over: a plain tensor has no ``stop_gradient`` attribute (read
``requires_grad``, its inverse; only :class:`Parameter` carries both), and
``to_tensor`` returns a ``torch.Tensor`` whose ``requires_grad`` is
``not stop_gradient``.
"""
from __future__ import annotations

import torch

__all__ = ["Parameter", "enable_grad", "grad", "is_grad_enabled", "no_grad"]

# PyTorch's grad mode is the port's: the same objects, under Paddle's names
no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (a list, None for an unused input under ``allow_unused``),
    leaving every ``.grad`` untouched. An output given no ``grad_outputs``
    gets ones, as in the JAX package (PyTorch asks for them past a
    scalar); an unused input without ``allow_unused`` raises
    RuntimeError."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    grad_outputs = [torch.ones_like(o) if g is None else g
                    for o, g in zip(outputs, grad_outputs)]
    return list(torch.autograd.grad(
        outputs, inputs, grad_outputs=grad_outputs,
        retain_graph=bool(retain_graph) or create_graph,
        create_graph=create_graph, allow_unused=allow_unused))


class Parameter(torch.nn.Parameter):
    """A trainable tensor with Paddle's attributes: ``trainable`` (the
    engine trains only trainable parameters; a plain attribute, as in the
    JAX package), ``stop_gradient`` (the inverse of ``requires_grad``: a
    property over it), ``optimize_attr`` (``{"learning_rate": …}`` from a
    ``ParamAttr``; stored, not applied, as in JAX), ``regularizer``,
    ``name`` and ``persistable``. It starts with
    ``requires_grad = trainable``."""

    def __new__(cls, data=None, trainable=True, name=""):
        if data is None:
            data = torch.empty(0)
        return super().__new__(cls, data, requires_grad=bool(trainable))

    def __init__(self, data=None, trainable=True, name=""):
        self.trainable = bool(trainable)
        self._pd_name = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.persistable = True
        self.is_distributed = False

    # a tensor's own ``name`` attribute cannot be written: Paddle's name
    # lives beside it
    @property
    def name(self) -> str:
        return self._pd_name

    @name.setter
    def name(self, value) -> None:
        self._pd_name = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value) -> None:
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.trainable, self.name)
        out.requires_grad_(self.requires_grad)
        for k, v in self.__dict__.items():
            out.__dict__[k] = (dict(v) if isinstance(v, dict) else v)
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        # rebuilt as this class with its attributes (PyTorch's own reduce
        # would rebuild a plain nn.Parameter)
        return (_rebuild_parameter,
                (self.data, self.requires_grad, dict(self.__dict__)))


def _rebuild_parameter(data, requires_grad, state):
    p = Parameter(data, state.get("trainable", True),
                  state.get("_pd_name", ""))
    p.__dict__.update(state)
    p.requires_grad_(requires_grad)
    return p
