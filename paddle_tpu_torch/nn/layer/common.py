"""``Linear``, ``Embedding`` and ``Dropout`` — port of
``paddle_tpu/nn/layer/common.py``.

Every layer builds its parameters on ``device`` (None: the CUDA card,
raising without one; ``"cpu"`` for the plain path) in ``dtype`` (fp32 by
default, as the JAX package's layers), drawn from ``generator`` (a
``torch.Generator`` on that device; None takes PyTorch's default one) with
the JAX package's default initialisers: Xavier-uniform ``Linear`` weights,
zero biases, N(0, 1) embeddings. The draws never equal ``jax.random``'s:
carry JAX weights across with ``models/convert.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ... import resolve_device
from .. import functional as F


def _unported_attr(attr, what):
    if attr is not None and attr is not False:
        raise NotImplementedError(f"{what}: ParamAttr / initializer "
                                  f"objects are not ported yet")


def _param(t):
    return nn.Parameter(t, requires_grad=True)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` (in, out), Paddle's layout;
    ``bias_attr=False`` builds no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        _unported_attr(weight_attr, "Linear weight_attr")
        _unported_attr(bias_attr, "Linear bias_attr")
        device = resolve_device(device)
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, dtype=dtype, device=device)
        self.weight = _param(w.uniform_(-limit, limit, generator=generator))
        self.bias = None if bias_attr is False else _param(
            torch.zeros(out_features, dtype=dtype, device=device))
        self._in_features, self._out_features = in_features, out_features

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, " \
               f"out_features={self._out_features}"


class Embedding(nn.Module):
    """Lookup table ``weight`` (num_embeddings, embedding_dim), N(0, 1)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if padding_idx is not None or sparse:
            raise NotImplementedError("Embedding padding_idx / sparse are "
                                      "not ported yet")
        _unported_attr(weight_attr, "Embedding weight_attr")
        device = resolve_device(device)
        w = torch.empty(num_embeddings, embedding_dim, dtype=dtype,
                        device=device)
        self.weight = _param(w.normal_(0.0, 1.0, generator=generator))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    """``F.dropout`` in training (``self.training``), the identity
    otherwise. ``generator`` is the ``torch.Generator`` it draws from; a
    model sets it after construction (``copy.deepcopy`` of a layer would
    copy a generator's state, and every copy would then drop the same
    elements)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
