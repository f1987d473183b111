"""``Linear``, ``Embedding``, ``Dropout``, ``Flatten`` and ``Identity`` —
port of ``paddle_tpu/nn/layer/common.py``.

Every layer with parameters builds them through ``Layer.create_parameter``
on ``device`` (``place`` its alias; None: the CUDA card, raising without
one) in ``dtype`` (None: the default dtype, fp32 as the JAX package's),
drawn from ``generator`` (a ``torch.Generator`` on that device; None takes
its default one) by the JAX package's initialisers: a ``ParamAttr`` /
callable ``weight_attr`` / ``bias_attr`` where given, else Xavier-uniform
``Linear`` weights, zero biases, N(0, 1) embeddings. The draws never
equal ``jax.random``'s: carry JAX weights across with
``models/convert.py``.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal
from ..layer_base import Layer


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` (in, out), Paddle's layout;
    ``bias_attr=False`` builds no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, place=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, " \
               f"out_features={self._out_features}"


class Embedding(Layer):
    """Lookup table ``weight`` (num_embeddings, embedding_dim), N(0, 1)
    unless ``weight_attr`` says otherwise. ``padding_idx``: that row starts
    at zero and, for an index >= 0, its lookups give zeros (so the row gets
    no gradient), as in the JAX package. ``sparse=True`` (a sparse
    gradient) is not ported (NotImplementedError; the JAX package ignores
    it)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 place=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        if sparse:
            raise NotImplementedError("Embedding(sparse=True) is not ported")
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        out = torch.nn.functional.embedding(ids.long(), self.weight)
        if self._padding_idx is not None and self._padding_idx >= 0:
            out = out * (ids != self._padding_idx).unsqueeze(-1).to(
                out.dtype)
        return out

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
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


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
