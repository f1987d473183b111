"""Norm layers — port of ``paddle_tpu/nn/layer/norm.py``: ``LayerNorm``,
``_BatchNormBase`` with ``BatchNorm`` / ``BatchNorm1D`` / ``2D`` / ``3D``,
``GroupNorm``, ``InstanceNorm1D`` / ``2D`` / ``3D``,
``LocalResponseNorm``, ``RMSNorm`` and ``SpectralNorm``. ``SyncBatchNorm`` raises NotImplementedError: it
needs a mesh, which the port's engine does not take yet.

Each layer builds its weight (ones) and bias (zeros) through
``Layer.create_parameter`` on ``device`` (``place`` its alias; None: the
CUDA card, raising without one) in ``dtype`` (None: the default dtype),
honouring ``ParamAttr`` / callable ``weight_attr`` / ``bias_attr``; False
builds none. A BatchNorm keeps its running statistics as the buffers
``_mean`` (zeros) and ``_variance`` (ones), fp32 whatever the layer's
dtype, under the JAX package's names, so that state dicts and
``paddle_tpu.save`` files move over unchanged.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from ..layer_base import Layer


def _affine_params(layer, shape, weight_attr, bias_attr):
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape, attr=weight_attr, default_initializer=Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape, attr=bias_attr, is_bias=True)


class LayerNorm(Layer):
    """LayerNorm over ``normalized_shape`` (an int or a list of the last
    axes' sizes): ``weight`` ones and ``bias`` zeros, each left out when
    its attr is False. One normalised axis with both parameters is the
    hand-written kernel's form on the card (``F.layer_norm``)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, place=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        ns = normalized_shape if isinstance(normalized_shape,
                                            (list, tuple)) \
            else [normalized_shape]
        self._normalized_shape = [int(n) for n in ns]
        self._epsilon = epsilon
        _affine_params(self, self._normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
               f"epsilon={self._epsilon}"


class _BatchNormBase(Layer):
    """BatchNorm over ``num_features`` channels (``F.batch_norm``): batch
    statistics in training, which update the running ones in place
    (``momentum`` weighs the old statistic, as Paddle's), the running ones
    in eval, or as ``use_global_stats`` says."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 place=None, dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine_params(self, [num_features], weight_attr, bias_attr)
        dev = self._make_device()
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
               f"momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """Legacy fluid-style BatchNorm: ``act`` names a functional
    activation applied after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 *, device=None, place=None, dtype=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, device=device,
                         place=place, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm: not ported (it needs a mesh; the port's
    engine trains on one device)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SyncBatchNorm needs a mesh, which the "
                                  "port does not take yet")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError("SyncBatchNorm needs a mesh, which the "
                                  "port does not take yet")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, place=None, dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        _affine_params(self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    """Instance norm (``F.instance_norm``: the input's own statistics,
    channel-first; ``momentum`` and ``data_format`` are accepted and
    unused, as in the JAX package)."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, place=None, dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        self._epsilon = epsilon
        _affine_params(self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, **kw)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, **kw)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class RMSNorm(Layer):
    """``F.rms_norm`` over the last axis with a weight (ones)."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, place=None, dtype=None):
        super().__init__(dtype=dtype, device=device, place=place)
        ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) \
            else [normalized_shape]
        self._normalized_shape = [int(n) for n in ns]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class SpectralNorm(Layer):
    """``F.spectral_norm`` of the weight it is called on (no
    parameters)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon

    def forward(self, weight):
        return F.spectral_norm(weight, self._dim, self._power_iters,
                               self._epsilon)
