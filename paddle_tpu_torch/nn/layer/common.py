"""The common layers — port of ``paddle_tpu/nn/layer/common.py``:
``Linear``, ``Embedding``, ``Dropout`` / ``Dropout2D`` / ``3D``,
``AlphaDropout``, ``Flatten``, ``Identity``, ``Upsample`` /
``UpsamplingBilinear2D`` / ``Nearest2D``, ``Bilinear``, ``Pad1D`` / ``2D``
/ ``3D``, ``ZeroPad2D``, ``CosineSimilarity``, ``PixelShuffle`` /
``Unshuffle``, ``ChannelShuffle``, ``Unfold`` and ``Fold``.

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

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

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


class _Drop(Layer):
    """A dropout layer over ``F.<fn>``, drawing from ``generator``."""

    _fn = None

    def __init__(self, p=0.5, generator=None, **kw):
        super().__init__()
        self.p = p
        self.generator = generator
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, p=self.p, training=self.training,
                                    generator=self.generator, **self._kw)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(_Drop):
    _fn = "dropout2d"

    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__(p, generator, data_format=data_format)


class Dropout3D(_Drop):
    _fn = "dropout3d"

    def __init__(self, p=0.5, data_format="NCDHW", name=None,
                 generator=None):
        super().__init__(p, generator, data_format=data_format)


class AlphaDropout(_Drop):
    _fn = "alpha_dropout"

    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__(p, generator)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Layer):
    """Bilinear with ``align_corners=True`` (the JAX package's lerp)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             True, data_format=self.data_format)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class Bilinear(Layer):
    """``out[b, o] = x1[b] · weight[o] · x2[b] + bias[o]``, weight (out,
    in1, in2) Xavier-uniform, bias zeros (``bias_attr=False``: none)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 place=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _Pad(Layer):
    _format = None

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_Pad):
    _format = "NCL"


class Pad2D(_Pad):
    _format = "NCHW"


class Pad3D(_Pad):
    _format = "NCDHW"


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
