"""The remaining layers — port of ``paddle_tpu/nn/layer/extras.py``:
``PairwiseDistance``, ``Softmax2D``, ``TripletMarginWithDistanceLoss``,
``HSigmoidLoss``, ``RNNTLoss``, ``MaxUnPool1D`` / ``3D``, and
``BeamSearchDecoder`` with ``dynamic_decode``.

``dynamic_decode`` decodes greedily whatever ``beam_size`` says, and is
driven from the host (each step's argmax read back), as the JAX
package's is."""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from ..functional.extras import _default_tree, _hsigmoid
from ..initializer import XavierUniform
from ..layer_base import Layer


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channel axis of (C, H, W) or (N, C, H, W)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(f"Softmax2D takes 3-D or 4-D inputs, got "
                             f"{x.dim()}-D")
        return F.softmax(x, axis=-3)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative,
            distance_function=self.distance_function, margin=self.margin,
            swap=self.swap, reduction=self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the complete binary tree of
    ``num_classes`` leaves (``weight`` (num_classes - 1, feature_size)
    Xavier-uniform, ``bias`` zeros), or a custom tree given to
    ``forward`` as ``path_table`` / ``path_code`` (``is_custom``). The
    default tree's paths are plain attributes (the JAX package does not
    keep them in its state)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, place=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        if num_classes < 2:
            raise ValueError(f"HSigmoidLoss needs num_classes >= 2, got "
                             f"{num_classes}")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True)
        if not is_custom:
            self._table, self._codes = _default_tree(num_classes)

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom:
            table, codes = path_table.long(), path_code.to(input.dtype)
        else:
            flat = label.long().reshape(label.shape[0])
            table = self._table.to(input.device)[flat]
            codes = self._codes.to(device=input.device,
                                   dtype=input.dtype)[flat]
        return _hsigmoid(input, label, self.weight, self.bias, table, codes)


class RNNTLoss(Layer):
    """``F.rnnt_loss`` (``fastemit_lambda`` 0 by default: nonzero
    raises)."""

    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, logits, labels, logit_lengths, label_lengths):
        return F.rnnt_loss(logits, labels, logit_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, *self.a)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, *self.a)


class BeamSearchDecoder:
    """A cell with its embedding and output functions, decoded by
    :func:`dynamic_decode` (greedily whatever ``beam_size`` says)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _logits(self, token_emb, states):
        out, new_states = self.cell(token_emb, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def _first_tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (list, tuple)):
        for a in v:
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Greedy decoding from ``decoder.start_token`` for up to
    ``max_step_num`` steps, a finished row emitting ``end_token``, until
    every row has finished; each step's argmax is read on the host.
    Returns (token ids (B, T), or (T, B) with ``output_time_major``, and
    each row's length: the index of its first ``end_token``, or T), int64
    on the device of ``inits``."""
    ref = _first_tensor(inits)
    B = ref.shape[0] if ref is not None else 1
    dev = ref.device if ref is not None else torch.device("cpu")
    states = inits
    tokens = torch.full([B], decoder.start_token, dtype=torch.long,
                        device=dev)
    finished = np.zeros(B, bool)
    outputs = []
    for _ in range(max_step_num):
        emb = decoder.embedding_fn(tokens) \
            if decoder.embedding_fn is not None else tokens
        logits, states = decoder._logits(emb, states)
        nt = logits.argmax(-1).reshape(-1).cpu().numpy().astype(np.int64)
        nt[finished] = decoder.end_token
        outputs.append(nt.copy())
        finished |= nt == decoder.end_token
        tokens = torch.from_numpy(nt).to(dev)
        if finished.all():
            break
    ids = np.stack(outputs, axis=0 if output_time_major else 1)
    lengths = np.argmax(np.concatenate(
        [ids == decoder.end_token, np.ones_like(ids[..., :1], bool)],
        axis=-1), axis=-1)
    return (torch.from_numpy(ids).to(dev),
            torch.from_numpy(lengths.astype(np.int64)).to(dev))
