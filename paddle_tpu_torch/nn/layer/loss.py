"""Loss layers — port of ``paddle_tpu/nn/layer/loss.py``: each over the
``F`` function of its name, with the JAX package's arguments and
order."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class _Loss(Layer):
    """Calls ``F.<fn>(*inputs, *args)`` with the arguments the layer was
    built with."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self.a = args

    def forward(self, *inputs):
        return getattr(F, self._fn)(*inputs, *self.a)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight, reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight, reduction, pos_weight)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction, log_target)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction, delta)


class HuberLoss(_Loss):
    _fn = "huber_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(delta, reduction)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class CTCLoss(Layer):
    """``F.ctc_loss`` (the port's own loop: no host read)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class CosineEmbeddingLoss(_Loss):
    _fn = "cosine_embedding_loss"

    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin, p, epsilon, swap, reduction)


class SoftMarginLoss(_Loss):
    _fn = "soft_margin_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)


class MultiLabelSoftMarginLoss(_Loss):
    _fn = "multi_label_soft_margin_loss"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight, reduction)


class MultiMarginLoss(_Loss):
    _fn = "multi_margin_loss"

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(p, margin, weight, reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class GaussianNLLLoss(_Loss):
    _fn = "gaussian_nll_loss"

    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(full, epsilon, reduction)


class PoissonNLLLoss(_Loss):
    _fn = "poisson_nll_loss"

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input, full, epsilon, reduction)
