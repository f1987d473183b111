"""Weight-decay regularizers — port of ``paddle_tpu/regularizer.py``.

Paddle semantics: a regularizer set as an optimizer's ``weight_decay`` is
folded into the gradient before the update rule runs, ``grad += coeff ·
d penalty / d w``: ``coeff · w`` for L2, ``coeff · sign(w)`` for L1.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    """Base class: ``coeff`` and the penalty's gradient ``__call__``."""

    _mode = "l2"

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        # the alias fluid-era code reads
        self._regularization_coeff = self._coeff

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param):
        """d(penalty)/d(param), to be added to the gradient."""
        if self._mode == "l1":
            return self._coeff * torch.sign(param)
        return self._coeff * param

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: loss += coeff · sum(|w|)."""

    _mode = "l1"


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: loss += 0.5 · coeff · sum(w²)."""

    _mode = "l2"
