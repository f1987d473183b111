"""Losses — port of ``paddle_tpu/nn/functional/loss.py``:
``cross_entropy`` for hard labels (fp32 log-softmax over ``axis``, labels
equal to ``ignore_index`` contribute 0, and ``reduction="mean"`` divides
by the count of the other labels, at least 1), ``nll_loss``, ``mse_loss``
and ``l1_loss``, with the JAX package's reductions."""
from __future__ import annotations

import torch

REDUCTIONS = ("mean", "none")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy of ``input`` logits (..., C) against integer
    ``label`` (...) or (..., 1), in fp32, reduced by ``"mean"`` or not at
    all (``"none"``). Class weights, soft labels, label smoothing,
    ``use_softmax=False`` and ``reduction="sum"`` are not ported (they
    raise)."""
    if weight is not None or soft_label or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels, label smoothing and "
            "use_softmax=False are not ported yet")
    if reduction not in REDUCTIONS:
        raise NotImplementedError(f"reduction must be one of {REDUCTIONS}, "
                                  f"got {reduction!r}")
    axis = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=axis)
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    # an ignored label may lie outside [0, C): gather a valid index there
    idx = torch.where(valid, lbl, torch.zeros_like(lbl)).unsqueeze(axis)
    loss = -torch.gather(logp, axis, idx).squeeze(axis)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    return loss


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    if reduction == "none":
        return v
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[i, label[i]]`` (log-probabilities (N, C, …)), 0 where the
    label is ``ignore_index``; weighted by ``weight[label]`` when given.
    ``"mean"`` divides by the summed weights (at least 1e-12), or by the
    count of valid labels (at least 1)."""
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        wt = torch.where(valid, weight[safe], torch.zeros_like(loss))
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / wt.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)
