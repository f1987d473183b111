"""Losses — port of ``paddle_tpu/nn/functional/loss.py``, each the JAX
package's arithmetic on tensors, with its reductions (``"mean"``,
``"sum"``, ``"none"``; ``kl_div`` also ``"batchmean"``).

``cross_entropy`` takes hard labels (fp32 log-softmax over ``axis``, a
label equal to ``ignore_index`` contributing 0, ``"mean"`` dividing by
the count of the other labels, at least 1, or by their summed class
weights) or soft ones (a label of the logits' shape, or
``soft_label=True``), ``label_smoothing`` and ``use_softmax=False``.

``ctc_loss`` is the JAX package's forward algorithm in log space: -1e30
stands for minus infinity (an infeasible row's loss is ~1e30), it
applies ``log_softmax`` to its input itself, rows stop at
``input_lengths``, and ``"mean"`` divides each row by its label length
(at least 1) before the mean. It is a loop over the time steps of plain
device ops that autograd differentiates: no host read, so a CUDA graph
captures it, and deterministic (PyTorch's ``F.ctc_loss`` on CUDA copies
the lengths to the host and sums its gradient with atomics)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

# the transducer loss is the extras one (the JAX package's loss.rnnt_loss
# raises; its functional exports the extras one)
from .extras import rnnt_loss  # noqa: F401

NEG_INF = -1e30


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    if reduction == "none":
        return v
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of ``input`` logits against integer
    ``label`` (...) or (..., 1), or soft labels of the logits' shape, in
    fp32 (module docstring)."""
    axis = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input.float(), dim=axis)
    else:
        logp = torch.log(input.float().clamp_min(1e-30))
    if soft_label or (label.dim() == input.dim()
                      and tuple(label.shape) == tuple(input.shape)):
        tgt = label.float()
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + \
                label_smoothing / input.shape[axis]
        loss = -(tgt * logp).sum(axis)
        if weight is not None:
            wshape = [1] * input.dim()
            wshape[axis] = -1
            loss = loss * (tgt * weight.reshape(wshape)).sum(axis)
        return _reduce(loss, reduction)
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    # an ignored label may lie outside [0, C): gather a valid index there
    idx = torch.where(valid, lbl, torch.zeros_like(lbl))
    if label_smoothing > 0:
        k = input.shape[axis]
        onehot = TF.one_hot(idx, k).float().movedim(-1, axis)
        tgt = onehot * (1 - label_smoothing) + label_smoothing / k
        loss = -(tgt * logp).sum(axis)
    else:
        loss = -torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        wt = torch.where(valid, weight[idx], torch.zeros_like(loss))
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / wt.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """``cross_entropy(reduction="none")`` with the class axis kept (size
    1), and the softmax beside it when asked."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


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


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = (input - label).abs()
    loss = torch.where(d <= delta, 0.5 * d * d,
                       delta * d - 0.5 * delta * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = input.float().clamp(1e-12, 1 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _softplus_neg_abs(z):
    """``log(1 + exp(-|z|))``, JAX's ``logaddexp(0, -|z|)``."""
    return torch.logaddexp(torch.zeros_like(z), -z.abs())


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z = logit.float()
    t = label.float()
    if pos_weight is not None:
        log_w = (pos_weight - 1) * t + 1
        loss = (1 - t) * z + log_w * (_softplus_neg_abs(z)
                                      + torch.clamp_min(-z, 0.0))
    else:
        loss = torch.clamp_min(z, 0) - z * t + _softplus_neg_abs(z)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
    return _reduce(loss, reduction)


def _p_dist(u, v, p, epsilon, keepdim=False):
    return torch.pow(torch.pow((u - v).abs() + epsilon, p).sum(
        -1, keepdim=keepdim), 1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _p_dist(input, positive, p, epsilon)
    dn = _p_dist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _p_dist(positive, negative, p, epsilon))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    loss = -(label * TF.logsigmoid(input) + (1 - label)
             * TF.logsigmoid(-input)).mean(-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit.float())
    ce = torch.clamp_min(logit, 0) - logit * label + \
        _softplus_neg_abs(logit)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log1p(epsilon - input + 1e-30)


def square_error_cost(input, label):
    return (input - label).square()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of logits or log-probabilities (T, B, C) against labels (B, L)
    (module docstring). ``norm_by_times`` is ignored, as in the JAX
    package."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    T, B, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = lp.device
    lbl_len = label_lengths.long()
    in_len = input_lengths.long()
    # extended labels: blank, l1, blank, l2, … blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    # lp at each extended label, (T, B, S); indexing's backward sums the
    # repeated labels in a fixed order (index_put_ with accumulate),
    # gather's with atomics
    emit = lp[torch.arange(T, device=dev).view(T, 1, 1),
              torch.arange(B, device=dev).view(1, B, 1), ext.unsqueeze(0)]
    neg = torch.full((B, 1), NEG_INF, device=dev)
    alpha = torch.cat([emit[0, :, :1],
                       torch.where((lbl_len > 0).unsqueeze(1),
                                   emit[0, :, 1:2], neg),
                       neg.expand(B, S - 2)], 1)
    # a label may skip the blank before it unless it repeats the one
    # two places back (every blank repeats one)
    no_skip = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                         ext[:, 2:] == ext[:, :-2]], 1)
    neg2 = neg.expand(B, 2)
    for t in range(1, T):
        shift1 = torch.cat([neg, alpha[:, :-1]], 1)
        shift2 = torch.where(no_skip, NEG_INF,
                             torch.cat([neg2, alpha[:, :-2]], 1))
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) \
            + emit[t]
        # frozen past the row's input length
        alpha = torch.where((t < in_len).unsqueeze(1), new, alpha)
    end1 = alpha.gather(1, (2 * lbl_len).unsqueeze(1)).squeeze(1)
    end2 = alpha.gather(1, (2 * lbl_len - 1).clamp_min(0).unsqueeze(1)
                        ).squeeze(1)
    loss = -torch.logaddexp(end1, end2)
    if reduction == "mean":
        return (loss / lbl_len.float().clamp_min(1.0)).mean()
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    logits = anchor @ positive.T
    t = (labels.unsqueeze(1) == labels.unsqueeze(0)).float()
    t = t / t.sum(-1, keepdim=True)
    ce = -(t * torch.log_softmax(logits, -1)).sum(-1)
    reg = l2_reg * ((anchor * anchor).sum(-1).mean()
                    + (positive * positive).sum(-1).mean()) * 0.25
    return ce.mean() + reg


def dice_loss(input, label, epsilon=1e-5, name=None):
    t1 = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * t1).sum(dims)
    union = input.sum(dims) + t1.sum(dims)
    return (1 - 2 * inter / (union + epsilon)).mean()


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = variance.clamp_min(epsilon)
    loss = 0.5 * (torch.log(var) + (label - input).square() / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        t1 = label.clamp_min(1.0)
        stirling = label * torch.log(t1) - label + \
            0.5 * torch.log(2 * math.pi * t1)
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    c = input.shape[1]
    lbl = label.long()
    correct = input.gather(1, lbl.unsqueeze(1))
    diff = torch.pow(torch.clamp_min(margin - correct + input, 0.0), p)
    if weight is not None:
        diff = diff * weight[lbl].unsqueeze(1)
    mask = TF.one_hot(lbl, c) == 0
    return _reduce((diff * mask).sum(-1) / c, reduction)
