"""Metrics — port of ``paddle_tpu/metric/__init__.py`` (``paddle.metric``).

As in the JAX package, the metrics count on the host in numpy: each
reads its inputs back (``.detach().cpu()``; bf16 widened to fp32, which
keeps every value and so every order), and :meth:`Accuracy.compute`
ranks with numpy's ``argsort``, so that ties fall as they fall there.
:meth:`Accuracy.compute` returns its (N, maxk) flags as a CPU tensor;
:func:`accuracy` returns an fp32 tensor on its input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor._util import host_numpy

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = host_numpy(pred)
        label_np = host_numpy(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = np.argmax(label_np, axis=-1)
        correct = (idx == label_np[..., None]).astype(np.float32)
        return torch.from_numpy(correct)

    def update(self, correct, *args):
        c = host_numpy(correct)
        num_samples = c.shape[0]
        accs = []
        for k in self.topk:
            num_corrects = c[..., :k].sum()
            accs.append(float(num_corrects) / num_samples)
            self.total[self.topk.index(k)] += num_corrects
            self.count[self.topk.index(k)] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (host_numpy(preds) > 0.5).astype(int).reshape(-1)
        l = host_numpy(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (host_numpy(preds) > 0.5).astype(int).reshape(-1)
        l = host_numpy(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = host_numpy(preds)
        l = host_numpy(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        else:
            p = p.reshape(-1)
        bins = np.clip((p * self._num_thresholds).astype(int), 0,
                       self._num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1)
        self._stat_neg = np.zeros(self._num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate over thresholds descending
        pos = self._stat_pos[::-1].cumsum()
        neg = self._stat_neg[::-1].cumsum()
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of ``input`` (N, C) against ``label`` as an fp32
    0-d tensor on ``input``'s device (ranked on the host, as
    :class:`Accuracy`)."""
    p = host_numpy(input)
    l = host_numpy(label).reshape(-1)
    idx = np.argsort(-p, axis=-1)[:, :k]
    correct_n = (idx == l[:, None]).any(axis=1).sum()
    device = input.device if isinstance(input, torch.Tensor) else "cpu"
    return torch.tensor(correct_n / p.shape[0], dtype=torch.float32,
                        device=device)
