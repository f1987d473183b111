"""The OCR pair of BASELINE config 5 (PP-OCRv4 det + rec) — port of
``paddle_tpu/vision/models/ocr.py``, with its submodule names (their
state dicts load name for name through ``models/convert.
layer_params_from_jax``):

- ``DBNet``: the Differentiable-Binarization detector — a 4-stage
  strided conv backbone, an FPN neck (nearest top-down adds, each level
  reduced and upsampled to 1/4 and concatenated) and two heads; in
  training ``maps`` holds the probability, threshold and binary maps
  ``1 / (1 + exp(-k (P - T)))``, in eval the probability map alone.
- ``CRNN``: the recognizer — a VGG-style conv tower pooling the height
  to 1, a 2-layer bidirectional LSTM over the width (``nn.LSTM``: a loop
  over the steps that a CUDA graph captures), the CTC projection
  (classes + 1, blank 0).

``db_loss`` and ``crnn_ctc_loss`` (over ``F.ctc_loss``, the port's own
loop: no host read) are their losses. Each constructor takes ``device``
(``place``; None: the card), ``dtype`` and ``generator``."""
from __future__ import annotations

import torch

from ...nn import (Conv2D, Layer, LayerList, Linear, MaxPool2D, ReLU,
                   Sequential)
from ...nn import functional as F
from ...nn.layer.rnn import LSTM
from ._common import bn, layer_kw

__all__ = ["DBNet", "CRNN", "db_loss", "crnn_ctc_loss", "dbnet", "crnn"]


def _conv_bn(cin, cout, kw, k=3, stride=1, padding=1):
    return Sequential(
        Conv2D(cin, cout, k, stride=stride, padding=padding,
               bias_attr=False, **kw),
        bn(cout, kw), ReLU())


class _Backbone(Layer):
    """4 strided stages; the features at strides 4, 8, 16 and 32."""

    def __init__(self, in_channels=3, base=16, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        c = base
        self.stem = Sequential(_conv_bn(in_channels, c, kw, stride=2),
                               _conv_bn(c, c, kw))
        self.stages = LayerList([
            Sequential(_conv_bn(c, 2 * c, kw, stride=2),
                       _conv_bn(2 * c, 2 * c, kw)),
            Sequential(_conv_bn(2 * c, 4 * c, kw, stride=2),
                       _conv_bn(4 * c, 4 * c, kw)),
            Sequential(_conv_bn(4 * c, 8 * c, kw, stride=2),
                       _conv_bn(8 * c, 8 * c, kw)),
            Sequential(_conv_bn(8 * c, 16 * c, kw, stride=2),
                       _conv_bn(16 * c, 16 * c, kw)),
        ])
        self.out_channels = [2 * c, 4 * c, 8 * c, 16 * c]

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


class _FPN(Layer):
    def __init__(self, in_channels, out_channels=96, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.laterals = LayerList([Conv2D(c, out_channels, 1,
                                          bias_attr=False, **kw)
                                   for c in in_channels])
        quarter = out_channels // 4
        self.smooth = LayerList([Conv2D(out_channels, quarter, 3, padding=1,
                                        bias_attr=False, **kw)
                                 for _ in in_channels])
        self.out_channels = quarter * 4

    def forward(self, feats):
        lat = [lay(f) for lay, f in zip(self.laterals, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1],
                                            size=lat[i].shape[2:],
                                            mode="nearest")
        tgt = tuple(lat[0].shape[2:])
        outs = []
        for s, f in zip(self.smooth, lat):
            f = s(f)
            if tuple(f.shape[2:]) != tgt:
                f = F.interpolate(f, size=tgt, mode="nearest")
            outs.append(f)
        return torch.cat(outs, 1)


class _DBHead(Layer):
    """Conv → nearest ×4 → a 1-channel sigmoid map."""

    def __init__(self, in_channels, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        mid = in_channels // 4
        self.conv1 = _conv_bn(in_channels, mid, kw)
        self.conv2 = Conv2D(mid, 1, 1, **kw)

    def forward(self, x):
        x = F.interpolate(self.conv1(x), scale_factor=4, mode="nearest")
        return F.sigmoid(self.conv2(x))


class DBNet(Layer):
    """forward → {"maps": (B, 3, H, W)} (probability, threshold, binary)
    in training, {"maps": (B, 1, H, W)} (probability) in eval."""

    def __init__(self, in_channels=3, base_channels=16, k=50.0, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.backbone = _Backbone(in_channels, base_channels, **kw)
        self.neck = _FPN(self.backbone.out_channels, **kw)
        self.prob_head = _DBHead(self.neck.out_channels, **kw)
        self.thresh_head = _DBHead(self.neck.out_channels, **kw)
        self.k = k

    def forward(self, x):
        feat = self.neck(self.backbone(x))
        prob = self.prob_head(feat)
        if not self.training:
            return {"maps": prob}
        thresh = self.thresh_head(feat)
        binary = 1.0 / (1.0 + torch.exp(-self.k * (prob - thresh)))
        return {"maps": torch.cat([prob, thresh, binary], 1)}


def db_loss(maps, shrink_map, shrink_mask, thresh_map=None,
            thresh_mask=None, alpha=5.0, beta=10.0, eps=1e-6):
    """``alpha`` · the masked BCE of the probability map + the dice loss
    of the binary map (+ ``beta`` · the masked L1 of the threshold map
    when its target is given)."""
    prob, thresh, binary = maps[:, 0], maps[:, 1], maps[:, 2]
    smf = shrink_map.float()
    w = shrink_mask.float()
    p = prob.clamp(eps, 1 - eps)
    bce = -(smf * torch.log(p) + (1 - smf) * torch.log(1 - p))
    bce = (bce * w).sum() / w.sum().clamp_min(1.0)
    inter = (binary * smf * w).sum()
    union = (binary * w).sum() + (smf * w).sum() + eps
    loss = alpha * bce + (1.0 - 2.0 * inter / union)
    if thresh_map is not None:
        tw = thresh_mask.float()
        l1 = ((thresh - thresh_map).abs() * tw).sum() / tw.sum().clamp_min(
            1.0)
        loss = loss + beta * l1
    return loss


class CRNN(Layer):
    """Conv tower → BiLSTM → CTC logits (B, T, num_classes + 1), T the
    input width / 4; blank 0."""

    def __init__(self, num_classes, in_channels=3, hidden_size=96, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.features = Sequential(
            _conv_bn(in_channels, 32, kw), MaxPool2D(2, 2),       # H/2, W/2
            _conv_bn(32, 64, kw), MaxPool2D(2, 2),                # H/4, W/4
            _conv_bn(64, 128, kw), _conv_bn(128, 128, kw),
            MaxPool2D((2, 1), (2, 1)),                            # H/8, W/4
            _conv_bn(128, 256, kw),
            MaxPool2D((2, 1), (2, 1)),                            # H/16
            _conv_bn(256, 256, kw, k=2, padding=0),               # → 1
        )
        self.encoder = LSTM(256, hidden_size, num_layers=2,
                            direction="bidirect", **kw)
        self.head = Linear(2 * hidden_size, num_classes + 1, **kw)
        self.num_classes = num_classes

    def forward(self, x):
        f = self.features(x)                                  # (B, C, 1, W')
        seq = f.reshape(f.shape[0], f.shape[1], -1).transpose(1, 2)
        enc, _ = self.encoder(seq)
        return self.head(enc)


def crnn_ctc_loss(logits, labels, label_lengths, blank=0):
    """CTC over CRNN logits (B, T, C), every step an input frame."""
    B, T = logits.shape[:2]
    lengths = torch.full((B,), T, dtype=torch.int32, device=logits.device)
    return F.ctc_loss(logits.transpose(0, 1), labels, lengths,
                      label_lengths, blank=blank)


def dbnet(**kwargs) -> DBNet:
    return DBNet(**kwargs)


def crnn(num_classes=36, **kwargs) -> CRNN:
    return CRNN(num_classes, **kwargs)
