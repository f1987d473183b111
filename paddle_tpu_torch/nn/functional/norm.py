"""Normalization — port of ``paddle_tpu/nn/functional/norm.py``:
``layer_norm``, ``batch_norm``, ``instance_norm``, ``group_norm``,
``normalize``, ``local_response_norm``, ``rms_norm`` and
``spectral_norm``.

The JAX package's ``F.layer_norm`` is a jnp composition (XLA fuses it); its
Pallas LayerNorm kernel (``ops.fused_norm._ln_pallas``) is reached only
through ``fused_layer_norm``. Both compute one function, so the port sends
the form every transformer uses — one normalised axis, with a weight and a
bias — through ``ops.fused_layer_norm``: on a CUDA tensor every such
LayerNorm launches the hand-written kernel. The other forms (several
normalised axes, or no weight or no bias) take the plain composition
below, on any device.
"""
from __future__ import annotations

import torch

from ...ops.fused_norm import fused_layer_norm


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the last ``len(normalized_shape)`` axes: fp32 mean and
    variance about the mean, ``(x - mean) * rsqrt(var + epsilon)``, times
    ``weight`` and plus ``bias`` when given, cast to x's dtype."""
    ns = list(normalized_shape) if isinstance(normalized_shape,
                                              (list, tuple)) \
        else [normalized_shape]
    if len(ns) == 1 and weight is not None and bias is not None:
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - len(ns), x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape).float()
    if bias is not None:
        out = out + bias.reshape(shape).float()
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """BatchNorm over every axis but the channel one (axis 1 for an
    ``"NC…"`` format, the last otherwise), as the JAX package's:

    - statistics in fp32: the running ones where ``use_global_stats``
      (default: outside training), else the batch's mean and biased
      variance; the output computed in fp32 and cast to x's dtype (bf16
      activations under AMP keep fp32 statistics);
    - in training with batch statistics, the running ones updated IN PLACE
      (a CUDA graph replays the update): ``running = momentum · running +
      (1 - momentum) · batch``, the variance unbiased (n / (n - 1)).
      Paddle's ``momentum`` weighs the OLD statistic, PyTorch's the new
      one: the port passes ``1 - momentum``.

    It runs PyTorch's ``batch_norm`` (cuDNN's on the card) on an fp32
    running mean and variance, channel-first (a channel-last input is
    viewed so). PyTorch refuses batch statistics over one value a
    channel; there the JAX package's arithmetic runs instead
    (:func:`_one_value_batch_norm`)."""
    cl = not data_format.startswith("NC")
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    update = training and not use_stats
    if cl:
        x = x.movedim(-1, 1)
    if not use_stats and x.dim() > 1 and x.numel() == x.shape[1]:
        out = _one_value_batch_norm(x, running_mean, running_var, weight,
                                    bias, update, momentum, epsilon)
        return out.movedim(1, -1) if cl else out
    out = torch.nn.functional.batch_norm(
        x, running_mean if (use_stats or update) else None,
        running_var if (use_stats or update) else None, weight, bias,
        training=not use_stats, momentum=1.0 - momentum, eps=epsilon)
    return out.movedim(1, -1) if cl else out


def _one_value_batch_norm(x, running_mean, running_var, weight, bias,
                          update, momentum, epsilon):
    """Batch statistics over one value a channel (a channel-first ``x``
    of ``numel == C``), as the JAX package computes them: the mean is the
    value, the biased variance 0, so the output is ``bias`` (or 0); the
    running mean moves towards the value and the running variance by
    ``momentum`` alone (the unbiased factor ``n / max(n - 1, 1)`` is 1),
    in place (a CUDA graph replays the update)."""
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    xf = x.float()
    axes = [0] + list(range(2, x.dim()))
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = _affine((xf - mean) * torch.rsqrt(var + epsilon), weight, bias,
                  shape)
    if update:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                mean.reshape(-1).to(running_mean.dtype), alpha=1 - momentum)
            running_var.mul_(momentum).add_(
                var.reshape(-1).to(running_var.dtype), alpha=1 - momentum)
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Normalize each (N, C) plane over its spatial axes in fp32, then
    ``weight`` / ``bias``, as the JAX package's (which reads no running
    statistics and no ``data_format``: the input is channel-first)."""
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    return _affine(out, weight, bias, shape).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each of ``num_groups`` channel groups per sample over its
    channels and spatial axes in fp32, then ``weight`` / ``bias``."""
    cl = not data_format.startswith("NC")
    v = x.movedim(-1, 1) if cl else x
    n, c = v.shape[:2]
    g = v.reshape(n, num_groups, c // num_groups, *v.shape[2:]).float()
    axes = tuple(range(2, g.dim()))
    mean = g.mean(axes, keepdim=True)
    var = (g - mean).square().mean(axes, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape)
    out = _affine(out, weight, bias,
                  [1, c] + [1] * (v.dim() - 2)).to(x.dtype)
    return out.movedim(1, -1) if cl else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(‖x‖_p, epsilon)`` along ``axis``, in x's dtype."""
    norm = x.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha · mean of the squares over ``size`` neighbouring
    channels) ** beta``, the window centred (the odd element low), the
    squares summed in fp32, as the JAX package's."""
    ch = _channel_axis(x, data_format)
    sq = x.float().square().movedim(ch, 0)
    c, half = sq.shape[0], size // 2
    padded = torch.nn.functional.pad(
        sq.movedim(0, -1), (half, size - 1 - half)).movedim(-1, 0)
    acc = sum(padded[i:i + c] for i in range(size)).movedim(0, ch)
    return x / torch.pow(k + alpha * acc / size, beta).to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x / sqrt(mean(x², last axis) + eps) · weight`` in fp32, rounded
    to x's dtype: the JAX package's jnp composition (its Pallas RMSNorm,
    row 7, is reached through ``ops.fused_norm``, as the port's is)."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / σ`` with σ from ``power_iters`` power iterations that
    start at u = ones (the JAX package's functional form; no state)."""
    wm = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=torch.float32, device=weight.device)
    v = None
    for _ in range(power_iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wm @ v if v is not None else torch.linalg.matrix_norm(wm, 2)
    return weight / sigma
