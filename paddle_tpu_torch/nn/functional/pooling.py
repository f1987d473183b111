"""Pooling — port of ``paddle_tpu/nn/functional/pooling.py``:
``max_pool*`` (with ``return_mask``), ``avg_pool*``, ``adaptive_avg_pool*``,
``adaptive_max_pool*`` and ``max_unpool2d``.

The JAX package pools with ``lax.reduce_window`` over an explicitly padded
window grid (``_pool``); the port pads the same way and pools unpadded
(PyTorch's ``max_pool*d`` / ``avg_pool*d``, cuDNN-free kernels on the
card), so every rule of ``_pool`` holds as written there:

- padding: an int, a list of one int a spatial axis, a flat list of 2·n
  (low, high) ints, or ``"SAME"`` / ``"VALID"`` (XLA's rules) — and, as
  the convolutions take it, a list of n (low, high) pairs (the JAX
  package's pools refuse it); a list of another length (which the JAX
  package's pools cycle) raises NotImplementedError, for the kernel size
  and the stride too;
- ``ceil_mode`` (numeric padding only, as there) widens the high pad by
  ``stride - (size - k) % stride`` where that remainder is not 0 — so the
  last window may start in the padding, which PyTorch's own ``ceil_mode``
  never lets it;
- max pooling pads with -inf (the smallest integer for integer inputs);
- average pooling sums in fp32; ``exclusive=True`` (the default;
  PyTorch's ``count_include_pad=False``) divides by the window's count of
  input elements, ``exclusive=False`` by the whole window — and so does
  string padding, whatever ``exclusive`` says, as in the JAX package.

``return_mask`` gives the JAX package's ``_max_pool_indices_nd`` format:
int32 flat indices into each (n, c) plane of the unpadded input, the
first maximum of each window. Adaptive pools use the bins
[floor(i·in/o), ceil((i+1)·in/o)) (PyTorch's too); an adaptive average
whose output is 1 along every pooled axis is a mean over them (PyTorch's
CUDA adaptive-average backward accumulates with atomics). An adaptive
max pool's mask and ``divisor_override`` are not ported
(NotImplementedError: the JAX package returns None and ignores the
override).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ...framework import dispatch

from ._spatial import (is_channel_last, pad_spec, same_pads, to_channel_first,
                       to_channel_last, tup)

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
           "max_pool3d", "max_unpool2d"]

_FORMATS = {1: ("NCL",), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _window_pads(spatial, k, s, padding, n, ceil_mode):
    """Each spatial axis's (low, high) pad, as ``_pool`` builds its
    ``reduce_window`` padding; and whether the padding was a string."""
    p = pad_spec(padding, n)
    if p == "VALID":
        return [(0, 0)] * n, True
    if p == "SAME":
        return same_pads(spatial, k, s), True
    if ceil_mode:
        for i in range(n):
            size = spatial[i] + p[i][0] + p[i][1]
            rem = (size - k[i]) % s[i]
            if rem:
                p[i] = (p[i][0], p[i][1] + s[i] - rem)
    return p, False


def _pad(x, pads, value):
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _channel_first(x, n, data_format):
    if is_channel_last(f"pool{n}d", data_format, _FORMATS[n]):
        return to_channel_first(x, n), True
    return x, False


def _back(x, n, channel_last):
    return to_channel_last(x, n) if channel_last else x


def _low_value(x):
    return -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min


def _max_pool(x, kernel_size, stride, padding, n, ceil_mode, data_format,
              return_mask):
    x, cl = _channel_first(x, n, data_format)
    k = tup(kernel_size, n)
    s = tup(stride, n) if stride is not None else k
    pads, _ = _window_pads(x.shape[2:], k, s, padding, n, ceil_mode)
    pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1]
    # the -inf padding is not finite by design: FLAGS_check_nan_inf scans
    # the pooled result, as the JAX package scans its one pooling op
    with dispatch.scan_paused():
        out = pool(_pad(x, pads, _low_value(x)), k, s)
    out = _back(dispatch.scan(f"max_pool{n}d", out), n, cl)
    if not return_mask:
        return out
    with dispatch.scan_paused():
        mask = _max_indices(x, k, s, pads, n)
    return out, _back(mask, n, cl)


def _max_indices(x, k, s, pads, n):
    """The JAX package's ``_max_pool_indices_nd``: the flat index, in the
    unpadded (n, c) plane, of each window's first maximum (int32)."""
    spatial = tuple(x.shape[2:])
    pos = torch.arange(math.prod(spatial), dtype=torch.int32,
                       device=x.device).reshape((1, 1) + spatial)
    vp = _pad(x.detach(), pads, _low_value(x))
    pp = _pad(pos, pads, -1)
    for i in range(n):
        vp = vp.unfold(2 + i, k[i], s[i])
        pp = pp.unfold(2 + i, k[i], s[i])
    vp = vp.flatten(-n)
    pp = pp.flatten(-n).expand(vp.shape)
    am = vp.argmax(-1, keepdim=True)
    return torch.gather(pp, -1, am).squeeze(-1)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, ceil_mode, "NCL",
                     return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     data_format, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     data_format, return_mask)


def _avg_pool(x, kernel_size, stride, padding, n, ceil_mode, exclusive,
              data_format, divisor_override):
    if divisor_override is not None:
        raise NotImplementedError("avg_pool divisor_override is not ported "
                                  "(the JAX package ignores it)")
    x, cl = _channel_first(x, n, data_format)
    k = tup(kernel_size, n)
    s = tup(stride, n) if stride is not None else k
    pads, string_pad = _window_pads(x.shape[2:], k, s, padding, n,
                                    ceil_mode)
    # the window sums in fp32, through a pool over a 2-D or 3-D view
    # (avg_pool1d has no divisor_override)
    pool = F.avg_pool3d if n == 3 else F.avg_pool2d
    lift = (lambda t: t.unsqueeze(-1)) if n == 1 else (lambda t: t)
    kk, ss = (k + (1,), s + (1,)) if n == 1 else (k, s)
    summed = pool(lift(_pad(x.float(), pads, 0.0)), kk, ss,
                  divisor_override=1)
    if not exclusive or string_pad:
        out = summed / float(math.prod(k))
    else:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32,
                          device=x.device)
        counts = pool(lift(_pad(ones, pads, 0.0)), kk, ss,
                      divisor_override=1)
        out = summed / counts
    if n == 1:
        out = out.squeeze(-1)
    return _back(out.to(x.dtype), n, cl)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, "NCL", None)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, data_format, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, data_format, divisor_override)


def _adaptive(x, output_size, n, data_format, mode):
    x, cl = _channel_first(x, n, data_format)
    sizes = output_size if isinstance(output_size, (list, tuple)) \
        else [output_size] * n
    sizes = [x.shape[2 + i] if o is None else int(o)
             for i, o in enumerate(sizes)]
    if mode == "avg":
        xf = x.float()
        if all(o == 1 for o in sizes):
            out = xf.mean(tuple(range(2, 2 + n)), keepdim=True)
        else:
            pool = (F.adaptive_avg_pool1d, F.adaptive_avg_pool2d,
                    F.adaptive_avg_pool3d)[n - 1]
            out = pool(xf, sizes)
        out = out.to(x.dtype)
    else:
        pool = (F.adaptive_max_pool1d, F.adaptive_max_pool2d,
                F.adaptive_max_pool3d)[n - 1]
        out = pool(x, sizes)
    return _back(out, n, cl)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg")


def _no_adaptive_mask(return_mask):
    if return_mask:
        raise NotImplementedError("adaptive_max_pool return_mask is not "
                                  "ported (the JAX package returns None)")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_adaptive_mask(return_mask)
    return _adaptive(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_adaptive_mask(return_mask)
    return _adaptive(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_adaptive_mask(return_mask)
    return _adaptive(x, output_size, 3, "NCDHW", "max")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter each value of ``x`` to its ``indices`` (a ``return_mask``)
    in a zero (n, c, oh, ow) output: ``output_size``'s last two, else
    (h - 1)·stride + k (the padding is not subtracted, as in the JAX
    package)."""
    if data_format != "NCHW":
        raise NotImplementedError("max_unpool2d takes NCHW only")
    k = tup(kernel_size, 2)
    s = tup(stride, 2) if stride is not None else k
    n, c, h, w = x.shape
    if output_size is not None:
        oh, ow = int(output_size[-2]), int(output_size[-1])
    else:
        oh, ow = (h - 1) * s[0] + k[0], (w - 1) * s[1] + k[1]
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(n, c, -1).long(),
                        x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)
