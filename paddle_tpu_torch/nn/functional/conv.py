"""Convolutions — port of ``paddle_tpu/nn/functional/conv.py``:
``conv1d`` / ``conv2d`` / ``conv3d`` and their ``_transpose`` forms.

The JAX package lowers every convolution to ``lax.conv_general_dilated``,
outside any Pallas kernel; the port runs PyTorch's ``conv*d`` /
``conv_transpose*d`` (cuDNN on the card), as a plain matrix product stays
``torch.matmul``. Weights keep Paddle's layout: (out, in / groups, *k),
and (in, out / groups, *k) for a transposed convolution, which are
PyTorch's layouts too.

Padding takes every form the JAX package's ``_pad_spec`` takes: an int or
a one-element list (every side), a list of one int a spatial axis
(symmetric), a flat list of 2·n ints (low and high of each axis in turn),
a list of n ``(low, high)`` pairs, and ``"SAME"`` / ``"VALID"`` (XLA's
rules: ``"SAME"`` gives ceil(in / stride) outputs and puts the odd pad on
the high side, which PyTorch's ``padding="same"`` refuses at stride > 1).
Uneven padding is applied with ``F.pad`` before a convolution with none.
``data_format`` is channel-first (``"NCL"`` / ``"NCHW"`` / ``"NCDHW"``) or
channel-last (``"NLC"`` / ``"NHWC"`` / ``"NDHWC"``: the input is permuted
to channel-first — a channels-last view cuDNN reads as it lies — and the
output back). A transposed convolution takes numeric padding only (the
JAX package refuses strings too) and no ``output_size`` (the JAX package
accepts and ignores it; the port raises NotImplementedError).

Under ``amp.auto_cast`` the floating inputs are cast by the ``conv1d`` /
``conv2d`` / ``conv3d`` rule (the white list), as ``linear``'s. The bias is
added after the convolution in the output's dtype, as the JAX package
adds it.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...amp import cast_inputs
from ._spatial import (is_channel_last, pad_spec, same_pads, to_channel_first,
                       to_channel_last, tup)

__all__ = ["conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose"]

_FORMATS = {1: ("NCL", "NCW", "NLC"), 2: ("NCHW", "NHWC"),
            3: ("NCDHW", "NDHWC")}


def _with_bias(out, bias):
    if bias is None:
        return out
    return out + bias.reshape([1, -1] + [1] * (out.dim() - 2))


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    channel_last = is_channel_last(f"conv{n}d", data_format, _FORMATS[n])
    x, weight, bias = cast_inputs(f"conv{n}d", x, weight, bias)
    stride, dilation = tup(stride, n), tup(dilation, n)
    if channel_last:
        x = to_channel_first(x, n)
    pads = pad_spec(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        # F.pad's list runs from the last axis back
        x = F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        sym = (0,) * n
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    out = _with_bias(conv(x, weight, None, stride, sym, dilation, groups),
                     bias)
    return to_channel_last(out, n) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size):
    """The JAX package's transposed convolution: output size (in - 1) ·
    stride + dilation · (k - 1) + 1 - low - high + output_padding a
    spatial axis. PyTorch's runs unpadded and the result is cropped by
    (low, high - output_padding) — padded with zeros where that is
    negative."""
    channel_last = is_channel_last(f"conv{n}d_transpose", data_format,
                                   _FORMATS[n])
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    if output_size is not None:
        raise NotImplementedError(
            "conv_transpose output_size is not ported (the JAX package "
            "ignores it)")
    stride, dilation = tup(stride, n), tup(dilation, n)
    opad = tup(output_padding, n) if output_padding is not None \
        else (0,) * n
    pads = pad_spec(padding, n)
    if channel_last:
        x = to_channel_first(x, n)
    conv_t = (F.conv_transpose1d, F.conv_transpose2d,
              F.conv_transpose3d)[n - 1]
    out = conv_t(x, weight, None, stride, 0, 0, groups, dilation)
    grow = [v for i in reversed(range(n))
            for v in (0, max(0, opad[i] - pads[i][1]))]
    if any(grow):
        out = F.pad(out, grow)
    index = [slice(None), slice(None)]
    for i in range(n):
        lo, hi = pads[i]
        size = ((x.shape[2 + i] - 1) * stride[i]
                + dilation[i] * (weight.shape[2 + i] - 1) + 1 - lo - hi
                + opad[i])
        index.append(slice(lo, lo + size))
    out = _with_bias(out[tuple(index)], bias)
    return to_channel_last(out, n) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
