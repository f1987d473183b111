"""Common functional ops — port of ``paddle_tpu/nn/functional/common.py``:
``linear``, the dropouts, ``pad`` / ``zeropad2d``, ``interpolate`` /
``upsample``, the pixel and channel shuffles, ``unfold`` / ``fold``,
``cosine_similarity``, ``bilinear``, ``embedding``, ``one_hot``,
``label_smooth``, ``sequence_mask`` and ``temporal_shift``.

``interpolate`` keeps the JAX package's rule, which is ``jax.image.
resize``'s, not Paddle's: ``"nearest"`` samples at half-pixel centres
(``floor((i + 0.5) · in / out)``, Paddle's floor only at whole upscale
factors); ``"linear"`` / ``"bilinear"`` / ``"trilinear"`` / ``"area"``
are the triangle kernel and ``"bicubic"`` Keys' cubic (a = -0.5), both
antialiased when they shrink (``"area"`` is linear, not adaptive
average pooling); ``align_corners=True`` takes the JAX package's own
two-point lerp in every mode but nearest. The random ops draw from
``generator`` (a ``torch.Generator`` on x's device; None takes its
default one): never the same mask as ``jax.random``'s from one seed."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import cast_inputs

_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` stored (in, out), Paddle's
    layout (under ``amp.auto_cast``: the ``linear`` rule)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def _keep_mask(x, p, axis, generator):
    """A keep mask (kept with probability 1 - p) of x's shape, or shared
    along the axes ``axis`` leaves out (size 1 there)."""
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        keep_axes = [a % x.dim() for a in axes]
        shape = [s if i in keep_axes else 1 for i, s in enumerate(shape)]
    return torch.rand(shape, generator=generator, device=x.device) >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each element (or each slice along the axes ``axis`` keeps)
    with probability ``p`` in training; ``"upscale_in_train"`` scales the
    kept ones by 1/(1 - p), ``"downscale_in_infer"`` keeps them as they
    are. Outside training, or at p = 0, x is returned unchanged in both
    modes, as the JAX package's ``dropout`` does."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x, p, axis, generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels dropped: one draw an (N, C) pair."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=ax, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=ax, training=training, generator=generator)


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: a dropped element takes -alpha·scale, then
    ``a · v + b`` keeps the mean and variance (the JAX package's a and
    b)."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep_mask(x, p, None, generator)
    a = ((1.0 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                                device=x.device))
            + b).to(x.dtype)


def _take(x, d, idx):
    """x at the indices ``idx`` along axis d. Indexing's backward sums
    repeated indices in a fixed order (``index_put_`` with accumulate;
    ``index_select``'s adds them with atomics on the card)."""
    return x[(slice(None),) * d + (idx,)]


def _pad_index(n, lo, hi, mode, device):
    """Source indices of an axis of ``n`` padded by (lo, hi) under
    numpy's ``reflect`` / ``edge`` / ``wrap`` rules."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return j.clamp(0, n - 1)
    if mode == "wrap":
        return j.remainder(n)
    if n == 1:
        return torch.zeros_like(j)
    m = j.remainder(2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad x: ``pad`` of 2·ndim ints gives each axis's (low, high) in
    axis order; a shorter one pads the spatial axes of ``data_format``
    from the last one back (``[left, right, top, bottom]`` for NCHW).
    Modes ``"constant"`` (``value``), ``"reflect"``, ``"replicate"``,
    ``"circular"``, as numpy's ``constant`` / ``reflect`` / ``edge`` /
    ``wrap``."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C") or data_format in _CHANNEL_LAST:
            spatial = list(range(1, 1 + n_spatial))
        else:
            spatial = list(range(nd - n_spatial, nd))
        for i, dim in enumerate(reversed(spatial)):
            widths[dim] = (pad[2 * i], pad[2 * i + 1])
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return TF.pad(x, flat, mode="constant", value=value)
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = _take(x, d, _pad_index(x.shape[d], lo, hi, jmode, x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _nearest_axis(x, d, n_out):
    """``jax.image.resize``'s nearest along axis d: source index
    ``floor((i + 0.5) · in / out)`` in fp32. A whole upscale factor
    repeats each element (its backward a sum over the copies), a whole
    downscale factor is a strided slice, any other ratio a gather."""
    n_in = x.shape[d]
    if n_out % n_in == 0:
        r = n_out // n_in
        shape = list(x.shape)
        y = x.unsqueeze(d + 1).expand(*shape[:d + 1], r, *shape[d + 1:])
        return y.reshape(*shape[:d], n_out, *shape[d + 1:])
    if n_in % n_out == 0:
        r = n_in // n_out
        idx = [slice(None)] * x.dim()
        idx[d] = slice(r // 2, None, r)
        return x[tuple(idx)]
    src = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                    device=x.device) + 0.5) * n_in / n_out)
    return _take(x, d, src.long())


def _aa_axis(x, d, n_out, mode):
    """Antialiased linear / cubic resize of axis d through a 4-D view
    (PyTorch antialiases 4-D inputs only): the axis as the view's last,
    every other axis folded into its channels (its height 1: PyTorch's
    antialiased kernels mis-resize a view whose last axis is 1)."""
    y = x.movedim(d, -1)
    shape = list(y.shape)
    v = y.reshape(1, -1, 1, shape[-1])
    out = TF.interpolate(v, size=(1, n_out), mode=mode, align_corners=False,
                         antialias=True)
    return out.reshape(*shape[:-1], n_out).movedim(-1, d)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of a 3-, 4- or 5-D x to ``size`` (or
    ``int(in · scale_factor)``) under the JAX package's rule (module
    docstring). An axis whose size does not change is left as it is."""
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    if isinstance(scale_factor, torch.Tensor):
        scale_factor = scale_factor.tolist()
    channel_last = data_format in _CHANNEL_LAST
    nd = x.dim()
    n_spatial = nd - 2
    spatial = list(range(1, 1 + n_spatial)) if channel_last else \
        list(range(2, nd))
    in_sizes = [x.shape[d] for d in spatial]
    if size is not None:
        out_sizes = [int(s) for s in (size if isinstance(size, (list, tuple))
                                      else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * n_spatial
        out_sizes = [int(i * s) for i, s in zip(in_sizes, sf)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    todo = [(d, o) for d, i, o in zip(spatial, in_sizes, out_sizes)
            if i != o]
    if method == "nearest":
        for d, o in todo:
            x = _nearest_axis(x, d, o)
        return x
    dtype = x.dtype
    if align_corners:
        out = x
        for d, s_out in todo:
            s_in = out.shape[d]
            if s_out == 1 or s_in == 1:
                idx = torch.zeros(s_out, dtype=torch.float64, device=x.device)
            else:
                idx = torch.linspace(0.0, s_in - 1.0, s_out,
                                     dtype=torch.float64, device=x.device)
            lo = torch.floor(idx).long()
            hi = (lo + 1).clamp(0, s_in - 1)
            bshape = [1] * out.dim()
            bshape[d] = s_out
            w = (idx - lo).to(dtype).reshape(bshape)
            out = _take(out, d, lo) * (1 - w) + _take(out, d, hi) * w
        return out.to(dtype)
    tmode = "bilinear" if method == "linear" else "bicubic"
    if nd == 4 and todo:
        if channel_last:
            x = x.permute(0, 3, 1, 2)
        y = TF.interpolate(x, size=tuple(out_sizes), mode=tmode,
                           align_corners=False, antialias=True)
        return (y.permute(0, 2, 3, 1) if channel_last else y).to(dtype)
    for d, o in todo:
        x = _aa_axis(x, d, o, tmode)
    return x.to(dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    v = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, groups, c // groups, h, w).permute(0, 2, 1, 3, 4)
        return v.reshape(n, c, h, w)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, groups, c // groups).permute(0, 1, 2, 4, 3)
    return v.reshape(n, h, w, c)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C, H, W) → (N, C·kh·kw, L). ``paddings`` of 2 ints is
    (H, W) symmetric, of 4 ints [top, left, bottom, right]."""
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    n, c = x.shape[:2]
    v = TF.pad(x, [pd[1], pd[3], pd[0], pd[2]])
    out_h = (v.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    out_w = (v.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = [v[:, :, i * dl[0]: i * dl[0] + out_h * st[0]: st[0],
                 j * dl[1]: j * dl[1] + out_w * st[1]: st[1]]
               for i in range(ks[0]) for j in range(ks[1])]
    return torch.stack(patches, 2).reshape(n, c * ks[0] * ks[1],
                                           out_h * out_w)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, ``unfold``'s adjoint: overlapping patches summed."""
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, pd, dl = _pair(strides), _pair(paddings), _pair(dilations)
    n, ckk, _ = x.shape
    c = ckk // (ks[0] * ks[1])
    out_h = os_[0] + 2 * pd[0]
    out_w = os_[1] + 2 * pd[1]
    n_h = (out_h - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    n_w = (out_w - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    v = x.reshape(n, c, ks[0], ks[1], n_h, n_w)
    out = x.new_zeros((n, c, out_h, out_w))
    for i in range(ks[0]):
        for j in range(ks[1]):
            out[:, :, i * dl[0]: i * dl[0] + n_h * st[0]: st[0],
                j * dl[1]: j * dl[1] + n_w * st[1]: st[1]] += v[:, :, i, j]
    return out[:, :, pd[0]: out_h - pd[0], pd[1]: out_w - pd[1]]


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(axis)
    na = (x1 * x1).sum(axis).sqrt()
    nb = (x2 * x2).sum(axis).sqrt()
    return dot / torch.clamp_min(na * nb, eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · weight[o] · x2[b] (+ bias[o])``, weight (out,
    in1, in2)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the indices x; an index equal to a
    non-negative ``padding_idx`` gives zeros (no gradient to that row)."""
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows (the JAX package's dtype)."""
    return TF.one_hot(x.long(), num_classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths (…) → mask (…, maxlen): position j set where j < length.
    Without ``maxlen`` the width is the largest length, read on the host
    (as in the JAX package: the output's shape depends on the data)."""
    from ...framework.dtype import convert_dtype

    m = maxlen if maxlen is not None else int(x.max())
    rng = torch.arange(m, device=x.device)
    return (rng < x.unsqueeze(-1)).to(convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Shift the first ``shift_ratio`` of the channels one segment back in
    time and the next as many one segment forward (zeros enter)."""
    nt, c, h, w = x.shape
    n = nt // seg_num
    v5 = x.reshape(n, seg_num, c, h, w)
    f = int(c * shift_ratio)
    left = torch.cat([v5[:, 1:, :f], torch.zeros_like(v5[:, :1, :f])], 1)
    right = torch.cat([torch.zeros_like(v5[:, :1, f:2 * f]),
                       v5[:, :-1, f:2 * f]], 1)
    rest = v5[:, :, 2 * f:]
    return torch.cat([left, right, rest], 2).reshape(nt, c, h, w)
