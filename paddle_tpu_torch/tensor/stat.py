"""Statistics — port of ``paddle_tpu/tensor/stat.py``.

As the JAX package's: ``var`` / ``std`` divide by ``n - 1`` when
``unbiased``; ``median`` averages the two middle values of an even count
(``mode="min"`` takes the lower one); ``nanmedian`` averages the middles
of the values that are not NaN (torch's takes the lower); ``quantile``
computes in fp32 with numpy's interpolation names; ``histogram`` bins as
``np.histogram`` does (float64 edges over the data's range when ``min``
and ``max`` are both 0; int64 counts, floating with ``weight`` or
``density``), on the input's device; ``bincount`` counts in int64.
"""
from __future__ import annotations

import torch

from ..framework.dispatch import apply_op
from ._util import all_dims, axis_arg, to_inexact
from .linalg import corrcoef  # noqa: F401
from .math import mean  # noqa: F401


def _var(v, axis, unbiased, keepdim):
    return torch.var(to_inexact(v), dim=all_dims(v, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(lambda v: _var(v, axis, unbiased, keepdim), x,
                    op_name="var")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(lambda v: torch.sqrt(_var(v, axis, unbiased, keepdim)),
                    x, op_name="std")


def _middles(s, n, ax):
    """The lower and upper middle of the first ``n`` sorted values along
    ``ax`` (``n`` a tensor, broadcast over the other axes)."""
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(n, 2, rounding_mode="floor").clamp(max=s.shape[ax] - 1)
    return (torch.take_along_dim(s, lo, ax), torch.take_along_dim(s, hi, ax))


def _median(v, axis, keepdim, avg, skip_nan):
    ax = axis_arg(axis)
    if ax is None:
        w = v.reshape(-1)
        dim = 0
    else:
        w, dim = v, ax
    s = torch.sort(w, dim=dim).values            # NaNs last
    shape = list(s.shape)
    shape[dim] = 1
    if skip_nan:
        n = (~torch.isnan(w)).sum(dim, keepdim=True)
    else:
        n = torch.full(shape, w.shape[dim], dtype=torch.long,
                       device=w.device)
    lo, hi = _middles(s, n, dim)
    out = (lo + hi) / 2 if avg else lo
    if skip_nan:
        out = torch.where(n > 0, out, torch.full_like(out, float("nan")))
    elif avg and w.is_floating_point():
        # a NaN anywhere makes the median NaN, as jnp's
        out = torch.where(torch.isnan(w).any(dim, keepdim=True),
                          torch.full_like(out, float("nan")), out)
    if ax is None:
        return out.reshape([1] * v.dim() if keepdim else [])
    return out if keepdim else out.squeeze(dim)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return apply_op(lambda v: _median(to_inexact(v) if mode == "avg" else v,
                                      axis, keepdim, mode == "avg", False),
                    x, op_name="median")


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return apply_op(lambda v: _median(to_inexact(v), axis, keepdim, True,
                                      True), x, op_name="nanmedian")


def _quantile(fn, v, q, axis, keepdim, interpolation):
    v = v.float()
    qv = q.to(v.device, torch.float32) if isinstance(q, torch.Tensor) \
        else torch.tensor(q, dtype=torch.float32, device=v.device)
    ax = axis_arg(axis)
    if isinstance(ax, tuple):                  # several axes: move them last
        rest = [d for d in range(v.dim()) if d not in
                {a % v.dim() for a in ax}]
        w = v.permute(rest + sorted(a % v.dim() for a in ax)).reshape(
            [v.shape[d] for d in rest] + [-1])
        out = fn(w, qv, dim=-1, interpolation=interpolation)
        if keepdim:
            axes = {a % v.dim() for a in ax}
            out = out.reshape(list(qv.shape) + [
                1 if d in axes else v.shape[d] for d in range(v.dim())])
        return out
    return fn(v, qv, dim=ax, keepdim=keepdim, interpolation=interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return apply_op(lambda v: _quantile(torch.quantile, v, q, axis, keepdim,
                                        interpolation), x, op_name="quantile")


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return apply_op(lambda v: _quantile(torch.nanquantile, v, q, axis,
                                        keepdim, interpolation), x,
                    op_name="nanquantile")


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def _bin_index(v, lo, hi, bins):
    """``np.histogram``'s bin of each value of ``v`` (float64) inside
    ``[lo, hi]``, the last bin closed; -1 outside."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                           device=v.device)
    idx = ((v - lo) * (bins / (hi - lo))).floor().long()
    idx = torch.where(idx == bins, idx - 1, idx).clamp(0, bins - 1)
    idx = torch.where(v < edges[idx], idx - 1, idx)
    idx = torch.where((v >= edges[(idx + 1).clamp(max=bins)])
                      & (idx != bins - 1), idx + 1, idx)
    return torch.where((v >= lo) & (v <= hi), idx, torch.full_like(idx, -1))


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    v = input.detach().reshape(-1).double()
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = (float(v.min()), float(v.max())) if v.numel() else (0., 1.)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    idx = _bin_index(v, lo, hi, bins)
    keep = idx >= 0
    w = None if weight is None else weight.reshape(-1).double()[keep]
    counts = torch.bincount(idx[keep], weights=w, minlength=bins)
    if density:
        width = (hi - lo) / bins
        return counts.double() / (counts.sum() * width)
    return counts if weight is not None else counts.long()


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``np.histogramdd`` on the host, the results on ``x``'s device."""
    import numpy as np

    v = x.detach().cpu().double().numpy()
    w = None if weights is None else weights.detach().cpu().double().numpy()
    h, edges = np.histogramdd(v, bins=bins, range=ranges, density=density,
                              weights=w)
    return (torch.from_numpy(h).to(x.device),
            [torch.from_numpy(e).to(x.device) for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    if weights is None:
        return apply_op(lambda v: torch.bincount(v.long(),
                                                 minlength=minlength).long(),
                        x, op_name="bincount")
    return apply_op(lambda v, w: torch.bincount(
        v.long(), weights=w, minlength=minlength).to(w.dtype), x, weights,
        op_name="bincount")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op(lambda v: torch.cov(
        v if rowvar else v.mT, correction=1 if ddof else 0,
        fweights=fweights, aweights=aweights), x, op_name="cov")
