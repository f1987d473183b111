"""Search and sort — port of ``paddle_tpu/tensor/search.py``.

The JAX package's orders are kept, which torch's fast paths do not
promise:

- ``sort`` / ``argsort`` sort stably ascending, and ``descending`` flips
  that order (so equal values come last-first, as ``jnp.flip`` of a
  stable sort);
- ``topk`` takes the first ``k`` of a stable sort (descending for
  ``largest``): among equal values the lower index comes first, as
  ``lax.top_k``'s, on either device;
- ``kthvalue`` is the ``k``-th of a stable ascending sort;
- ``mode`` counts on the host (as the JAX package's numpy loop): the most
  frequent value, the smallest among equally frequent ones, and the
  LAST index it sits at;
- ``nonzero`` is row-major and int64; ``where`` with the condition alone
  is ``nonzero(as_tuple=True)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dispatch import apply_op
from .manipulation import masked_select  # noqa: F401


def _arg_extreme(fn, x, axis, keepdim):
    def f(v):
        if axis is None:
            return fn(v.reshape(-1)).long()
        return fn(v, int(axis), keepdim=keepdim).long()

    return apply_op(f, x, op_name=fn.__name__)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme(torch.argmax, x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme(torch.argmin, x, axis, keepdim)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    def f(v):
        idx = torch.argsort(v, dim=axis, stable=True)
        return idx.flip(axis) if descending else idx

    return apply_op(f, x, op_name="argsort")


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def f(v):
        out = torch.sort(v, dim=axis, stable=True).values
        return out.flip(axis) if descending else out

    return apply_op(f, x, op_name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest) values along ``axis`` (default the
    last) and their int64 indices, the lower index first among equal
    values."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)

    def f(v):
        ax = -1 if axis is None else int(axis)
        vals, idx = torch.sort(v, dim=ax, descending=largest, stable=True)
        return vals.narrow(ax, 0, k), idx.narrow(ax, 0, k)

    return apply_op(f, x, op_name="topk")


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(x)
    if as_tuple:
        return tuple(nz.unbind(1))
    return nz


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b), condition,
                    x, y, op_name="where")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op(lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), sorted_sequence, values,
        op_name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply_op(lambda v, s: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), x, sorted_sequence,
        op_name="bucketize")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(v):
        vals, idx = torch.sort(v, dim=axis, stable=True)
        vals, idx = vals.select(axis, k - 1), idx.select(axis, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx

    return apply_op(f, x, op_name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of equally
    frequent ones) and the last index it sits at, counted on the host."""
    v = x.detach().cpu().numpy() if x.dtype != torch.bfloat16 else \
        x.detach().float().cpu().numpy()
    vm = np.moveaxis(v, axis, -1)
    flat = vm.reshape(-1, vm.shape[-1])
    vals = np.empty(flat.shape[0], vm.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        vals[i] = uniq[np.argmax(counts)]
        idxs[i] = np.where(row == vals[i])[0][-1]
    vals, idxs = vals.reshape(vm.shape[:-1]), idxs.reshape(vm.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, axis), np.expand_dims(idxs, axis)
    return (torch.from_numpy(vals).to(x.device, x.dtype),
            torch.from_numpy(idxs).to(x.device))


def index_fill(x, index, axis, value, name=None):
    return apply_op(lambda v, i: torch.index_fill(v, axis, i.long(), value),
                    x, index, op_name="index_fill")
