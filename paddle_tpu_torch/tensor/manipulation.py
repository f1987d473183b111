"""Shape, layout, gather and scatter — port of
``paddle_tpu/tensor/manipulation.py``.

The functions keep the JAX package's rules where torch's differ:
``reshape`` reads a 0 as a size of 0 (as ``jnp.reshape``); ``split``
into equal parts needs the axis to divide; ``squeeze`` of an axis that is
not of size 1 keeps it; ``scatter`` with ``overwrite=False`` zeroes the
indexed rows then adds every update; ``tensor_split`` is
``np.array_split``; ``put_along_axis`` broadcasts its indices and values
against ``arr`` on the other axes; ``unique`` sorts and returns int64
indices and counts; ``masked_select`` / ``unique`` / ``nonzero`` have a
shape that depends on the data, so they read the device (as the JAX
package's concrete masks do) and cannot run inside a CUDA graph.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dispatch import apply_op
from ..framework.dtype import convert_dtype
from ._util import as_tensor, ints as _ints


def reshape(x, shape, name=None):
    """-1 infers one axis; a 0 is a size of 0, as ``jnp.reshape`` in the
    JAX package takes it (Paddle's "copy this axis" 0 is not ported)."""
    shape = _ints(shape)
    return apply_op(lambda v: torch.reshape(v, shape), x, op_name="reshape")


def reshape_(x, shape, name=None):
    """``x`` given the new shape in place (outside autograd, as the JAX
    package rebinds the value)."""
    x.data = x.detach().reshape(_ints(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(v):
        nd = v.dim()
        if nd == 0:
            return v.reshape(1)
        s, e = start_axis % nd, stop_axis % nd
        return v.reshape(list(v.shape[:s]) + [-1] + list(v.shape[e + 1:]))

    return apply_op(f, x, op_name="flatten")


def transpose(x, perm, name=None):
    perm = _ints(perm)
    return apply_op(lambda v: v.permute(perm), x, op_name="transpose")


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda v: torch.movedim(v, source, destination), x,
                    op_name="moveaxis")


def swapaxes(x, axis1, axis2, name=None):
    return apply_op(lambda v: torch.swapaxes(v, axis1, axis2), x,
                    op_name="swapaxes")


def t(x, name=None):
    return apply_op(lambda v: v.T if v.dim() >= 2 else v, x, op_name="t")


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes among ``axis`` (all of them when None); an
    axis of another size is kept, as in the JAX package."""
    def f(v):
        if axis is None:
            return torch.squeeze(v)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a % v.dim() for a in _ints(axes)
                     if v.shape[a % v.dim()] == 1)
        return torch.squeeze(v, axes) if axes else v

    return apply_op(f, x, op_name="squeeze")


def unsqueeze(x, axis, name=None):
    def f(v):
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        out = v
        for a in sorted(_ints(axes)):
            out = out.unsqueeze(a)
        return out

    return apply_op(f, x, op_name="unsqueeze")


def concat(x, axis=0, name=None):
    return apply_op(lambda *vs: torch.cat(vs, dim=_ints(axis)), *x,
                    op_name="concat")


def stack(x, axis=0, name=None):
    return apply_op(lambda *vs: torch.stack(vs, dim=axis), *x,
                    op_name="stack")


def unstack(x, axis=0, num=None, name=None):
    return list(apply_op(lambda v: torch.unbind(v, axis), x,
                         op_name="unstack"))


def unbind(x, axis=0):
    return unstack(x, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (an int, which must divide the
    axis, as ``jnp.split``), or parts of the given sizes, one of which
    may be -1."""
    axis = _ints(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if total % n:
            raise ValueError(f"split: axis {axis} of size {total} does not "
                             f"divide into {n} equal parts")
        secs = [total // n] * n
    else:
        secs = _ints(num_or_sections)
        known = builtins.sum(s for s in secs if s != -1)
        secs = [s if s != -1 else total - known for s in secs]
    return list(apply_op(lambda v: torch.split(v, secs, dim=axis), x,
                         op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    """``np.array_split``: ``n`` parts, the first ``size % n`` one longer,
    or parts between the given indices."""
    arg = num_or_indices if isinstance(num_or_indices, (int, np.integer)) \
        else _ints(num_or_indices)
    return list(apply_op(lambda v: torch.tensor_split(v, arg, dim=axis), x,
                         op_name="tensor_split"))


def slice(x, axes, starts, ends):
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def f(v):
        idx = [builtins.slice(None)] * v.dim()
        for a, s, e in zip(axes, starts, ends):
            idx[a] = builtins.slice(s, e)
        return v[tuple(idx)]

    return apply_op(f, x, op_name="slice")


def _sliced(v, axes, starts, ends, strides):
    """``v[s:e:st]`` on each axis; a negative step (which torch slicing
    refuses) gathers numpy's positions for it."""
    for a, s, e, st in zip(axes, starts, ends, strides):
        n = v.shape[a]
        if st > 0:
            v = v[(builtins.slice(None),) * (a % v.dim())
                  + (builtins.slice(s, e, st),)]
            continue
        idx = list(range(n))[builtins.slice(s, e, st)]
        v = torch.index_select(v, a, torch.tensor(idx, dtype=torch.long,
                                                  device=v.device))
    return v


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends, strides = (_ints(axes), _ints(starts), _ints(ends),
                                   _ints(strides))
    return apply_op(lambda v: _sliced(v, axes, starts, ends, strides), x,
                    op_name="strided_slice")


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps that axis's size."""
    shape = _ints(shape)

    def f(v):
        tgt = list(shape)
        off = len(tgt) - v.dim()
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = v.shape[i - off]
        return torch.broadcast_to(v, tgt)

    return apply_op(f, x, op_name="expand")


def expand_as(x, y, name=None):
    tgt = tuple(y.shape)
    return apply_op(lambda v: torch.broadcast_to(v, tgt), x,
                    op_name="expand_as")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(apply_op(lambda *vs: torch.broadcast_tensors(*vs), *inputs,
                         op_name="broadcast_tensors"))


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    reps = [reps] if isinstance(reps, int) else reps
    return apply_op(lambda v: torch.tile(v, reps), x, op_name="tile")


def repeat_interleave(x, repeats, axis=None, name=None):
    """``jnp.repeat``: each element ``repeats`` times (a number or a
    tensor of counts) along ``axis``, over the flattened ``x`` when
    None."""
    return apply_op(lambda v: torch.repeat_interleave(v, repeats, dim=axis),
                    x, op_name="repeat_interleave")


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda v: torch.flip(v, _ints(axes)), x, op_name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda v: torch.rot90(v, k, list(axes)), x,
                    op_name="rot90")


def roll(x, shifts, axis=None, name=None):
    sh = _ints(shifts)
    ax = None if axis is None else _ints(axis)

    def f(v):
        if ax is None:
            return torch.roll(v, sh)
        return torch.roll(v, sh, ax)

    return apply_op(f, x, op_name="roll")


def gather(x, index, axis=0, name=None):
    axis_i = _ints(axis)
    return apply_op(lambda v, i: torch.index_select(v, axis_i,
                                                    i.reshape(-1).long())
                    .reshape(v.shape[:axis_i] + i.shape
                             + v.shape[axis_i + 1:]),
                    x, index, op_name="gather")


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], …]``."""
    def f(v, idx):
        idx = idx.long()
        return v[tuple(idx.movedim(-1, 0))]

    return apply_op(f, x, index, op_name="gather_nd")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_op(lambda v, i: torch.take_along_dim(v, i.long(), axis),
                    arr, indices, op_name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` written (``"assign"``), added (``"add"``) or
    multiplied (``"mul"``) at ``indices`` along ``axis``; indices and
    values broadcast against ``arr`` on the other axes."""
    def f(v, i, val):
        ax = axis % v.dim()
        bshape = list(v.shape)
        bshape[ax] = i.shape[ax]
        i = torch.broadcast_to(i.long(), bshape).contiguous()
        val = torch.broadcast_to(as_tensor(val, like=v), bshape).to(
            v.dtype).contiguous()
        if reduce == "add":
            return v.scatter_add(ax, i, val)
        if reduce in ("mul", "multiply"):
            return v.scatter_reduce(ax, i, val, "prod")
        return v.scatter(ax, i, val)

    return apply_op(f, arr, indices, values, op_name="put_along_axis")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (the last write of a
    repeated index wins), or with ``overwrite=False`` zeroed and then
    summed over every update to them."""
    def f(v, i, u):
        i = i.reshape(-1).long()
        if overwrite:
            return v.index_put((i,), u)
        base = v.index_put((i,), torch.zeros_like(u))
        return base.index_put((i,), u, accumulate=True)

    return apply_op(f, x, index, updates, op_name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    return x.copy_(scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    shape = _ints(shape)

    def f(i, u):
        z = torch.zeros(shape, dtype=u.dtype, device=u.device)
        return z.index_put(tuple(i.long().movedim(-1, 0)), u,
                           accumulate=True)

    return apply_op(f, index, updates, op_name="scatter_nd")


def scatter_nd_add(x, index, updates, name=None):
    def f(v, i, u):
        return v.index_put(tuple(i.long().movedim(-1, 0)), u,
                           accumulate=True)

    return apply_op(f, x, index, updates, op_name="scatter_nd_add")


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda v, i: torch.index_select(v, axis, i.long()), x,
                    index, op_name="index_select")


def index_sample(x, index):
    return apply_op(lambda v, i: torch.take_along_dim(v, i.long(), 1), x,
                    index, op_name="index_sample")


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda v, i, val: torch.index_add(v, axis, i.long(), val),
                    x, index, value, op_name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    def f(v, val, *idx):
        idx = tuple(i.long() if not (i.is_floating_point()
                                     or i.dtype == torch.bool) else i
                    for i in idx)
        return v.index_put(idx, as_tensor(val, like=v).to(v.dtype),
                           accumulate=accumulate)

    return apply_op(f, x, value, *indices, op_name="index_put")


def masked_select(x, mask, name=None):
    """The entries of ``x`` where ``mask`` is set (its shape read on the
    host), in row-major order."""
    return apply_op(lambda v, m: v[torch.broadcast_to(m.bool(), v.shape)],
                    x, mask, op_name="masked_select")


def masked_fill(x, mask, value, name=None):
    def f(v, m):
        val = value.to(v.dtype) if isinstance(value, torch.Tensor) \
            else torch.tensor(value, dtype=v.dtype, device=v.device)
        return torch.where(m.bool(), val, v)

    return apply_op(f, x, mask, op_name="masked_fill")


def masked_scatter(x, mask, value, name=None):
    """``x`` with its masked entries replaced, in row-major order, by the
    first entries of ``value``."""
    def f(v, val):
        m = torch.broadcast_to(mask.bool(), v.shape)
        k = int(m.sum())
        out = v.clone()
        out[m] = val.reshape(-1)[:k].to(v.dtype)
        return out

    return apply_op(f, x, value, op_name="masked_scatter")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``: the sorted unique values (of the flattened ``x``, or
    the unique slices along ``axis``), with the first index of each,
    the inverse map and the counts when asked (int64)."""
    v = x if axis is None else x.movedim(axis, 0)
    if axis is None:
        v = v.reshape(-1)
    uniq, inverse, counts = torch.unique(
        v, sorted=True, return_inverse=True, return_counts=True,
        dim=None if axis is None else 0)
    outs = [uniq if axis is None else uniq.movedim(0, axis)]
    if return_index:
        n = v.shape[0]
        pos = torch.arange(n, device=v.device)
        first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                           device=v.device)
        outs.append(first.scatter_reduce(0, inverse.reshape(-1), pos,
                                         "amin"))
    if return_inverse:
        # numpy's: of the input's shape without an axis
        outs.append(inverse.reshape(x.shape) if axis is None else inverse)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """The first of each run of equal values (slices along ``axis``),
    with the inverse map and the run lengths when asked (int64)."""
    v = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else axis
    out, inverse, counts = torch.unique_consecutive(
        v, return_inverse=True, return_counts=True, dim=ax)
    outs = [out]
    if return_inverse:
        outs.append(inverse.reshape(-1).long())
    if return_counts:
        outs.append(counts.long())
    return outs[0] if len(outs) == 1 else tuple(outs)


def as_complex(x, name=None):
    return apply_op(lambda v: torch.complex(v[..., 0], v[..., 1]), x,
                    op_name="as_complex")


def as_real(x, name=None):
    return apply_op(lambda v: torch.stack([v.real, v.imag], -1), x,
                    op_name="as_real")


def view(x, shape_or_dtype, name=None):
    """A reshape (a shape), or a cast (a dtype), as the JAX package's."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.to(convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, list(other.shape))


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis`` as a new last
    axis (``Tensor.unfold``)."""
    return apply_op(lambda v: v.unfold(axis, size, step), x,
                    op_name="unfold")


def _pad_positions(n, lo, hi, mode, device):
    """The source position of each output position along an axis of size
    ``n`` padded by ``lo`` / ``hi`` (numpy's ``reflect``, ``edge`` and
    ``wrap``)."""
    p = torch.arange(-lo, n + hi, device=device)
    if mode == "reflect":
        period = 2 * n - 2
        q = torch.remainder(p, period)
        return torch.where(q >= n, period - q, q)
    if mode == "replicate":
        return p.clamp(0, n - 1)
    return torch.remainder(p, n)                        # circular


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``jnp.pad`` as the JAX package calls it: ``pad`` gives a (low,
    high) pair per axis in order (``2 · ndim`` entries), or pairs for the
    spatial axes of ``data_format`` from the last one back (Paddle's
    ``[left, right, top, bottom]``); ``mode`` is ``"constant"`` (with
    ``value``), ``"reflect"``, ``"replicate"`` or ``"circular"``."""
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def f(v):
        nd = v.dim()
        if len(pad) == 2 * nd:
            widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            n_spatial = len(pad) // 2
            widths = [(0, 0)] * nd
            if data_format.endswith("C"):
                spatial = list(range(1, 1 + n_spatial))
            else:
                spatial = list(range(nd - n_spatial, nd))
            for i, dim in enumerate(reversed(spatial)):
                widths[dim] = (pad[2 * i], pad[2 * i + 1])
        if mode == "constant":
            flat = [w for lo_hi in reversed(widths) for w in lo_hi]
            return torch.nn.functional.pad(v, flat, value=value)
        for dim, (lo, hi) in enumerate(widths):
            if lo or hi:
                v = torch.index_select(v, dim, _pad_positions(
                    v.shape[dim], lo, hi, mode, v.device))
        return v

    return apply_op(f, x, op_name="pad")


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, torch.Tensor):
        ax = ax.tolist()
    if isinstance(ax, (list, tuple)):
        ax = [list(_ints(a)) if isinstance(a, (list, tuple, torch.Tensor))
              else a for a in ax]
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=ax), x, y,
                    op_name="tensordot")


def crop(x, shape=None, offsets=None, name=None):
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else [0] * len(shape)

    def f(v):
        idx = tuple(builtins.slice(o, o + s if s != -1 else None)
                    for o, s in zip(offsets, shape))
        return v[idx]

    return apply_op(f, x, op_name="crop")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        shard_size = (index_num + nshards - 1) // nshards
        lo = shard_id * shard_size
        in_shard = (v >= lo) & (v < lo + shard_size)
        return torch.where(in_shard, v - lo, torch.full_like(v,
                                                             ignore_value))

    return apply_op(f, input, op_name="shard_index")


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    """``x`` flattened in place (outside autograd, as :func:`reshape_`)."""
    x.data = flatten(x.detach(), start_axis, stop_axis)
    return x


def put_along_axis_(arr, indices, values, axis, reduce="assign",
                    name=None):
    return arr.copy_(put_along_axis(arr, indices, values, axis, reduce))
