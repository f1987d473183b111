"""Shape manipulation — port of the shape subset of
``paddle_tpu/tensor/manipulation.py``: ``reshape``, ``flatten``,
``transpose``, ``squeeze``, ``unsqueeze``, ``concat``, ``stack`` and
``split`` (``chunk``). The rest of that file is not ported yet: reaching
one of its functions through ``paddle_tpu_torch.tensor`` raises
NotImplementedError."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["chunk", "concat", "flatten", "reshape", "split", "squeeze",
           "stack", "transpose", "unsqueeze"]


def _ints(x):
    if isinstance(x, torch.Tensor):
        x = x.tolist()
    if isinstance(x, (int, np.integer)):
        return int(x)
    return [int(v.item()) if isinstance(v, torch.Tensor) else int(v)
            for v in x]


def reshape(x, shape, name=None):
    """-1 infers one axis; a 0 is a size of 0, as ``jnp.reshape`` in the
    JAX package takes it (Paddle's "copy this axis" 0 is not ported)."""
    return torch.reshape(x, _ints(shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    s, e = start_axis % nd, stop_axis % nd
    return x.reshape(list(x.shape[:s]) + [-1] + list(x.shape[e + 1:]))


def transpose(x, perm, name=None):
    return x.permute(_ints(perm))


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes among ``axis`` (all of them when None); an
    axis of another size is kept, as in the JAX package."""
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(a % x.dim() for a in _ints(axes) if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    out = x
    for a in sorted(_ints(axes)):
        out = out.unsqueeze(a)
    return out


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=_ints(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


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
        return list(torch.split(x, total // n, dim=axis))
    secs = _ints(num_or_sections)
    known = sum(s for s in secs if s != -1)
    secs = [s if s != -1 else total - known for s in secs]
    return list(torch.split(x, secs, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)
