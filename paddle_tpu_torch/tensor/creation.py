"""Tensor creation — port of ``paddle_tpu/tensor/creation.py``:
``to_tensor``, ``zeros`` / ``ones`` / ``full`` and their ``_like`` forms,
``empty``, ``arange``, ``linspace``, ``logspace``, ``eye``, ``meshgrid``,
``diag``, ``diagflat``, ``tril`` / ``triu`` and their ``_indices``,
``complex``, ``polar``, ``assign`` and ``clone``.

Each function that makes a tensor from nothing takes ``device`` (Paddle's
``place`` its alias; None: the CUDA card, raising without one); the
``_like`` forms and the functions of a tensor follow their input's
device. Dtypes follow the JAX package's rules (which run with 64-bit
types on): a float64 input to ``to_tensor`` — a Python float, a list of
them, a float64 array — becomes the default dtype (fp32), a Python int
int64; ``full`` of an int is int64 and of a bool bool; ``arange`` of ints
is int64. ``to_tensor`` returns a ``torch.Tensor`` whose
``requires_grad`` is ``not stop_gradient`` (a tensor has no
``stop_gradient`` attribute: a divergence from Paddle).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_place
from ..framework.dtype import convert_dtype, get_default_dtype

__all__ = ["arange", "assign", "clone", "complex", "diag", "diagflat",
           "empty", "empty_like", "eye", "full", "full_like", "linspace",
           "logspace", "meshgrid", "ones", "ones_like", "polar", "to_tensor",
           "tril", "tril_indices", "triu", "triu_indices", "zeros",
           "zeros_like"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True, *,
              device=None) -> torch.Tensor:
    """``paddle.to_tensor``: a copy of ``data`` (a tensor, an array, a
    number or nested lists) on the device, in ``dtype`` or the inferred
    one (float64 → the default dtype, as in the JAX package)."""
    device = resolve_place(device, place)
    if isinstance(data, torch.Tensor):
        val = data.detach().to(device, copy=True)
    else:
        from ..framework.io_state import from_numpy

        val = from_numpy(np.asarray(data), device)
    d = convert_dtype(dtype)
    if d is not None:
        val = val.to(d)
    elif val.dtype == torch.float64:
        # paddle defaults python floats to the default float dtype
        val = val.to(get_default_dtype())
    if not stop_gradient:
        val.requires_grad_(True)
    return val


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def zeros(shape, dtype=None, name=None, *, device=None, place=None):
    return torch.zeros(_shape_list(shape),
                       dtype=convert_dtype(dtype) or get_default_dtype(),
                       device=resolve_place(device, place))


def ones(shape, dtype=None, name=None, *, device=None, place=None):
    return torch.ones(_shape_list(shape),
                      dtype=convert_dtype(dtype) or get_default_dtype(),
                      device=resolve_place(device, place))


def full(shape, fill_value, dtype=None, name=None, *, device=None,
         place=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            d = torch.bool
        elif isinstance(fill_value, int):
            d = torch.int64
        else:
            d = get_default_dtype()
    else:
        d = convert_dtype(dtype)
    return torch.full(_shape_list(shape), fill_value, dtype=d,
                      device=resolve_place(device, place))


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


def empty(shape, dtype=None, name=None, *, device=None, place=None):
    """Zeros, as the JAX package's ``empty``."""
    return zeros(shape, dtype, device=device, place=place)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, device=None,
           place=None):
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, end, step))
    if dtype is None:
        d = torch.int64 if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) \
            else get_default_dtype()
    else:
        d = convert_dtype(dtype)
    # numpy's arange, as jnp.arange: the same length and values for
    # float steps
    vals = np.arange(start, end, step, dtype=np.float64 if d.is_floating_point
                     else np.int64)
    return torch.from_numpy(vals).to(device=resolve_place(device, place),
                                     dtype=d)


def linspace(start, stop, num, dtype=None, name=None, *, device=None,
             place=None):
    start, stop, num = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, stop, num))
    d = convert_dtype(dtype) or get_default_dtype()
    vals = np.linspace(start, stop, int(num))
    return torch.from_numpy(vals).to(device=resolve_place(device, place),
                                     dtype=d)


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None,
        place=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=convert_dtype(dtype) or get_default_dtype(),
                     device=resolve_place(device, place))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D input as the diagonal (``offset``) of a square matrix whose
    other entries are ``padding_value``; a 2-D input's diagonal."""
    out = torch.diag(x, diagonal=offset)
    if x.dim() == 1 and padding_value != 0:
        pad = torch.full_like(out, padding_value)
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool),
                          diagonal=offset)
        out = torch.where(mask, out, pad)
    return out


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal=diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal=diagonal)


def assign(x, output=None, *, device=None, place=None):
    """A copy of ``x``: of a tensor, kept on the autograd graph; of an
    array or a list, a new tensor in its own dtype on ``device``; or
    written into ``output`` in place."""
    from ..framework.io_state import from_numpy

    if output is not None:
        with torch.no_grad():
            output.copy_(x if isinstance(x, torch.Tensor)
                         else from_numpy(np.asarray(x), output.device))
        return output
    if isinstance(x, torch.Tensor):
        return x.clone()
    return from_numpy(np.asarray(x), resolve_place(device, place))


def clone(x, name=None):
    return x.clone()


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None, place=None):
    """``base ** linspace(start, stop, num)`` (numpy's, as jnp's)."""
    vals = np.logspace(float(start), float(stop), int(num), base=float(base))
    return torch.from_numpy(vals).to(device=resolve_place(device, place),
                                     dtype=convert_dtype(dtype)
                                     or get_default_dtype())


def meshgrid(*args, **kwargs):
    """``ij``-indexed grids of 1-D tensors (given as arguments or one
    list)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def _indices(fn, row, col, offset, dtype, device, place):
    r, c = fn(row, offset, col)
    return torch.from_numpy(np.stack([r, c])).to(
        device=resolve_place(device, place), dtype=convert_dtype(dtype))


def tril_indices(row, col, offset=0, dtype="int64", *, device=None,
                 place=None):
    return _indices(np.tril_indices, row, col, offset, dtype, device, place)


def triu_indices(row, col=None, offset=0, dtype="int64", *, device=None,
                 place=None):
    return _indices(np.triu_indices, row, row if col is None else col,
                    offset, dtype, device, place)


def complex(real, imag, name=None):
    """``real + 1j · imag`` (complex64 from float32 parts)."""
    return torch.complex(real, imag)


def polar(abs_t, angle, name=None):
    return torch.polar(abs_t, angle)
