"""Elementwise and reduction math — port of ``paddle_tpu/tensor/math.py``.

Each function runs torch's counterpart of the JAX package's jnp call
through :func:`~paddle_tpu_torch.framework.dispatch.apply_op` (AMP's cast
rule, under the JAX package's op name where that name is on one of AMP's
lists: ``matmul`` / ``mm`` / ``bmm`` white, ``exp`` / ``log`` /
``square`` / ``sum`` / ``mean`` black). Where torch's rule differs from
the JAX package's, the JAX package's is kept:

- integer ``floor_divide`` floors and ``mod`` / ``remainder`` takes the
  divisor's sign (Python's rules, as jnp's); ``divide`` of two integer
  tensors is floating (float32, float64 for int64);
- ``sum`` / ``prod`` of an integer tensor are int64, ``cumsum`` /
  ``cumprod`` keep its dtype (torch widens them to int64), ``mean`` /
  ``exp`` / ``sqrt`` … of an integer tensor are float32 (float64 for
  int64);
- ``cummax`` / ``cummin`` point at the FIRST position of the running
  extreme among equal values (torch's point at the last);
- ``lerp`` is ``x + w · (y - x)`` and ``dot`` of matrices is row-wise,
  as in the JAX package;
- ``scale`` honours ``bias_after_scale``; ``clip`` takes tensor bounds;
  ``increment`` adds in place.

A Python float meeting an integer tensor gives the default floating dtype
(float32), where the JAX package under its 64-bit test configuration
gives float64 (its weak-type rule); the values agree.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..framework.dispatch import apply_op, defop
from ..framework.dtype import convert_dtype
from ._util import all_dims, as_tensor, to_inexact

def _pair(x, y):
    """``x`` and ``y`` as tensors on one device (a Python number takes the
    other operand's dtype where it is of its kind)."""
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, like=y if isinstance(y, torch.Tensor) else None)
    if not isinstance(y, torch.Tensor):
        y = as_tensor(y, like=x)
    return x, y


def _binary(fn, op_name):
    def op(x, y, name=None):
        return apply_op(fn, *_pair(x, y), op_name=op_name)

    op.__name__ = op_name
    return op


def _float_unary(fn, op_name):
    """A unary op whose result is floating: an integer input is computed
    in the JAX package's inexact dtype."""
    return defop(lambda x: fn(to_inexact(x)), op_name)


# ---- binary elementwise ----------------------------------------------------

add = _binary(torch.add, "add")
subtract = _binary(torch.subtract, "subtract")
multiply = _binary(torch.multiply, "multiply")


def _true_divide(a, b):
    if not (a.is_floating_point() or a.is_complex()
            or b.is_floating_point() or b.is_complex()):
        a, b = to_inexact(a), to_inexact(b)
    return torch.true_divide(a, b)


divide = _binary(_true_divide, "divide")
floor_divide = _binary(
    lambda a, b: torch.div(a, b, rounding_mode="floor"), "floor_divide")
mod = _binary(torch.remainder, "remainder")
remainder = mod
floor_mod = mod
pow = _binary(torch.pow, "pow")
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(torch.fmax, "fmax")
fmin = _binary(torch.fmin, "fmin")
atan2 = _binary(lambda a, b: torch.atan2(to_inexact(a), to_inexact(b)),
                "arctan2")
hypot = _binary(lambda a, b: torch.hypot(to_inexact(a), to_inexact(b)),
                "hypot")
copysign = _binary(lambda a, b: torch.copysign(to_inexact(a), b),
                   "copysign")
nextafter = _binary(torch.nextafter, "nextafter")
heaviside = _binary(torch.heaviside, "heaviside")
gcd = _binary(torch.gcd, "gcd")
lcm = _binary(torch.lcm, "lcm")
logaddexp = _binary(lambda a, b: torch.logaddexp(to_inexact(a),
                                                 to_inexact(b)), "logaddexp")

# ---- unary elementwise -----------------------------------------------------

exp = _float_unary(torch.exp, "exp")
expm1 = _float_unary(torch.expm1, "expm1")
log = _float_unary(torch.log, "log")
log2 = _float_unary(torch.log2, "log2")
log10 = _float_unary(torch.log10, "log10")
log1p = _float_unary(torch.log1p, "log1p")
sqrt = _float_unary(torch.sqrt, "sqrt")
rsqrt = _float_unary(torch.rsqrt, "rsqrt")
abs = defop(torch.abs, "abs")
ceil = defop(torch.ceil, "ceil")
floor = defop(torch.floor, "floor")
round = defop(torch.round, "round")
trunc = defop(torch.trunc, "trunc")
frac = defop(lambda x: x - torch.trunc(x), "frac")
sin = _float_unary(torch.sin, "sin")
cos = _float_unary(torch.cos, "cos")
tan = _float_unary(torch.tan, "tan")
asin = _float_unary(torch.asin, "asin")
acos = _float_unary(torch.acos, "acos")
atan = _float_unary(torch.atan, "atan")
sinh = _float_unary(torch.sinh, "sinh")
cosh = _float_unary(torch.cosh, "cosh")
tanh = _float_unary(torch.tanh, "tanh")
asinh = _float_unary(torch.asinh, "asinh")
acosh = _float_unary(torch.acosh, "acosh")
atanh = _float_unary(torch.atanh, "atanh")
square = defop(torch.square, "square")
reciprocal = _float_unary(torch.reciprocal, "reciprocal")
sign = defop(torch.sign, "sign")
neg = defop(torch.neg, "neg")
erf = _float_unary(torch.erf, "erf")
erfinv = _float_unary(torch.erfinv, "erfinv")
lgamma = _float_unary(torch.lgamma, "lgamma")
digamma = _float_unary(torch.digamma, "digamma")
i0 = _float_unary(torch.i0, "i0")
deg2rad = _float_unary(torch.deg2rad, "deg2rad")
rad2deg = _float_unary(torch.rad2deg, "rad2deg")
angle = _float_unary(torch.angle, "angle")
conj = defop(lambda x: torch.conj(x).resolve_conj(), "conj")
sigmoid = _float_unary(torch.sigmoid, "sigmoid")
logit = _float_unary(torch.logit, "logit")
exponent = defop(lambda x: torch.frexp(x).exponent, "exponent")


def real(x, name=None):
    """The real part (a real tensor as it is)."""
    return apply_op(lambda v: torch.real(v) if v.is_complex() else v, x,
                    op_name="real")


def imag(x, name=None):
    """The imaginary part (zeros for a real tensor, as jnp's)."""
    return apply_op(lambda v: torch.imag(v) if v.is_complex()
                    else torch.zeros_like(v), x, op_name="imag")


def clip(x, min=None, max=None, name=None):
    """``x`` between ``min`` and ``max`` (numbers or tensors; None: no
    bound); the bounds are not cast by AMP (JAX closes over them)."""
    def f(v, lo=min, hi=max):
        if lo is None and hi is None:
            return v.clone()
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            lo, hi = (b if b is None or isinstance(b, torch.Tensor)
                      else torch.tensor(b, dtype=v.dtype, device=v.device)
                      for b in (lo, hi))
        return torch.clamp(v, lo, hi)

    return apply_op(f, x, op_name="clip")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x · scale + bias``, or ``(x + bias) · scale`` when not
    ``bias_after_scale``; ``scale`` may be a tensor."""
    def f(v):
        return v * scale + bias if bias_after_scale else (v + bias) * scale

    return apply_op(f, x, op_name="scale")


def increment(x, value=1.0, name=None):
    """Adds ``value`` to ``x`` in place (outside autograd, as the JAX
    package rebinds the value); returns ``x``."""
    with torch.no_grad():
        x.add_(value)
    return x


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda v: scale_b * torch.tanh(scale_a * v), x,
                    op_name="stanh")


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]`` for each row ``i``."""
    def f(idx, *xs):
        stacked = torch.stack(xs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]

    return apply_op(f, index, *inputs, op_name="multiplex")


# ---- reductions ------------------------------------------------------------

def _reduce(fn, x, axis, keepdim, **kw):
    return fn(x, dim=all_dims(x, axis), keepdim=keepdim, **kw)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = convert_dtype(dtype)
    return apply_op(lambda v: _reduce(torch.sum, v, axis, keepdim, dtype=d),
                    x, op_name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.mean, to_inexact(v), axis,
                                      keepdim), x, op_name="mean")


def max(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.amax, v, axis, keepdim), x,
                    op_name="max")


def min(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.amin, v, axis, keepdim), x,
                    op_name="min")


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def _prod(v, axis, keepdim, dtype):
    dims = sorted(d % v.dim() for d in all_dims(v, axis)) if v.dim() else []
    if dtype is None and not (v.is_floating_point() or v.is_complex()):
        dtype = torch.int64
    if not dims:
        return v.to(dtype) if dtype is not None else v.clone()
    rest = [d for d in range(v.dim()) if d not in dims]
    flat = v.permute(rest + dims).reshape(
        [v.shape[d] for d in rest] + [-1])
    out = torch.prod(flat, -1, dtype=dtype)
    if keepdim:
        out = out.reshape([1 if d in dims else v.shape[d]
                           for d in range(v.dim())])
    return out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = convert_dtype(dtype)
    return apply_op(lambda v: _prod(v, axis, keepdim, d), x, op_name="prod")


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.logsumexp, to_inexact(v), axis,
                                      keepdim), x, op_name="logsumexp")


def all(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.all, v.bool(), axis, keepdim),
                    x, op_name="all")


def any(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.any, v.bool(), axis, keepdim),
                    x, op_name="any")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def f(v):
        dims = all_dims(v, axis)
        out = torch.count_nonzero(v, dim=dims)
        if keepdim:
            out = out.reshape([1 if d in {a % v.dim() for a in dims}
                               else v.shape[d] for d in range(v.dim())])
        return out

    return apply_op(f, x, op_name="count_nonzero")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = convert_dtype(dtype)
    return apply_op(lambda v: _reduce(torch.nansum, v, axis, keepdim,
                                      dtype=d), x, op_name="nansum")


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda v: _reduce(torch.nanmean, to_inexact(v), axis,
                                      keepdim), x, op_name="nanmean")


# ---- cumulative ------------------------------------------------------------

def _cum_dtype(v, dtype):
    if dtype is not None:
        return convert_dtype(dtype)
    if v.dtype == torch.bool:
        return torch.int64
    return v.dtype


def cumsum(x, axis=None, dtype=None, name=None):
    def f(v):
        if axis is None:
            v = v.reshape(-1)
        return torch.cumsum(v, 0 if axis is None else int(axis),
                            dtype=_cum_dtype(v, dtype))

    return apply_op(f, x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    return apply_op(lambda v: torch.cumprod(v, int(dim),
                                            dtype=_cum_dtype(v, dtype)),
                    x, op_name="cumprod")


def _cum_extreme(x, axis, dtype, largest):
    """(values, indices) of the running extreme; an index points at the
    first position the running value was reached (a later equal value
    does not move it), a NaN once met sticks and each later NaN takes the
    index, as the JAX package's scan."""
    def f(v):
        vv = v.reshape(-1) if axis is None else v
        ax = -1 if axis is None else int(axis)
        vals = (torch.cummax if largest else torch.cummin)(vv, ax).values
        n = vv.shape[ax]
        prev = torch.cat([vals.narrow(ax, 0, 1), vals.narrow(ax, 0, n - 1)],
                         ax)
        newer = (vv > prev) if largest else (vv < prev)
        if vv.is_floating_point():
            newer = newer | torch.isnan(vv)
        pos_shape = [1] * vv.dim()
        pos_shape[ax] = n
        pos = torch.arange(n, device=vv.device).reshape(pos_shape)
        marks = torch.where(newer, pos, torch.zeros_like(pos))
        idx = torch.cummax(marks.expand(vv.shape), ax).values
        return vals, idx.to(convert_dtype(dtype))

    return apply_op(f, x, op_name="cum_extreme")


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, True)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, False)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def edge(e, v):
        if e is None:
            return None
        e = as_tensor(e, like=v)
        if e.dim() == 0:
            shape = list(v.shape)
            shape[axis] = 1
            e = e.expand(shape)
        return e

    return apply_op(lambda v: torch.diff(v, n, axis, edge(prepend, v),
                                         edge(append, v)), x, op_name="diff")


# ---- matmul family ---------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` (each transposed in its last two axes first when asked);
    AMP's white list casts its inputs under O1."""
    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply_op(f, x, y, op_name="matmul")


def mm(x, y, name=None):
    return apply_op(torch.matmul, x, y, op_name="mm")


def bmm(x, y, name=None):
    return apply_op(torch.matmul, x, y, op_name="bmm")


def dot(x, y, name=None):
    """Sum of products over the last axis (row-wise for matrices)."""
    return apply_op(lambda a, b: (a * b).sum(-1), x, y, op_name="dot")


def inner(x, y, name=None):
    return apply_op(torch.inner, x, y, op_name="inner")


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                    x, y, op_name="outer")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                    input, x, y, op_name="addmm")


def kron(x, y, name=None):
    return apply_op(torch.kron, x, y, op_name="kron")


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (default: the first axis of size
    3)."""
    def f(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return apply_op(f, x, y, op_name="cross")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                    x, op_name="trace")


def isfinite(x, name=None):
    return apply_op(torch.isfinite, x, op_name="isfinite")


def isinf(x, name=None):
    return apply_op(torch.isinf, x, op_name="isinf")


def isnan(x, name=None):
    return apply_op(torch.isnan, x, op_name="isnan")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(lambda v: torch.nan_to_num(v, nan, posinf, neginf), x,
                    op_name="nan_to_num")


def lerp(x, y, weight, name=None):
    """``x + weight · (y - x)`` (a number or a tensor weight)."""
    if isinstance(weight, (int, float)):
        return apply_op(lambda a, b: a + weight * (b - a), x, y,
                        op_name="lerp")
    return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight,
                    op_name="lerp")


def inverse(x, name=None):
    return apply_op(torch.linalg.inv, x, op_name="inv")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled to p-norm at most ``max_norm``
    (by ``max_norm / (norm + 1e-7)``), as the JAX package's."""
    def f(v):
        dims = tuple(i for i in range(v.dim()) if i != axis)
        norms = v.abs().pow(p).sum(dims, keepdim=True).pow(1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return v * factor

    return apply_op(f, x, op_name="renorm")


def take(x, index, mode="raise", name=None):
    """Elements of the flattened ``x`` at ``index``: ``"wrap"`` takes
    indices modulo the size, ``"clip"`` clips them, ``"raise"`` reads a
    negative index from the end (no check, as in the JAX package)."""
    def f(v, idx):
        flat = v.reshape(-1)
        n = flat.shape[0]
        idx = idx.long()
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        elif mode == "clip":
            idx = idx.clamp(0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
        return flat[idx]

    return apply_op(f, x, index, op_name="take")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op(lambda yy, xx: torch.trapezoid(yy, xx, dim=axis), y,
                        x, op_name="trapezoid")
    return apply_op(lambda yy: torch.trapezoid(
        yy, dx=1.0 if dx is None else dx, dim=axis), y, op_name="trapezoid")


def log_normalize(x, axis=-1):
    return apply_op(lambda v: v - torch.logsumexp(v, axis, keepdim=True), x,
                    op_name="log_normalize")


# ---------------------------------------------------------------------------
# in-place variants: computed out of place, then written into ``x``
# (autograd records the copy; a leaf that requires grad refuses it, as
# PyTorch's own in-place ops do)
# ---------------------------------------------------------------------------

def _make_inplace(fn):
    @functools.wraps(fn)
    def method(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if out.dtype != x.dtype or out.shape != x.shape:
            raise ValueError(
                f"{fn.__name__}_: the result ({out.dtype}, "
                f"{list(out.shape)}) does not fit x ({x.dtype}, "
                f"{list(x.shape)}) in place")
        return x.copy_(out)

    method.__name__ = fn.__name__ + "_"
    method.__qualname__ = fn.__qualname__ + "_"
    method.__doc__ = f"In-place variant of :func:`{fn.__name__}`."
    return method


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
ceil_ = _make_inplace(ceil)
clip_ = _make_inplace(clip)
erfinv_ = _make_inplace(erfinv)
exp_ = _make_inplace(exp)
floor_ = _make_inplace(floor)
lerp_ = _make_inplace(lerp)
reciprocal_ = _make_inplace(reciprocal)
remainder_ = _make_inplace(remainder)
round_ = _make_inplace(round)
rsqrt_ = _make_inplace(rsqrt)
scale_ = _make_inplace(scale)
sqrt_ = _make_inplace(sqrt)
