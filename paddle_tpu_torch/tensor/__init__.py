"""Tensor functions — port of ``paddle_tpu/tensor``: every function it
exports, from the modules of the same names (``creation``,
``manipulation``, ``math``, ``linalg``, ``logic``, ``search``, ``stat``,
``random``, ``attribute``, ``array``, ``einsum``).

The tensor is ``torch.Tensor`` (``Tensor`` here). The JAX package also
patches its functions onto its own ``Tensor`` as methods and operators
(``paddle_tpu/tensor/__init__.py``, ``_patch_tensor_methods``). The port
does not patch ``torch.Tensor``: that would change every torch program in
the process, the port's own kernel wrappers included. A method that
``torch.Tensor`` lacks (``astype``, ``cast``, …) or gives another meaning
(``numpy`` of a CUDA tensor, ``max`` / ``min`` / ``sort`` / ``unique``
returning index tuples or another order, …) is reached as the
``paddle.`` function of the same name; ROADMAP §C lists them.
"""
import torch

from . import (array, attribute, creation, einsum as _einsum_mod, linalg,
               logic, manipulation, math, random, search, stat)
from .array import (array_length, array_read, array_write, create_array,
                    create_tensor)
from .attribute import rank, shape
from .creation import (arange, assign, clone, complex, diag, diagflat, empty,
                       empty_like, eye, full, full_like, linspace, logspace,
                       meshgrid, ones, ones_like, polar, to_tensor, tril,
                       tril_indices, triu, triu_indices, zeros, zeros_like)
from .einsum import einsum
from .linalg import (cdist, cholesky, cholesky_solve, cond, det, dist, eig,
                     eigh, eigvals, eigvalsh, householder_product, inv, lstsq,
                     lu, lu_unpack, matrix_exp, matrix_norm, matrix_power,
                     matrix_rank, multi_dot, norm, pinv, qr, slogdet, solve,
                     svd, svd_lowrank, svdvals, triangular_solve, vector_norm)
from .logic import (allclose, bitwise_and, bitwise_left_shift, bitwise_not,
                    bitwise_or, bitwise_right_shift, bitwise_xor, equal,
                    equal_all, greater_equal, greater_than, is_empty,
                    is_tensor, isclose, less_equal, less_than, logical_and,
                    logical_not, logical_or, logical_xor, not_equal)
from .manipulation import (as_complex, as_real, broadcast_tensors,
                           broadcast_to, chunk, concat, crop, expand,
                           expand_as, flatten, flatten_, flip, gather,
                           gather_nd, index_add, index_put, index_sample,
                           index_select, masked_fill, masked_scatter,
                           masked_select, moveaxis, pad, put_along_axis,
                           put_along_axis_, repeat_interleave, reshape,
                           reshape_, roll, rot90, scatter, scatter_,
                           scatter_nd, scatter_nd_add, shard_index, slice,
                           split, squeeze, stack, strided_slice, swapaxes, t,
                           take_along_axis, tensor_split, tensordot, tile,
                           transpose, unbind, unfold, unique,
                           unique_consecutive, unsqueeze, unstack, view,
                           view_as)
from .math import (abs, acos, acosh, add, add_, addmm, all, amax, amin, angle,
                   any, asin, asinh, atan, atan2, atanh, bmm, broadcast_shape,
                   ceil, ceil_, clip, clip_, conj, copysign, cos, cosh,
                   count_nonzero, cross, cummax, cummin, cumprod, cumsum,
                   deg2rad, diff, digamma, divide, dot, erf, erfinv, erfinv_,
                   exp, exp_, expm1, floor, floor_, floor_divide, floor_mod,
                   fmax, fmin, frac, gcd, heaviside, hypot, i0, imag,
                   increment, inner, inverse, isfinite, isinf, isnan, kron,
                   lcm, lerp, lerp_, lgamma, log, log1p, log2, log10,
                   logaddexp, logit, logsumexp, matmul, max, maximum, mean,
                   min, minimum, mm, mod, multiplex, multiply, nan_to_num,
                   nanmean, nansum, neg, nextafter, outer, pow, prod, rad2deg,
                   real, reciprocal, reciprocal_, remainder, remainder_,
                   renorm, round, round_, rsqrt, rsqrt_, scale, scale_,
                   sigmoid, sign, sin, sinh, sqrt, sqrt_, square, stanh,
                   subtract, subtract_, sum, take, tan, tanh, trace,
                   trapezoid, trunc)
from .random import (bernoulli, bernoulli_, binomial, exponential_, gaussian,
                     multinomial, normal, normal_, poisson, rand, randint,
                     randint_like, randn, randperm, standard_gamma,
                     standard_normal, uniform, uniform_)
from .search import (argmax, argmin, argsort, bucketize, index_fill,
                     kthvalue, mode, nonzero, searchsorted, sort, topk, where)
from .stat import (bincount, corrcoef, cov, histogram, histogramdd, median,
                   nanmedian, nanquantile, numel, quantile, std, var)

Tensor = torch.Tensor

__all__ = sorted(n for n in dir() if not n.startswith("_")
                 and n not in ("torch", "array", "attribute", "creation",
                               "linalg", "logic", "manipulation", "math",
                               "random", "search", "stat"))
