"""Tensor functions — port of ``paddle_tpu/tensor`` for the first program
a Paddle user writes: creation (``creation.py``) and the shape subset of
``manipulation.py``. The other functions of ``paddle_tpu/tensor`` (math,
linalg, logic, search, stat, random, the rest of manipulation …) are not
ported yet: reaching one here raises NotImplementedError, where a name
the JAX package does not have raises AttributeError."""
from .creation import (arange, assign, clone, diag, empty, empty_like, eye,
                       full, full_like, linspace, ones, ones_like, to_tensor,
                       tril, triu, zeros, zeros_like)
from .manipulation import (chunk, concat, flatten, reshape, split, squeeze,
                           stack, transpose, unsqueeze)

__all__ = ["arange", "assign", "chunk", "clone", "concat", "diag", "empty",
           "empty_like", "eye", "flatten", "full", "full_like", "linspace",
           "ones", "ones_like", "reshape", "split", "squeeze", "stack",
           "to_tensor", "transpose", "tril", "triu", "unsqueeze", "zeros",
           "zeros_like"]

# the JAX package's ``paddle_tpu.tensor`` functions not ported yet
_UNPORTED = frozenset("""
abs acos acosh add add_ addmm all allclose amax amin angle any argmax argmin
argsort array_length array_read array_write as_complex as_real asin asinh
atan atan2 atanh bernoulli bernoulli_ bincount binomial bitwise_and
bitwise_left_shift bitwise_not bitwise_or bitwise_right_shift bitwise_xor
bmm broadcast_shape broadcast_tensors broadcast_to bucketize cdist ceil
ceil_ cholesky cholesky_solve clip clip_ complex cond conj copysign corrcoef
cos cosh count_nonzero cov create_array create_tensor crop cross cummax
cummin cumprod cumsum deg2rad det diagflat diff digamma dist divide dot eig
eigh eigvals eigvalsh einsum equal equal_all erf erfinv erfinv_ exp exp_
expand expand_as expm1 exponential_ flatten_ flip floor floor_ floor_divide
floor_mod fmax fmin frac gather gather_nd gaussian gcd greater_equal
greater_than heaviside histogram histogramdd householder_product hypot i0
imag increment index_add index_fill index_put index_sample index_select
inner inv inverse is_empty is_tensor isclose isfinite isinf isnan kron
kthvalue lcm lerp lerp_ less_equal less_than lgamma log log10 log1p log2
logaddexp logical_and logical_not logical_or logical_xor logit logspace
logsumexp lstsq lu lu_unpack masked_fill masked_scatter masked_select matmul
matrix_exp matrix_norm matrix_power matrix_rank max maximum mean median
meshgrid min minimum mm mod mode moveaxis multi_dot multinomial multiplex
multiply nan_to_num nanmean nanmedian nanquantile nansum neg nextafter
nonzero norm normal normal_ not_equal numel outer pad pinv poisson polar pow
prod put_along_axis put_along_axis_ qr quantile rad2deg rand randint
randint_like randn randperm rank real reciprocal reciprocal_ remainder
remainder_ renorm repeat_interleave reshape_ roll rot90 round round_ rsqrt
rsqrt_ scale scale_ scatter scatter_ scatter_nd scatter_nd_add searchsorted
shape shard_index sigmoid sign sin sinh slice slogdet solve sort sqrt sqrt_
square standard_gamma standard_normal stanh std strided_slice subtract
subtract_ sum svd svd_lowrank svdvals swapaxes t take take_along_axis tan
tanh tensor_split tensordot tile topk trace trapezoid triangular_solve
tril_indices triu_indices trunc unbind unfold uniform uniform_ unique
unique_consecutive unstack var vector_norm view view_as where
""".split())


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(f"paddle.tensor.{name} is not ported yet "
                                  f"(ROADMAP A8b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
