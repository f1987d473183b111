"""``paddle_tpu_torch/tensor/math.py`` against ``paddle_tpu/tensor/math.py``
on the CPU, table-driven: one row a call, (id, name, args, kwargs,
tolerance, the port's dtype where it differs by rule). fp32 rows within
rtol 1e-5 / atol 1e-6 (the same arithmetic in another order), bf16 rows
within 2^-7, integer / bool results exactly. Paddle's rules where torch's
differ are held to JAX: integer ``floor_divide`` / ``mod`` signs,
``divide`` of integer tensors, the integer dtypes of ``sum`` / ``prod`` /
``cumsum`` / ``mean``, ``scale``'s ``bias_after_scale``, ``clip`` with
tensor bounds, ``cummax`` / ``cummin`` indices at ties, ``increment``
and the in-place ``_`` variants. A few differentiable rows hold PyTorch's
gradients to the JAX tape's."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_tensor_parity import (ANY, ANY2, B3, B3T, BF, BF2, BF16, BOOL,
                                 C34, EXACT, F32, GT1, I64, I64B, INTS,
                                 INTS2, POS, SPD, SPECIAL, TIES, UNIT, V3,
                                 assert_same, jx, row_id, run_row, tx)

NEG = -POS * 3.0
NANS = np.where(np.isnan(SPECIAL), np.nan, ANY).astype("float32")
V3B = np.array([0.5, -1.0, 2.0], "float32")
ROWS_IDX = np.array([[1], [0], [1]], "int32")
TAKE_IDX = np.array([[0, -1], [13, 5]], "int64")

ROWS = [
    # ---- binary elementwise
    ("add", "add", (ANY, ANY2), {}, F32, None),
    ("add_scalar", "add", (ANY, 2.5), {}, F32, None),
    ("add_bcast", "add", (ANY, ANY2[:, :1]), {}, F32, None),
    ("subtract", "subtract", (ANY, ANY2), {}, F32, None),
    ("multiply", "multiply", (ANY, ANY2), {}, F32, None),
    ("multiply_int", "multiply", (INTS, INTS2), {}, EXACT, None),
    ("divide", "divide", (ANY, POS), {}, F32, None),
    ("divide_int32", "divide", (INTS, INTS2), {}, F32, None),
    ("divide_int64", "divide", (I64, I64B), {}, F32, None),
    ("floor_divide_int", "floor_divide", (INTS, INTS2), {}, EXACT, None),
    ("floor_divide_f", "floor_divide", (NEG, POS), {}, F32, None),
    ("mod_int", "mod", (INTS, INTS2), {}, EXACT, None),
    ("remainder_int64", "remainder", (I64, I64B), {}, EXACT, None),
    ("floor_mod_f", "floor_mod", (NEG, POS), {}, F32, None),
    ("pow", "pow", (POS, 2.5), {}, F32, None),
    ("pow_tensor", "pow", (POS, UNIT), {}, F32, None),
    ("pow_int", "pow", (INTS, 3), {}, EXACT, None),
    ("maximum", "maximum", (ANY, ANY2), {}, EXACT, None),
    ("minimum", "minimum", (ANY, ANY2), {}, EXACT, None),
    ("fmax_nan", "fmax", (SPECIAL, ANY), {}, EXACT, None),
    ("fmin_nan", "fmin", (SPECIAL, ANY), {}, EXACT, None),
    ("atan2", "atan2", (ANY, POS), {}, F32, None),
    ("hypot", "hypot", (ANY, ANY2), {}, F32, None),
    ("copysign", "copysign", (POS, ANY), {}, EXACT, None),
    ("nextafter", "nextafter", (ANY, ANY2), {}, EXACT, None),
    ("heaviside", "heaviside", (ANY, UNIT), {}, EXACT, None),
    ("gcd", "gcd", (INTS, INTS2), {}, EXACT, None),
    ("lcm", "lcm", (INTS, INTS2), {}, EXACT, None),
    ("logaddexp", "logaddexp", (ANY, ANY2), {}, F32, None),
    # ---- unary elementwise (the sweep's domains)
    *((n, n, (x,), {}, F32, None) for n, x in (
        ("exp", ANY), ("expm1", ANY), ("log", POS), ("log2", POS),
        ("log10", POS), ("log1p", POS), ("sqrt", POS), ("rsqrt", POS),
        ("sin", ANY), ("cos", ANY), ("tan", UNIT), ("asin", UNIT),
        ("acos", UNIT), ("atan", ANY), ("sinh", ANY), ("cosh", ANY),
        ("tanh", ANY), ("asinh", ANY), ("acosh", GT1), ("atanh", UNIT * .9),
        ("square", ANY), ("reciprocal", POS), ("sigmoid", ANY),
        ("erf", ANY), ("erfinv", UNIT * 1.8 - .9), ("lgamma", POS + 1.0),
        ("digamma", POS + 1.0), ("i0", ANY), ("deg2rad", ANY),
        ("rad2deg", ANY), ("logit", UNIT), ("frac", ANY * 3),
        ("stanh", ANY), ("neg", ANY), ("abs", ANY), ("angle", ANY))),
    *((n, n, (ANY * 3,), {}, EXACT, None)
      for n in ("ceil", "floor", "round", "trunc", "sign")),
    ("exp_int32", "exp", (INTS,), {}, F32, None),
    ("sqrt_int64", "sqrt", (np.abs(I64),), {}, F32, None),
    ("abs_int", "abs", (INTS,), {}, EXACT, None),
    ("neg_int", "neg", (INTS,), {}, EXACT, None),
    ("square_int", "square", (INTS,), {}, EXACT, None),
    ("sign_int", "sign", (INTS,), {}, EXACT, None),
    ("conj", "conj", (C34,), {}, EXACT, None),
    ("real", "real", (C34,), {}, EXACT, None),
    ("imag", "imag", (C34,), {}, EXACT, None),
    ("imag_real", "imag", (ANY,), {}, EXACT, None),
    ("angle_c", "angle", (C34,), {}, F32, None),
    # ---- clip / scale
    ("clip", "clip", (ANY,), dict(min=-0.5, max=0.5), EXACT, None),
    ("clip_min", "clip", (ANY,), dict(min=-0.5), EXACT, None),
    ("clip_tensor", "clip", (ANY,), dict(min=np.array(-0.4, "float32"),
                                          max=np.array(0.3, "float32")),
     EXACT, None),
    ("scale", "scale", (ANY,), dict(scale=2.0, bias=1.0), F32, None),
    ("scale_before", "scale", (ANY, 2.0, 1.0, False), {}, F32, None),
    ("scale_tensor", "scale", (ANY,), dict(scale=np.array(3.0, "float32"),
                                           bias=-1.0), F32, None),
    ("multiplex", "multiplex", ([ANY, ANY2], ROWS_IDX), {}, EXACT, None),
    # ---- reductions
    *((f"{n}_{k}", n, (ANY,), kw, F32, None)
      for n in ("sum", "mean", "max", "min", "amax", "amin", "prod",
                "logsumexp", "nansum", "nanmean")
      for k, kw in (("all", {}), ("ax1", dict(axis=1)),
                    ("ax01_keep", dict(axis=[0, 1], keepdim=True)))),
    ("sum_f64", "sum", (ANY,), dict(axis=0, dtype="float64"), F32, None),
    ("sum_int32", "sum", (INTS,), dict(axis=1), EXACT, None),
    ("sum_bool", "sum", (BOOL,), {}, EXACT, None),
    ("prod_int32", "prod", (INTS2,), dict(axis=0), EXACT, None),
    ("prod_dtype", "prod", (ANY,), dict(axis=1, dtype="float64"), F32, None),
    ("mean_int32", "mean", (INTS,), dict(axis=0), F32, None),
    ("mean_int64", "mean", (I64,), {}, F32, None),
    ("max_int", "max", (INTS,), dict(axis=0), EXACT, None),
    ("nansum_nan", "nansum", (NANS,), {}, F32, None),
    ("nanmean_nan", "nanmean", (NANS,), dict(axis=1), F32, None),
    *((f"{n}_{k}", n, (x,), kw, EXACT, None)
      for n in ("all", "any", "count_nonzero")
      for k, x, kw in (("bool", BOOL, {}), ("int_ax1", INTS, dict(axis=1)),
                       ("f_keep", ANY * BOOL, dict(axis=0, keepdim=True)))),
    # ---- cumulative
    ("cumsum_flat", "cumsum", (ANY,), {}, F32, None),
    ("cumsum_ax1", "cumsum", (ANY,), dict(axis=1), F32, None),
    ("cumsum_int32", "cumsum", (INTS,), dict(axis=0), EXACT, None),
    ("cumsum_dtype", "cumsum", (INTS,), dict(axis=1, dtype="float64"),
     F32, None),
    ("cumsum_bool", "cumsum", (BOOL,), dict(axis=1), EXACT, None),
    ("cumprod", "cumprod", (UNIT + 0.5,), dict(dim=1), F32, None),
    ("cumprod_int", "cumprod", (INTS2,), dict(dim=0), EXACT, None),
    ("cummax_ties", "cummax", (TIES,), dict(axis=1), EXACT, None),
    ("cummin_ties", "cummin", (TIES,), dict(axis=0, dtype="int32"), EXACT,
     None),
    ("cummax_nan", "cummax", (SPECIAL,), dict(axis=1), EXACT, None),
    ("diff", "diff", (ANY,), {}, F32, None),
    ("diff_n2_ax0", "diff", (ANY,), dict(n=2, axis=0), F32, None),
    ("diff_prepend", "diff", (ANY,), dict(prepend=ANY2[:, :1],
                                          append=ANY2[:, 1:3]), F32, None),
    # ---- products
    ("matmul", "matmul", (ANY, ANY2.T), {}, F32, None),
    ("matmul_tx_ty", "matmul", (ANY.T, ANY2), dict(transpose_x=True,
                                                   transpose_y=True), F32,
     None),
    ("matmul_batched", "matmul", (B3, B3T), {}, F32, None),
    ("matmul_vec", "matmul", (ANY, ANY2[0]), {}, F32, None),
    ("mm", "mm", (ANY, ANY2.T), {}, F32, None),
    ("bmm", "bmm", (B3, B3T), {}, F32, None),
    ("dot_rows", "dot", (ANY, ANY2), {}, F32, None),
    ("dot_vec", "dot", (V3, V3B), {}, F32, None),
    ("inner", "inner", (ANY, ANY2), {}, F32, None),
    ("outer", "outer", (V3, ANY[0]), {}, F32, None),
    ("addmm", "addmm", (SPD, ANY, ANY2.T), dict(beta=0.5, alpha=2.0), F32,
     None),
    ("kron", "kron", (SPD[:2, :2], ANY[:2, :3]), {}, F32, None),
    ("cross", "cross", (SPD, ANY[:3, :3]), {}, F32, None),
    ("cross_ax1", "cross", (SPD, ANY[:3, :3]), dict(axis=1), F32, None),
    ("trace", "trace", (ANY,), {}, F32, None),
    ("trace_offset", "trace", (ANY,), dict(offset=1), F32, None),
    ("trace_int", "trace", (INTS,), {}, EXACT, None),
    # ---- checks, lerp, the rest
    ("isfinite", "isfinite", (SPECIAL,), {}, EXACT, None),
    ("isinf", "isinf", (SPECIAL,), {}, EXACT, None),
    ("isnan", "isnan", (SPECIAL,), {}, EXACT, None),
    ("nan_to_num", "nan_to_num", (SPECIAL,), {}, EXACT, None),
    ("nan_to_num_args", "nan_to_num", (SPECIAL,),
     dict(nan=1.5, posinf=9.0, neginf=-9.0), EXACT, None),
    ("lerp", "lerp", (ANY, ANY2, 0.3), {}, F32, None),
    ("lerp_tensor", "lerp", (ANY, ANY2, UNIT), {}, F32, None),
    ("inverse", "inverse", (SPD,), {}, F32, None),
    ("renorm", "renorm", (ANY, 2.0, 0, 1.0), {}, F32, None),
    ("renorm_ax1", "renorm", (ANY, 1.0, 1, 0.5), {}, F32, None),
    *((f"take_{m}", "take", (ANY, TAKE_IDX if m != "raise"
                             else TAKE_IDX % 12), dict(mode=m), EXACT, None)
      for m in ("raise", "wrap", "clip")),
    ("trapezoid", "trapezoid", (ANY,), {}, F32, None),
    ("trapezoid_x", "trapezoid", (ANY,), dict(x=np.cumsum(POS, 1)), F32,
     None),
    ("trapezoid_dx", "trapezoid", (ANY,), dict(dx=0.5, axis=0), F32, None),
    # ---- bf16: the same arithmetic, rounded to bf16
    ("add_bf16", "add", (BF, BF2), {}, BF16, None),
    ("exp_bf16", "exp", (BF,), {}, BF16, None),
    ("sum_bf16", "sum", (BF,), dict(axis=1), BF16, None),
    ("mean_bf16", "mean", (BF,), {}, BF16, None),
    ("matmul_bf16", "matmul", (BF, BF2.T), {}, BF16, None),
    ("max_bf16", "max", (BF,), dict(axis=0), EXACT, None),
]


@pytest.mark.parametrize("row", ROWS, ids=row_id)
def test_math_row_matches_jax(row):
    _, name, args, kwargs, tol, dtype = row
    run_row(name, args, kwargs, tol, dtype)


def test_a_python_float_meeting_an_int_tensor_is_the_default_float():
    """JAX's weak-type rule under its 64-bit test setting gives float64;
    the port gives the default dtype (fp32), with the same values."""
    j = paddle.add(jx(INTS), 2.5)
    t = pt.add(tx(INTS), 2.5)
    assert str(j.dtype) == "float64" and t.dtype == torch.float32
    assert_same(j, t, F32, "float32", "add(int, 2.5)")


def test_broadcast_shape_and_increment():
    assert pt.broadcast_shape([3, 1, 4], [2, 4]) == \
        paddle.broadcast_shape([3, 1, 4], [2, 4])
    j, t = jx(ANY), tx(ANY)
    jo, to = paddle.increment(j, 2.0), pt.increment(t, 2.0)
    assert to is t
    assert_same(jo, to, F32, None, "increment")
    assert_same(j, t, F32, None, "increment's input")


INPLACE = [("add_", (ANY2,), {}), ("subtract_", (ANY2,), {}),
           ("ceil_", (), {}), ("floor_", (), {}), ("round_", (), {}),
           ("clip_", (), dict(min=-0.3, max=0.3)), ("exp_", (), {}),
           ("erfinv_", (), {}), ("lerp_", (ANY2, 0.25), {}),
           ("reciprocal_", (), {}), ("remainder_", (POS,), {}),
           ("rsqrt_", (), {}), ("sqrt_", (), {}),
           ("scale_", (), dict(scale=3.0, bias=0.5))]


@pytest.mark.parametrize("row", INPLACE, ids=row_id)
def test_inplace_variant_writes_its_input(row):
    name, args, kwargs = row
    x = UNIT * 0.9 if name in ("erfinv_", "rsqrt_", "sqrt_",
                               "reciprocal_") else ANY
    j, t = jx(x), tx(x)
    jo = getattr(paddle, name)(j, *jx(args), **kwargs)
    to = getattr(pt, name)(t, *tx(args), **kwargs)
    assert to is t
    assert_same(jo, to, F32, None, name)
    assert_same(j, t, F32, None, name + " input")


# differentiable rows: the gradient of sum(f(x)) with respect to x
GRAD_ROWS = [
    ("exp", lambda m, x: m.exp(x)),
    ("sigmoid", lambda m, x: m.sigmoid(x)),
    ("logsumexp", lambda m, x: m.logsumexp(x, axis=1)),
    ("matmul", lambda m, x: m.matmul(x, x, transpose_y=True)),
    ("cumsum", lambda m, x: m.cumsum(x, axis=1) * x),
    ("lerp", lambda m, x: m.lerp(x, m.square(x), 0.3)),
    ("max_ax1", lambda m, x: m.max(x, axis=1)),
    ("prod", lambda m, x: m.prod(x, axis=0)),
    ("divide", lambda m, x: m.divide(x, m.add(m.abs(x), 1.0))),
    ("clip", lambda m, x: m.clip(x, -0.5, 0.5)),
]


@pytest.mark.parametrize("row", GRAD_ROWS, ids=row_id)
def test_gradient_matches_jax(row):
    _, f = row
    j = paddle.to_tensor(ANY, stop_gradient=False)
    paddle.sum(f(paddle, j)).backward()
    t = torch.from_numpy(ANY.copy()).requires_grad_()
    pt.sum(f(pt, t)).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                               **F32)
