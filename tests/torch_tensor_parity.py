"""Shared by the tests of the port's tensor functions
(``tests/test_torch_tensor_*.py``): seeded numpy inputs, made as
``tests/test_op_sweep.py`` and ``tests/test_op_sweep_extended.py`` make
theirs (small shapes shared across rows, so that JAX compiles few), their
conversion into each package's tensors, and the comparison of the two
packages' results: shapes and dtypes equal, integer / bool / index
results exactly, floating ones within the row's tolerance."""
import ml_dtypes
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

RNG = np.random.RandomState(7)
POS = np.abs(RNG.randn(3, 4)).astype("float32") + 0.5   # strictly positive
ANY = RNG.randn(3, 4).astype("float32")
ANY2 = RNG.randn(3, 4).astype("float32")
UNIT = np.clip(RNG.rand(3, 4).astype("float32"), 0.05, 0.95)  # (0, 1)
GT1 = np.abs(RNG.randn(3, 4)).astype("float32") + 1.5   # > 1
INTS = RNG.randint(-5, 6, (3, 4)).astype("int32")
INTS2 = (RNG.randint(1, 4, (3, 4)) * np.where(RNG.rand(3, 4) > 0.5, 1, -1)
         ).astype("int32")                              # nonzero divisors
I64 = INTS.astype("int64")
I64B = INTS2.astype("int64")
SQ = RNG.randn(3, 3).astype("float32")
SPD = (SQ @ SQ.T + 3 * np.eye(3)).astype("float32")     # symmetric pos-def
V3 = RNG.randn(3).astype("float32")
B3 = RNG.randn(2, 3, 4).astype("float32")
B3T = RNG.randn(2, 4, 3).astype("float32")
C34 = (RNG.randn(3, 4) + 1j * RNG.randn(3, 4)).astype("complex64")
BOOL = RNG.rand(3, 4) > 0.5
BOOL2 = RNG.rand(3, 4) > 0.5
# repeated values: ties for sort / topk / cummax / mode / median
TIES = np.array([[1., 3., 3., 2.], [2., 2., 1., 2.], [5., 4., 5., 0.]],
                "float32")
SPECIAL = np.array([[0., np.nan, 1., np.inf], [-np.inf, 2., -1., 0.5],
                    [3., -2., np.nan, 1.]], "float32")
BF = ANY.astype(ml_dtypes.bfloat16)
BF2 = ANY2.astype(ml_dtypes.bfloat16)

F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 results: one rounding of 2^-8 apart at most, relative
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
EXACT = dict(rtol=0, atol=0)


def jx(v):
    """``v`` with its numpy arrays as JAX-package tensors."""
    if isinstance(v, np.ndarray):
        return paddle.to_tensor(v)
    if isinstance(v, (list, tuple)):
        return type(v)(jx(a) for a in v)
    if isinstance(v, dict):
        return {k: jx(a) for k, a in v.items()}
    return v


def tx(v):
    """``v`` with its numpy arrays as CPU ``torch.Tensor``s (a copy)."""
    if isinstance(v, np.ndarray):
        from paddle_tpu_torch.framework.io_state import from_numpy

        return from_numpy(np.array(v), "cpu")
    if isinstance(v, (list, tuple)):
        return type(v)(tx(a) for a in v)
    if isinstance(v, dict):
        return {k: tx(a) for k, a in v.items()}
    return v


def leaves(v):
    if isinstance(v, (list, tuple)):
        out = []
        for a in v:
            out += leaves(a)
        return out
    return [v]


def dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.dtype(v.dtype).name


def host(v) -> np.ndarray:
    """A result as numpy (bf16 widened to fp32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v.numpy() if hasattr(v, "numpy") else v)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def assert_same(j, t, tol=F32, dtype=None, what=""):
    """The JAX package's result ``j`` against the port's ``t``: the same
    structure, shapes and dtypes (``dtype``: the port's expected dtype
    where it differs by rule), integer / bool results exactly, floating
    ones within ``tol``."""
    jl, tl = leaves(j), leaves(t)
    assert len(jl) == len(tl), f"{what}: {len(jl)} results against {len(tl)}"
    for k, (a, b) in enumerate(zip(jl, tl)):
        if not hasattr(a, "dtype"):                 # a number or a shape
            assert a == b, f"{what}[{k}]: {a} != {b}"
            continue
        want = dtype or dtype_name(a)
        assert dtype_name(b) == want, \
            f"{what}[{k}]: dtype {dtype_name(b)}, want {want}"
        ha, hb = host(a), host(b)
        assert ha.shape == hb.shape, f"{what}[{k}]: {ha.shape} != {hb.shape}"
        if ha.dtype.kind in "iub":
            np.testing.assert_array_equal(hb, ha, err_msg=f"{what}[{k}]")
        else:
            np.testing.assert_allclose(hb, ha, equal_nan=True, **tol,
                                       err_msg=f"{what}[{k}]")


def run_row(name, args, kwargs, tol=F32, dtype=None, module=None):
    """Call ``name`` of both packages (``module``: a submodule path such
    as ``"linalg"``) on the same inputs and compare."""
    jm, tm = paddle, pt
    for part in (module.split(".") if module else []):
        jm, tm = getattr(jm, part), getattr(tm, part)
    j = getattr(jm, name)(*jx(args), **jx(kwargs))
    t = getattr(tm, name)(*tx(args), **tx(kwargs))
    assert_same(j, t, tol, dtype, name)
    return j, t


def row_id(row) -> str:
    return row[0]
