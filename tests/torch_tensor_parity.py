"""Shared by the tests of the port's tensor functions
(``tests/test_torch_tensor_*.py``) and of its layers and models: the
JAX package's models built without their random draws (``jax_draws_
stubbed``, ``jax_host_init``: their weights are replaced by the port's);
seeded numpy inputs, made as
``tests/test_op_sweep.py`` and ``tests/test_op_sweep_extended.py`` make
theirs (small shapes shared across rows, so that JAX compiles few), their
conversion into each package's tensors, and the comparison of the two
packages' results: shapes and dtypes equal, integer / bool / index
results exactly, floating ones within the row's tolerance."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

@pytest.fixture
def jax_draws_stubbed(monkeypatch):
    """The JAX package's initializers draw zeros: its weights are replaced
    by the port's before use, and each real draw compiles per shape."""
    def zeros(key, shape=(), dtype=jnp.float32, *a, **kw):
        return jnp.zeros(shape, dtype)

    for n in ("normal", "uniform", "truncated_normal"):
        monkeypatch.setattr(jax.random, n, zeros)


@contextlib.contextmanager
def jax_host_init():
    """While building a JAX-package model that only receives the port's
    weights: its draws, ``jnp.zeros``, ``ones`` and ``full`` make numpy
    arrays on the host (each JAX one compiles per shape: ~0.7 s of a
    DenseNet-121's build against ~5 s)."""
    def draw(key, shape=(), dtype=jnp.float32, *a, **kw):
        return np.zeros(shape, dtype)

    stubs = {(jax.random, n): draw for n in ("normal", "uniform",
                                             "truncated_normal")}
    stubs[(jnp, "zeros")] = lambda s, dtype=None, **k: np.zeros(
        s, dtype or np.float32)
    stubs[(jnp, "ones")] = lambda s, dtype=None, **k: np.ones(
        s, dtype or np.float32)
    stubs[(jnp, "full")] = lambda s, v, dtype=None, **k: np.full(
        s, v, dtype or np.float32)
    saved = {k: getattr(*k) for k in stubs}
    for (mod, name), f in stubs.items():
        setattr(mod, name, f)
    try:
        yield
    finally:
        for (mod, name), f in saved.items():
            setattr(mod, name, f)


# JAX-package calls compiled as one program each: XLA's backend at
# optimisation level 0 compiles in about a third of the default's time to
# the same values (DenseNet-121's forward 1.5 s against the engine's 4.4;
# test_torch_nn_rest.py's functional rows 11 s against 28 s eagerly, where
# every op compiles per shape)
_O0 = {"xla_backend_optimization_level": 0}


@contextlib.contextmanager
def jax_jit_at_o0():
    """While open, every ``jax.jit`` made (the JAX package's engine makes
    its step so when first called) compiles at ``_O0``."""
    jit = jax.jit
    jax.jit = functools.partial(jit, compiler_options=_O0)
    try:
        yield
    finally:
        jax.jit = jit


def jax_values(out):
    """``out`` with its JAX-package tensors as their JAX arrays."""
    return jax.tree_util.tree_map(
        lambda t: t.value if isinstance(t, paddle.Tensor) else t, out,
        is_leaf=lambda t: isinstance(t, paddle.Tensor))


def jax_compiled(run, *xs):
    """``run`` (a function of JAX arrays, the JAX package's tape off)
    compiled at ``_O0`` for ``xs`` and called on them; numpy out."""
    from paddle_tpu.framework.core import no_grad_ctx

    def body(*a):
        with no_grad_ctx():
            return run(*a)

    program = jax.jit(body).lower(*xs).compile(compiler_options=_O0)
    return jax.tree_util.tree_map(np.asarray, program(*xs))


def _traced(args, kwargs):
    """(a function putting the program's inputs, as JAX-package tensors,
    in place of the numpy arrays among ``args`` and ``kwargs``' values,
    those arrays)."""
    slots = [(True, i) for i, a in enumerate(args)
             if isinstance(a, np.ndarray)]
    slots += [(False, k) for k, v in kwargs.items()
              if isinstance(v, np.ndarray)]

    def place(xs):
        a, kw = list(args), dict(kwargs)
        for (positional, key), x in zip(slots, xs):
            (a if positional else kw)[key] = paddle.Tensor(x)
        return a, kw

    return place, [args[k] if p else kwargs[k] for p, k in slots]


def jax_call(fn, args, kwargs=None):
    """``fn(*args, **kwargs)`` of the JAX package as one compiled program
    (see ``_O0``): the numpy arrays among the arguments enter as its
    inputs, everything else as it is. For a function that reads its
    inputs' values on the host, call it eagerly instead. Returns numpy in
    the result's structure."""
    place, xs = _traced(args, kwargs or {})

    def run(*xs):
        a, kw = place(xs)
        return jax_values(fn(*a, **kw))

    return jax_compiled(run, *xs)


def jax_grad(fn, args, kwargs=None, wrt=0):
    """The gradient of ``sum(fn(*args, **kwargs))`` for ``args[wrt]`` (a
    numpy array), compiled as :func:`jax_call` is."""
    place, xs = _traced(args, kwargs or {})
    k = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)].index(
        wrt)

    def total(x, *rest):
        a, kw = place(rest[:k] + (x,) + rest[k:])
        return jnp.sum(jax_values(fn(*a, **kw)))

    return jax_compiled(jax.grad(total), xs[k], *(xs[:k] + xs[k + 1:]))


def jax_forward(layer, *arrays):
    """``layer(*arrays)`` of a JAX-package layer in its current mode,
    compiled (see ``_O0``) over ``paddle_tpu.jit.functional_call``, the
    engine's own forward, with the layer's state as inputs. Its buffers
    are left as they were (a training forward's statistics are not
    written back). Returns numpy in the outputs' structure."""
    from paddle_tpu.jit import functional_call, state_values

    def run(values, *xs):
        return jax_values(functional_call(layer, values,
                                       *[paddle.Tensor(x) for x in xs]))

    return jax_compiled(run, state_values(layer), *arrays)


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
