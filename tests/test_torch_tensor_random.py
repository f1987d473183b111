"""``paddle_tpu_torch/tensor/random.py`` against
``paddle_tpu/tensor/random.py`` on the CPU. The port keeps the JAX
package's distributions, not its streams (it draws from the devices'
``torch.Generator``s), so no draw is held to a JAX draw. Each function
gives the JAX package's shape and dtype on the same call; a large draw's
mean and variance lie within 6 standard errors of the distribution's
(of the mean: sigma / sqrt(n); of the variance: sqrt(mu4 - sigma^4) /
sqrt(n), from the distribution's fourth central moment); ``paddle.seed``
repeats a draw bit for bit, and a ``seed=`` argument gives a draw of its
own that repeats."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_tensor_parity import dtype_name, host

N = 40000
K = 6.0
CPU = dict(device="cpu")
SHAPE = [3, 4]


def _t(v, dtype=torch.float32):
    return torch.full([N], v, dtype=dtype)


# (id, the port's large draw, mean, variance, fourth central moment)
def _uniform(a, b):
    w = b - a
    return (a + b) / 2, w * w / 12, w ** 4 / 80


def _normal(m, s):
    return m, s * s, 3 * s ** 4


def _bernoulli(p):
    return p, p * (1 - p), p * (1 - p) * (1 - 3 * p * (1 - p))


def _poisson(lam):
    return lam, lam, lam * (1 + 3 * lam)


def _gamma(k):
    return k, k, 3 * k * (k + 2)


def _exponential(lam):
    return 1 / lam, 1 / lam ** 2, 9 / lam ** 4


def _binomial(n, p):
    q = 1 - p
    return n * p, n * p * q, n * p * q * (1 + 3 * (n - 2) * p * q)


def _discrete_uniform(lo, hi):
    k = hi - lo
    var = (k * k - 1) / 12
    mu4 = (k * k - 1) * (3 * k * k - 7) / 240
    return (lo + hi - 1) / 2, var, mu4


MOMENT_ROWS = [
    ("rand", lambda: pt.rand([N], **CPU), _uniform(0, 1)),
    ("uniform", lambda: pt.uniform([N], min=-2.0, max=3.0, **CPU),
     _uniform(-2, 3)),
    ("uniform_seed", lambda: pt.uniform([N], min=0.0, max=1.0, seed=11,
                                        **CPU), _uniform(0, 1)),
    ("uniform_", lambda: pt.uniform_(torch.empty(N), -1.0, 1.0),
     _uniform(-1, 1)),
    ("randn", lambda: pt.randn([N], **CPU), _normal(0, 1)),
    ("standard_normal", lambda: pt.standard_normal([N], **CPU),
     _normal(0, 1)),
    ("gaussian", lambda: pt.gaussian([N], mean=1.0, std=2.0, **CPU),
     _normal(1, 2)),
    ("gaussian_seed", lambda: pt.gaussian([N], mean=-1.0, std=0.5, seed=3,
                                          **CPU), _normal(-1, 0.5)),
    ("normal", lambda: pt.normal(2.0, 3.0, [N], **CPU), _normal(2, 3)),
    ("normal_tensors", lambda: pt.normal(_t(1.0), _t(0.5)),
     _normal(1, 0.5)),
    ("normal_", lambda: pt.normal_(torch.empty(N), 0.5, 2.0),
     _normal(0.5, 2)),
    ("bernoulli", lambda: pt.bernoulli(_t(0.3)), _bernoulli(0.3)),
    ("bernoulli_", lambda: pt.bernoulli_(torch.empty(N), 0.7),
     _bernoulli(0.7)),
    ("poisson", lambda: pt.poisson(_t(3.0)), _poisson(3.0)),
    ("standard_gamma", lambda: pt.standard_gamma(_t(2.5)), _gamma(2.5)),
    ("exponential_", lambda: pt.exponential_(torch.empty(N), 2.0),
     _exponential(2.0)),
    ("binomial", lambda: pt.binomial(_t(10, torch.int64), _t(0.4)),
     _binomial(10, 0.4)),
    ("randint", lambda: pt.randint(-3, 5, [N], **CPU),
     _discrete_uniform(-3, 5)),
    ("randint_like", lambda: pt.randint_like(torch.empty(N), 2, 9),
     _discrete_uniform(2, 9)),
    ("multinomial", lambda: pt.multinomial(torch.tensor(
        [0.2, 0.3, 0.5]), N, replacement=False), None),
]


@pytest.mark.parametrize("row", MOMENT_ROWS, ids=[r[0] for r in MOMENT_ROWS])
def test_moments_within_standard_errors(row):
    name, draw, moments = row
    pt.seed(2024)
    v = draw().double()
    assert v.numel() == N
    if name == "multinomial":
        # the categories' frequencies, each a Bernoulli mean
        for c, p in enumerate((0.2, 0.3, 0.5)):
            f = (v == c).double().mean().item()
            assert abs(f - p) <= K * math.sqrt(p * (1 - p) / N), (c, f)
        return
    mean, var, mu4 = moments
    m, s2 = v.mean().item(), v.var(correction=0).item()
    assert abs(m - mean) <= K * math.sqrt(var / N), (m, mean)
    assert abs(s2 - var) <= K * math.sqrt((mu4 - var * var) / N), (s2, var)


# the same call in both packages: the JAX package's shape and dtype
SHAPE_ROWS = [
    ("rand", (SHAPE,), {}), ("rand_f64", (SHAPE, "float64"), {}),
    ("uniform", (SHAPE,), dict(min=0.0, max=2.0)),
    ("uniform_seed", (SHAPE,), dict(seed=5)),
    ("randn", (SHAPE,), {}), ("standard_normal", (SHAPE,), {}),
    ("gaussian", (SHAPE,), dict(mean=1.0, std=2.0, seed=7)),
    ("normal", (0.0, 1.0, SHAPE), {}),
    ("randint", (0, 7, SHAPE), {}), ("randint_i32", (-2, 2, SHAPE, "int32"),
                                     {}),
    ("randperm", (9,), {}), ("randperm_i32", (9, "int32"), {}),
]


@pytest.mark.parametrize("row", SHAPE_ROWS, ids=[r[0] for r in SHAPE_ROWS])
def test_shapes_and_dtypes_match_jax(row):
    name, args, kwargs = row
    fn = name.split("_")[0] if name not in ("standard_normal",) else name
    j = getattr(paddle, fn)(*args, **kwargs)
    t = getattr(pt, fn)(*args, **kwargs, **CPU)
    assert list(t.shape) == list(j.shape) and dtype_name(t) == dtype_name(j)
    if fn == "randperm":
        assert sorted(t.tolist()) == list(range(9))


# (id, the draw, the port's dtype where it differs by rule: JAX's gamma
# draws in its default float, float64 under the 64-bit test setting; the
# port's in alpha's dtype)
TENSOR_ROWS = [
    ("bernoulli", lambda m, a: m.bernoulli(a), None),
    ("poisson", lambda m, a: m.poisson(a * 4), None),
    ("standard_gamma", lambda m, a: m.standard_gamma(a + 1), "float32"),
    ("multinomial", lambda m, a: m.multinomial(a, 3), None),
    ("randint_like", lambda m, a: m.randint_like(a, 0, 5), None),
    ("uniform_", lambda m, a: m.uniform_(a), None),
    ("normal_", lambda m, a: m.normal_(a), None),
    ("exponential_", lambda m, a: m.exponential_(a), None),
    ("bernoulli_", lambda m, a: m.bernoulli_(a, 0.5), None),
]


@pytest.mark.parametrize("row", TENSOR_ROWS, ids=[r[0] for r in TENSOR_ROWS])
def test_draws_of_a_tensor_match_jax_shapes_and_dtypes(row):
    _, f, dtype = row
    a = np.random.RandomState(1).rand(3, 4).astype("float32") * 0.8 + 0.1
    j = f(paddle, paddle.to_tensor(a))
    t = f(pt, torch.from_numpy(a.copy()))
    assert list(t.shape) == list(j.shape)
    assert dtype_name(t) == (dtype or dtype_name(j))
    assert np.isfinite(host(t)).all()


def test_binomial_matches_jax_dtype():
    j = paddle.binomial(paddle.to_tensor(np.full([5], 6, "int64")),
                        paddle.to_tensor(np.full([5], 0.5, "float32")))
    t = pt.binomial(torch.full([5], 6), torch.full([5], 0.5))
    assert dtype_name(t) == dtype_name(j) == "int64"
    assert ((t >= 0) & (t <= 6)).all()


def test_seed_repeats_a_draw_bit_for_bit():
    def draws():
        return [pt.rand([64], **CPU), pt.randn([64], **CPU),
                pt.randint(0, 100, [64], **CPU),
                pt.randperm(64, **CPU), pt.bernoulli(torch.full([64], .5)),
                pt.multinomial(torch.ones(5), 8),
                pt.normal(0.0, 1.0, [64], **CPU)]

    pt.seed(123)
    a = draws()
    pt.seed(123)
    b = draws()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pt.seed(124)
    assert not torch.equal(draws()[0], a[0])


def test_a_seed_argument_gives_its_own_repeatable_draw():
    a = pt.uniform([32], seed=9, **CPU)
    b = pt.uniform([32], seed=9, **CPU)
    c = pt.uniform([32], seed=10, **CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(pt.gaussian([32], seed=4, **CPU),
                       pt.gaussian([32], seed=4, **CPU))
    # a seeded draw leaves the default generator's stream alone
    pt.seed(5)
    x = pt.rand([8], **CPU)
    pt.seed(5)
    pt.uniform([8], seed=77, **CPU)
    assert torch.equal(pt.rand([8], **CPU), x)


def test_draws_made_from_nothing_default_to_the_card():
    for fn in (lambda: pt.rand([2]), lambda: pt.randn([2]),
               lambda: pt.randint(0, 3, [2]), lambda: pt.randperm(3)):
        if torch.cuda.is_available():
            assert fn().is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
