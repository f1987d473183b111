"""The framework core of the PyTorch port (``paddle_tpu_torch/framework``,
``nn/initializer``, ``nn/layer_base.py``, ``nn/layer/container.py`` and
``tensor/{creation,manipulation}.py``) against the JAX package on the
CPU: dtype names, the seed and generator state, the initializers (by
their statistics: the draws never equal ``jax.random``'s), ``ParamAttr``
and ``create_parameter``, ``to_tensor`` and the creation functions,
``no_grad`` / ``grad``, the shape subset, ``save`` / ``load`` both ways
with ``paddle_tpu.save`` / ``paddle_tpu.load``, and the ``Layer`` surface.
fp32; values that do not depend on a draw are held exactly."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import dtype as jdtype
from paddle_tpu.nn import initializer as JI
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import dtype as tdtype
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import ParallelEngine

CPU = dict(device="cpu")


# ------------------------------------------------------------------ dtypes
@pytest.mark.parametrize("name", sorted(jdtype._STR2DTYPE))
def test_dtype_names_map_as_in_the_jax_package(name):
    j = np.dtype(jdtype.convert_dtype(name)).name
    assert tdtype.dtype_name(tdtype.convert_dtype(name)) == j
    assert tdtype.convert_dtype(np.dtype(j) if j != "bfloat16"
                                else "bfloat16") == \
        tdtype.convert_dtype(name)
    assert tdtype.is_floating_point(name) == jdtype.is_floating_point(
        jdtype.convert_dtype(name))


def test_default_dtype_set_and_refused():
    assert pt.get_default_dtype() == torch.float32
    try:
        pt.set_default_dtype("float64")
        assert pt.zeros([2], **CPU).dtype == torch.float64
        with pytest.raises(TypeError):
            pt.set_default_dtype("int32")
        with pytest.raises(ValueError):
            tdtype.convert_dtype("float31")
    finally:
        pt.set_default_dtype("float32")


# ------------------------------------------------------------------ random
def test_seed_and_rng_state_round_trip():
    pt.seed(7)
    a = TI.Normal()([64], **CPU)
    state = pt.get_rng_state()
    b = TI.Normal()([64], **CPU)
    pt.set_rng_state(state)
    assert torch.equal(TI.Normal()([64], **CPU), b)
    pt.seed(7)
    assert torch.equal(TI.Normal()([64], **CPU), a)
    assert not torch.equal(a, b)


def test_generator_argument_draws_from_that_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = TI.Uniform()([32], generator=g1, **CPU)
    assert torch.equal(a, TI.Uniform()([32], generator=g2, **CPU))


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("shape", [[], [7], [64, 48], [16, 8, 3, 3],
                                   [4, 2, 3, 3, 3]])
def test_fan_in_out_and_gain_as_jax(shape):
    assert TI._fan_in_out(shape) == JI._fan_in_out(shape)
    for nl, a in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert TI.calculate_gain(nl, a) == JI.calculate_gain(nl, a)


SHAPE = [256, 64, 3, 3]                 # a conv kernel: fans 576 and 2304
FI, FO = 64 * 9, 256 * 9


@pytest.mark.parametrize("init,lo,hi,mean,std", [
    (TI.Uniform(-0.3, 0.5), -0.3, 0.5, 0.1, 0.8 / math.sqrt(12)),
    (TI.Normal(0.2, 0.05), None, None, 0.2, 0.05),
    (TI.TruncatedNormal(0.0, 1.0, -2.0, 2.0), -2.0, 2.0, 0.0, 0.8796),
    (TI.XavierUniform(), -math.sqrt(6 / (FI + FO)), math.sqrt(6 / (FI + FO)),
     0.0, math.sqrt(2 / (FI + FO))),
    (TI.XavierNormal(gain=2.0), None, None, 0.0,
     2.0 * math.sqrt(2 / (FI + FO))),
    (TI.KaimingUniform(), -math.sqrt(6 / FI), math.sqrt(6 / FI), 0.0,
     math.sqrt(2 / FI)),
    (TI.KaimingNormal(negative_slope=0.1, nonlinearity="leaky_relu"), None,
     None, 0.0, math.sqrt(2 / 1.01) / math.sqrt(FI)),
    # orthonormal columns of 256 * 64 * 3 rows
    (TI.Orthogonal(gain=1.5), None, None, 0.0,
     1.5 / math.sqrt(math.prod(SHAPE[:-1]))),
], ids=["uniform", "normal", "truncated", "xavier_u", "xavier_n",
        "kaiming_u", "kaiming_n", "orthogonal"])
def test_initializers_by_their_statistics(init, lo, hi, mean, std):
    """Bounds, mean and std of 147,456 draws (the mean within 5 standard
    errors, the std within 2 %), as the JAX package's formulas give
    them."""
    t = init(SHAPE, **CPU).double()
    n = t.numel()
    assert t.dtype == torch.float64 and tuple(t.shape) == tuple(SHAPE)
    if lo is not None:
        assert t.min() >= lo and t.max() <= hi
    assert abs(t.mean().item() - mean) < 5 * std / math.sqrt(n)
    assert abs(t.std().item() / std - 1) < 0.02


def test_orthogonal_rows_are_orthonormal():
    q = TI.Orthogonal()([32, 96], **CPU)
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(32), atol=1e-5)


def test_constant_assign_bilinear_dirac_exactly():
    assert torch.equal(TI.Constant(0.25)([3, 4], **CPU),
                       torch.full((3, 4), 0.25))
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert np.array_equal(TI.Assign(v)([3, 4], **CPU).numpy(), v)
    with pytest.raises(ValueError):
        TI.Assign(v)([4, 3], **CPU)
    np.testing.assert_array_equal(
        TI.Bilinear()([2, 2, 4, 4], **CPU).numpy(),
        np.asarray(JI.Bilinear()((2, 2, 4, 4))))
    d = TI.Dirac()([3, 3, 4, 4], **CPU)
    centre = d[1, 1]
    assert torch.count_nonzero(d) == torch.count_nonzero(centre)
    np.testing.assert_allclose((centre @ centre.T).numpy(), np.eye(4),
                               atol=1e-5)


def test_initializer_casts_and_defaults_to_the_card(monkeypatch):
    assert TI.Normal()([4], dtype="bfloat16", **CPU).dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.Normal()([4])


# ------------------------------------------------- ParamAttr, parameters
def test_param_attr_copy_matches_the_jax_one():
    from paddle_tpu.framework.param_attr import ParamAttr as JAttr

    for arg in (None, "w", TI.Constant(1.0), False):
        t, j = pt.ParamAttr._to_attr(arg), JAttr._to_attr(arg)
        if j is False:
            assert t is False
            continue
        assert (t.name, t.learning_rate, t.trainable) == \
            (j.name, j.learning_rate, j.trainable)


def test_create_parameter_honours_the_attr_and_the_global_initializer():
    layer = tnn.Layer(**CPU)
    p = layer.create_parameter([3, 2], attr=pt.ParamAttr(
        name="w0", initializer=TI.Constant(2.0), learning_rate=0.5,
        trainable=False))
    assert isinstance(p, pt.Parameter) and p.name == "w0"
    assert not p.trainable and p.stop_gradient and not p.requires_grad
    assert p.optimize_attr["learning_rate"] == 0.5
    assert torch.equal(p, torch.full((3, 2), 2.0))
    assert torch.equal(layer.create_parameter([2], is_bias=True),
                       torch.zeros(2))
    try:
        TI.set_global_initializer(TI.Constant(3.0), TI.Constant(4.0))
        assert torch.equal(layer.create_parameter([2]), torch.full((2,), 3.))
        assert torch.equal(layer.create_parameter([2], is_bias=True),
                           torch.full((2,), 4.0))
        # a layer's own default wins over the global one, as in JAX
        assert torch.equal(layer.create_parameter(
            [2], default_initializer=TI.Constant(5.0)), torch.full((2,), 5.))
    finally:
        TI.set_global_initializer(None)


def test_parameter_stop_gradient_is_the_inverse_of_requires_grad():
    p = pt.Parameter(torch.zeros(2), trainable=True, name="p")
    assert p.requires_grad and not p.stop_gradient
    p.stop_gradient = True
    assert not p.requires_grad and p.trainable     # trainable stays
    import copy
    import pickle

    for q in (copy.deepcopy(p), pickle.loads(pickle.dumps(p))):
        assert isinstance(q, pt.Parameter) and q.name == "p" and q.trainable


def test_trainable_false_is_left_bit_unchanged_by_the_engine():
    m = tnn.Sequential(
        tnn.Linear(4, 8, weight_attr=pt.ParamAttr(trainable=False), **CPU),
        tnn.ReLU(), tnn.Linear(8, 2, **CPU))
    frozen = m[0].weight.detach().clone()
    moved = m[2].weight.detach().clone()
    eng = ParallelEngine(m, optimizer=SGD(0.1, parameters=m.parameters()),
                         loss_fn=lambda out, y: (out - y).square().mean())
    for _ in range(2):
        eng.train_batch(torch.randn(6, 4), torch.randn(6, 2))
    assert torch.equal(m[0].weight, frozen)
    assert not torch.equal(m[2].weight, moved)


# ------------------------------------------------------ to_tensor, creation
@pytest.mark.parametrize("data", [1.5, 3, True, [1.0, 2.0], [[1, 2]],
                                  np.arange(4, dtype=np.float64),
                                  np.arange(4, dtype=np.int32),
                                  np.ones((2, 2), np.float16)],
                         ids=["float", "int", "bool", "floats", "ints",
                              "f64", "i32", "f16"])
def test_to_tensor_dtype_inference_as_jax(data):
    t, j = pt.to_tensor(data, **CPU), paddle.to_tensor(data)
    assert tdtype.dtype_name(t.dtype) == np.dtype(j.dtype).name
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    assert not t.requires_grad
    assert pt.to_tensor(data, dtype="float32", stop_gradient=False,
                        **CPU).requires_grad


def test_to_tensor_place_alias_and_default_device(monkeypatch):
    assert pt.to_tensor([1], place="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                 lambda: pt.arange(3), lambda: pt.eye(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("call", [
    ("zeros", ([2, 3],), {}), ("ones", ([2],), {"dtype": "int32"}),
    ("full", ([2], 7), {}), ("full", ([2], True), {}),
    ("full", ([2], 0.5), {}), ("arange", (5,), {}),
    ("arange", (0.0, 1.0, 0.25), {}), ("arange", (1, 10, 3), {}),
    ("linspace", (0.0, 1.0, 7), {}), ("eye", (3, 4), {}),
    ("empty", ([2],), {})], ids=lambda c: c[0] if isinstance(c, tuple)
    else str(c))
def test_creation_functions_as_jax(call):
    name, args, kw = call
    t = getattr(pt, name)(*args, **kw, **CPU)
    j = getattr(paddle, name)(*args, **kw)
    assert tdtype.dtype_name(t.dtype) == np.dtype(j.dtype).name
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=1e-6)


def test_functions_of_a_tensor_as_jax():
    x = np.random.RandomState(0).randn(4, 4).astype("float32")
    t, j = pt.to_tensor(x, **CPU), paddle.to_tensor(x)
    v = np.arange(3, dtype=np.float32)
    pairs = [
        (pt.zeros_like(t), paddle.zeros_like(j)),
        (pt.ones_like(t, dtype="int64"), paddle.ones_like(j, dtype="int64")),
        (pt.full_like(t, 2.5), paddle.full_like(j, 2.5)),
        (pt.tril(t, -1), paddle.tril(j, -1)), (pt.triu(t, 1),
                                               paddle.triu(j, 1)),
        (pt.diag(t, 1), paddle.diag(j, 1)),
        (pt.diag(pt.to_tensor(v, **CPU), 1, padding_value=9.0),
         paddle.diag(paddle.to_tensor(v), 1, padding_value=9.0)),
        (pt.assign(t), paddle.assign(j)), (pt.clone(t), paddle.clone(j)),
        (pt.assign(v, **CPU), paddle.assign(v))]
    for a, b in pairs:
        assert tdtype.dtype_name(a.dtype) == np.dtype(b.dtype).name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
    out = pt.zeros([4, 4], **CPU)
    assert pt.assign(t, output=out) is out and torch.equal(out, t)


# ------------------------------------------------------------ grad mode
def test_no_grad_as_context_and_decorator():
    w = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        assert not (w * 2).requires_grad and not pt.is_grad_enabled()
        with pt.enable_grad():
            assert (w * 2).requires_grad

    @pt.no_grad()
    def f(x):
        return x * 2

    assert not f(w).requires_grad and pt.is_grad_enabled()


def test_grad_matches_jax_and_leaves_dot_grad_alone():
    xv = np.array([0.5, -1.0, 2.0], np.float32)
    x = pt.to_tensor(xv, stop_gradient=False, **CPU)
    y = (x ** 3).sum() + (x * x)              # non-scalar: ones, as JAX
    (g,) = pt.grad(y, x)
    jx = paddle.to_tensor(xv, stop_gradient=False)
    jy = (jx ** 3).sum() + (jx * jx)
    (jg,) = paddle.grad(jy, jx)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg.numpy()), rtol=1e-6)
    assert x.grad is None
    z = pt.to_tensor(xv, stop_gradient=False, **CPU)
    with pytest.raises(RuntimeError):
        pt.grad((x * 2).sum(), [x, z])
    assert pt.grad((x * 2).sum(), [x, z], allow_unused=True)[1] is None


# ---------------------------------------------------------- shape subset
def test_shape_functions_as_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 1, 3, 4)
    t, j = pt.to_tensor(x, **CPU), paddle.to_tensor(x)
    cases = [
        (pt.flatten(t, 1), paddle.flatten(j, 1)),
        (pt.flatten(t, 1, 2), paddle.flatten(j, 1, 2)),
        (pt.reshape(t, [4, -1]), paddle.reshape(j, [4, -1])),
        (pt.transpose(t, [3, 0, 2, 1]), paddle.transpose(j, [3, 0, 2, 1])),
        (pt.squeeze(t), paddle.squeeze(j)),
        (pt.squeeze(t, [0, 1]), paddle.squeeze(j, [0, 1])),
        (pt.unsqueeze(t, [0, 5]), paddle.unsqueeze(j, [0, 5])),
        (pt.concat([t, t], axis=2), paddle.concat([j, j], axis=2)),
        (pt.stack([t, t], axis=1), paddle.stack([j, j], axis=1))]
    for a, b in cases:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
    for sections in (2, [1, -1, 2]):
        a = pt.split(t, sections, axis=3)
        b = paddle.split(j, sections, axis=3)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v.numpy()))
    with pytest.raises(ValueError):
        pt.split(t, 3, axis=3)


def test_unported_tensor_functions_raise_not_implemented():
    """Every ``paddle.tensor`` function is ported now: none is left to
    raise NotImplementedError, and a name the JAX package does not have
    raises AttributeError."""
    import paddle_tpu.tensor as jt
    import paddle_tpu_torch.tensor as tt

    assert not hasattr(tt, "_UNPORTED")
    assert callable(tt.matmul) and hasattr(jt, "matmul")
    with pytest.raises(AttributeError):
        tt.no_such_function


# ------------------------------------------------------------- save / load
def _model_pair():
    t = tnn.Sequential(tnn.Linear(3, 4, **CPU), tnn.BatchNorm1D(4, **CPU))
    return t


def test_save_then_jax_load(tmp_path):
    t = _model_pair()
    sd = t.state_dict()
    obj = {"model": sd, "step": 3, "lr": [0.1, (2, "x")],
           "p": t[0].weight}
    path = str(tmp_path / "port.pdparams")
    pt.save(obj, path)
    back = paddle.load(path)
    assert back["step"] == 3 and back["lr"] == [0.1, (2, "x")]
    assert list(back["model"]) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back["model"][k].numpy()),
                                      v.numpy())
    assert isinstance(back["p"], paddle.Parameter)
    assert paddle.load(path, return_numpy=True)["model"]["1._mean"].dtype \
        == np.float32


def test_jax_save_then_load(tmp_path):
    jm = paddle.nn.Sequential(paddle.nn.Linear(3, 4),
                              paddle.nn.BatchNorm1D(4))
    sd = jm.state_dict()
    path = str(tmp_path / "jax.pdparams")
    paddle.save({"model": sd, "epoch": 2}, path)
    back = pt.load(path, **CPU)
    assert back["epoch"] == 2 and list(back["model"]) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back["model"][k].detach().numpy(),
                                      np.asarray(v.numpy()))
    assert isinstance(back["model"]["0.weight"], pt.Parameter)
    t = _model_pair()
    missing, unexpected = t.set_state_dict(back["model"])
    assert not missing and not unexpected
    np.testing.assert_array_equal(t[0].weight.detach().numpy(),
                                  np.asarray(sd["0.weight"].numpy()))
    assert pt.load(path, return_numpy=True)["model"]["0.bias"].dtype \
        == np.float32


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "x.pdparams")
    pt.save({"a": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.load(path)
    assert pt.load(path, return_numpy=True)["a"].tolist() == [1.0, 1.0]


# -------------------------------------------------------------- the Layer
def test_parameter_order_names_and_sublayers_as_jax():
    jm = paddle.nn.Sequential(
        ("a", paddle.nn.Linear(2, 3)),
        ("b", paddle.nn.Sequential(paddle.nn.BatchNorm1D(3),
                                   paddle.nn.Linear(3, 1))))
    tm = tnn.Sequential(
        ("a", tnn.Linear(2, 3, **CPU)),
        ("b", tnn.Sequential(tnn.BatchNorm1D(3, **CPU),
                             tnn.Linear(3, 1, **CPU))))
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert set(tm.state_dict()) == set(jm.state_dict())
    assert isinstance(tm.parameters(), list) and len(tm.parameters()) == 6
    assert len(tm.parameters(include_sublayers=False)) == 0
    # JAX's sublayers() includes the layer itself at the empty prefix;
    # the port's, as Paddle's, does not
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()][1:]
    assert len(tm.sublayers(include_self=True)) == len(tm.sublayers()) + 1


def test_set_state_dict_in_place_with_missing_unexpected_and_shapes():
    t = _model_pair()
    w = t[0].weight
    ptr = w.data_ptr()
    missing, unexpected = t.set_state_dict(
        {"0.weight": np.ones((3, 4), np.float64), "zzz": np.zeros(1)})
    assert t[0].weight is w and w.data_ptr() == ptr
    assert torch.equal(w, torch.ones(3, 4)) and w.dtype == torch.float32
    assert unexpected == ["zzz"] and "0.bias" in missing
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_state_dict({"0.weight": np.ones((4, 3))})
    assert t.load_dict is not None and t.set_dict is not None


def test_buffers_persistable_and_train_eval():
    layer = tnn.Layer(**CPU)
    layer.register_buffer("kept", torch.zeros(2))
    layer.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert list(layer.state_dict()) == ["kept"]
    assert len(layer.buffers()) == 2
    m = _model_pair()
    m.eval()
    assert not any(s.training for s in m.sublayers())
    m.train()
    assert all(s.training for s in m.sublayers())


def test_forward_hooks_and_their_removal():
    lin = tnn.Linear(2, 2, bias_attr=False,
                     weight_attr=pt.ParamAttr(initializer=TI.Assign(
                         np.eye(2, dtype=np.float32))), **CPU)
    pre = lin.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2,))
    post = lin.register_forward_post_hook(lambda layer, inp, out: out + 1)
    x = torch.ones(1, 2)
    assert torch.equal(lin(x), torch.full((1, 2), 3.0))
    pre.remove()
    post.remove()
    assert torch.equal(lin(x), x)


def test_astype_to_and_clear_gradients():
    m = _model_pair()
    m.astype("bfloat16")
    assert m[0].weight.dtype == torch.bfloat16
    assert isinstance(m[0].weight, pt.Parameter)
    m.to(dtype="float32", place="cpu", blocking=True)
    assert m[0].weight.dtype == torch.float32 and m._dtype == torch.float32
    m(torch.randn(4, 3)).sum().backward()
    assert m[0].weight.grad is not None
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())


def test_containers():
    a, b, c = (tnn.Linear(2, 2, **CPU) for _ in range(3))
    seq = tnn.Sequential(a, b)
    assert seq[0] is a and seq[-1] is b and len(seq[1:]) == 1
    assert list(tnn.Sequential(("x", a), ("y", b))._modules) == ["x", "y"]
    assert list(tnn.Sequential([("x", a), ("y", b)])._modules) == ["x", "y"]
    ll = tnn.LayerList([a])
    ll.append(b)
    ll.insert(0, c)
    assert list(ll) == [c, a, b] and ll[-1] is b and len(ll) == 3
    ll.extend([a])
    assert len(ll) == 4
    ld = tnn.LayerDict({"a": a})
    ld["b"] = b
    assert list(ld.keys()) == ["a", "b"] and "b" in ld
    assert ld.pop("a") is a and len(ld) == 1
    pl = tnn.ParameterList([a.weight])
    pl.append(b.weight)
    assert len(pl) == 2 and pl[1] is b.weight
    assert len(tnn.Sequential(a, tnn.Sequential(b, a)).parameters()) == 4
