"""The convolutional layer surface of the PyTorch port
(``nn/functional/{conv,pooling,norm,activation,loss}.py`` and the layers
over them) against the JAX package on the CPU, fp32, on the same numpy
inputs from a seed: every padding form and data format of the
convolutions and their transposed forms (outputs and input gradients),
the pooling flags (``ceil_mode``, ``exclusive``, string padding,
``return_mask``), the adaptive bins, batch / group / instance norm and the
BatchNorm running statistics, the activations and losses, AMP O1's cast
of a convolution, ``Linear`` / ``Embedding`` built through ``ParamAttr``,
and the options that raise NotImplementedError.

fp32 on both sides: the results differ only in summation order. TOL
holds the convolutions and norms (sums of up to ~500 products of O(1)
values); the selections (max pooling, its mask and its gradient) are
held exactly."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jF
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn import initializer as TI

TOL = dict(rtol=2e-5, atol=2e-5)
CPU = dict(device="cpu")


def _rng(seed=0):
    return np.random.RandomState(seed)


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().numpy(),
                               np.asarray(j_out.numpy()), **tol)


# ------------------------------------------------------------ convolutions
CONV_CASES = [
    # (n, padding, stride, dilation, groups, channel_last)
    (2, 1, 1, 1, 1, False), (2, [1, 2], 2, 1, 1, False),
    (2, [0, 1, 2, 0], 1, 1, 1, False), (2, [[1, 0], [0, 2]], 2, 1, 1, False),
    (2, "SAME", 2, 1, 1, False), (2, "same", 1, 2, 1, False),
    (2, "VALID", 2, 1, 2, False), (2, 1, 1, 1, 1, True), (2, [1], 2, 1, 1,
                                                          False),
    (2, "SAME", 2, 1, 2, True), (2, [0, 1, 1, 0], 2, 1, 1, True),
    (1, 2, 1, 1, 1, False), (1, [1, 0], 2, 1, 1, False),
    (1, "SAME", 2, 1, 1, True), (1, "VALID", 1, 2, 2, False),
    (3, 1, 1, 1, 1, False), (3, [1, 0, 0, 1, 1, 1], 2, 1, 1, True),
    (3, "SAME", 2, 1, 1, False)]


def _conv_inputs(n, groups, channel_last, rng):
    spatial = (9, 8, 7)[:n]
    x = rng.randn(2, 4, *spatial).astype("float32")
    if channel_last:
        x = np.moveaxis(x, 1, -1).copy()
    w = rng.randn(6, 4 // groups, *(3,) * n).astype("float32") * 0.3
    b = rng.randn(6).astype("float32")
    return x, w, b


@pytest.mark.parametrize("n,padding,stride,dilation,groups,cl", CONV_CASES)
def test_conv_every_padding_form_and_format(n, padding, stride, dilation,
                                            groups, cl):
    """Outputs, and the input's and weight's gradients of sum(out²)."""
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][cl]
    x, w, b = _conv_inputs(n, groups, cl, _rng(n))
    name = f"conv{n}d"
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    out = getattr(tF, name)(tx, tw, _t(b), stride, padding, dilation,
                            groups, fmt)
    (out ** 2).sum().backward()
    jx = paddle.to_tensor(x, stop_gradient=False)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jout = getattr(jF, name)(jx, jw, _j(b), stride, padding, dilation,
                             groups, fmt)
    (jout ** 2).sum().backward()
    _same(out, jout)
    _same(tx.grad, jx.grad, dict(rtol=1e-4, atol=1e-4))
    _same(tw.grad, jw.grad, dict(rtol=1e-4, atol=1e-3))


TRANSPOSE_CASES = [
    # (n, padding, stride, output_padding, dilation, groups, channel_last)
    (2, 0, 1, 0, 1, 1, False), (2, 1, 2, 1, 1, 1, False),
    (2, [1, 0], 2, 0, 2, 2, False), (2, [0, 1, 2, 0], 2, [1, 0], 1, 1, True),
    (2, [[1, 2], [0, 0]], 3, 2, 1, 1, False), (1, 1, 2, 1, 1, 2, False),
    (1, [2, 0], 1, 0, 1, 1, True), (3, 1, 2, 0, 1, 1, False),
    (3, [1, 0, 0, 1, 1, 1], 2, 1, 1, 1, True)]


@pytest.mark.parametrize("n,padding,stride,opad,dilation,groups,cl",
                         TRANSPOSE_CASES)
def test_conv_transpose_as_jax(n, padding, stride, opad, dilation, groups,
                               cl):
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][cl]
    rng = _rng(10 + n)
    x = rng.randn(2, 4, *(5, 4, 3)[:n]).astype("float32")
    if cl:
        x = np.moveaxis(x, 1, -1).copy()
    w = rng.randn(4, 6 // groups, *(3,) * n).astype("float32") * 0.3
    b = rng.randn(6).astype("float32")
    name = f"conv{n}d_transpose"
    tx = _t(x).requires_grad_()
    out = getattr(tF, name)(tx, _t(w), _t(b), stride, padding, opad, groups,
                            dilation, data_format=fmt)
    out.square().sum().backward()
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = getattr(jF, name)(jx, _j(w), _j(b), stride, padding, opad,
                             groups, dilation, data_format=fmt)
    jout.square().sum().backward()
    assert tuple(out.shape) == tuple(jout.shape)
    _same(out, jout)
    _same(tx.grad, jx.grad, dict(rtol=1e-4, atol=1e-4))


def test_conv_layers_default_init_and_forward():
    """``Uniform(-k, k)``, k = 1 / sqrt(in / groups · prod(kernel)), for
    the weight and the bias; the layer's forward is the functional's."""
    torch.manual_seed(0)
    conv = tnn.Conv2D(8, 16, 3, stride=2, padding="SAME", groups=2, **CPU)
    k = 1 / np.sqrt(4 * 9)
    for p in (conv.weight, conv.bias):
        assert p.abs().max() <= k and p.abs().max() > 0.9 * k
    x = torch.randn(1, 8, 9, 9)
    assert torch.equal(conv(x), tF.conv2d(x, conv.weight, conv.bias, 2,
                                          "SAME", 1, 2))
    t = tnn.Conv2DTranspose(4, 6, 3, stride=2, bias_attr=False, **CPU)
    assert tuple(t.weight.shape) == (4, 6, 3, 3) and t.bias is None
    assert tuple(t(torch.randn(1, 4, 5, 5)).shape) == (1, 6, 11, 11)


# ----------------------------------------------------------------- pooling
POOL_CASES = [
    # (n, kernel, stride, padding, ceil_mode, channel_last)
    (2, 3, 2, 1, False, False), (2, 3, 2, 1, True, False),
    (2, 2, None, 0, True, False), (2, [3, 2], [2, 1], [1, 0, 0, 1], True,
                                   False),
    (2, 3, 2, "SAME", False, False), (2, 3, 2, "VALID", True, False),
    (2, 3, 2, 1, True, True), (1, 3, 2, 1, True, False),
    (1, 2, 2, [0, 1], False, False), (3, 2, 2, 1, True, False),
    (3, 3, 2, "SAME", False, True)]


def _pool_input(n, cl, rng):
    x = rng.randn(2, 3, *(9, 8, 7)[:n]).astype("float32")
    return np.moveaxis(x, 1, -1).copy() if cl else x


def _fmt(n, cl):
    return {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
            3: ("NCDHW", "NDHWC")}[n][cl]


def _fmt_kw(n, cl):
    return {} if n == 1 else {"data_format": _fmt(n, cl)}


@pytest.mark.parametrize("n,k,s,p,ceil,cl", POOL_CASES)
def test_max_pool_and_mask_as_jax(n, k, s, p, ceil, cl):
    """Output and mask; the input gradient at ResNet's stem pool (3 / 2 /
    1), at ``ceil_mode``'s extended grid and under string padding."""
    x = _pool_input(n, cl, _rng(20 + n))
    name = f"max_pool{n}d"
    tx = _t(x).requires_grad_()
    out, mask = getattr(tF, name)(tx, k, s, p, True, ceil, **_fmt_kw(n, cl))
    jout, jmask = getattr(jF, name)(_j(x), k, s, p, True, ceil,
                                    **_fmt_kw(n, cl))
    _same(out, jout, dict(rtol=0, atol=0))
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask.numpy()))
    if (n, k, s, p) not in ((2, 3, 2, 1), (2, 3, 2, "SAME")):
        return
    out.sum().backward()               # each window's max gets its count
    jx = paddle.to_tensor(x, stop_gradient=False)
    getattr(jF, name)(jx, k, s, p, False, ceil, **_fmt_kw(n, cl)).sum() \
        .backward()
    _same(tx.grad, jx.grad, dict(rtol=0, atol=0))


@pytest.mark.parametrize(
    "n,k,s,p,ceil,cl,exclusive",
    [c + (True,) for c in POOL_CASES]
    # string padding divides by the whole window whatever ``exclusive``
    # says (the JAX package's rule): only numeric padding tells them apart
    + [c + (False,) for c in POOL_CASES if not isinstance(c[3], str)])
def test_avg_pool_as_jax(n, k, s, p, ceil, cl, exclusive):
    x = _pool_input(n, cl, _rng(30 + n))
    name = f"avg_pool{n}d"
    kw = _fmt_kw(n, cl)
    if n == 1:
        out = tF.avg_pool1d(_t(x), k, s, p, exclusive, ceil)
        jout = jF.avg_pool1d(_j(x), k, s, p, exclusive, ceil)
    else:
        out = getattr(tF, name)(_t(x), k, s, p, ceil, exclusive, **kw)
        jout = getattr(jF, name)(_j(x), k, s, p, ceil, exclusive, **kw)
    _same(out, jout)


@pytest.mark.parametrize("n,size", [(1, 4), (2, (3, 5)), (2, (None, 2)),
                                    (2, 1), (3, (2, 3, 1))])
@pytest.mark.parametrize("mode", ["avg", "max"])
def test_adaptive_pools_as_jax(n, size, mode):
    x = _pool_input(n, False, _rng(40 + n))
    name = f"adaptive_{mode}_pool{n}d"
    _same(getattr(tF, name)(_t(x), size), getattr(jF, name)(_j(x), size))


def test_adaptive_avg_pool_channel_last_and_its_layer():
    x = _pool_input(2, True, _rng(5))
    _same(tF.adaptive_avg_pool2d(_t(x), 3, "NHWC"),
          jF.adaptive_avg_pool2d(_j(x), 3, "NHWC"))
    x3 = _pool_input(3, True, _rng(5))
    _same(tF.adaptive_avg_pool3d(_t(x3), (2, 3, 1), "NDHWC"),
          jF.adaptive_avg_pool3d(_j(x3), (2, 3, 1), "NDHWC"))
    layer = tnn.AdaptiveAvgPool2D((1, 1))
    _same(layer(_t(_pool_input(2, False, _rng(6)))),
          jF.adaptive_avg_pool2d(_j(_pool_input(2, False, _rng(6))), (1, 1)))


def test_pools_take_padding_pairs_as_the_convolutions_do():
    """A list of n (low, high) pairs (the convolutions' form, which the
    JAX package's pools refuse) pads as its flat 2·n form, held to JAX's
    pools on that form."""
    x = _pool_input(2, False, _rng(7))
    pairs, flat = [[1, 0], [0, 1]], [1, 0, 0, 1]
    _same(tF.max_pool2d(_t(x), 3, 2, pairs),
          jF.max_pool2d(_j(x), 3, 2, flat), dict(rtol=0, atol=0))
    _same(tF.avg_pool2d(_t(x), 3, 2, pairs),
          jF.avg_pool2d(_j(x), 3, 2, flat))


def test_max_unpool2d_inverts_the_mask():
    x = _pool_input(2, False, _rng(7))[:, :, :8, :8].copy()
    out, mask = tF.max_pool2d(_t(x), 2, 2, 0, True)
    jout, jmask = jF.max_pool2d(_j(x), 2, 2, 0, True)
    _same(tF.max_unpool2d(out, mask, 2),
          jF.max_unpool2d(jout, jmask, 2), dict(rtol=0, atol=0))
    layer = tnn.MaxUnPool2D(2)
    assert torch.equal(layer(out, mask), tF.max_unpool2d(out, mask, 2))


# ------------------------------------------------------------------- norms
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training,use_global", [(True, None), (False, None),
                                                 (True, True),
                                                 (False, False)])
def test_batch_norm_and_its_running_statistics(fmt, training, use_global):
    rng = _rng(50)
    x = rng.randn(4, 3, 5, 6).astype("float32") * 2 + 1
    if fmt == "NHWC":
        x = np.moveaxis(x, 1, -1).copy()
    w, b = rng.randn(3).astype("float32"), rng.randn(3).astype("float32")
    rm, rv = rng.randn(3).astype("float32"), rng.rand(3).astype("float32")
    trm, trv = _t(rm.copy()), _t(rv.copy())
    jrm, jrv = _j(rm.copy()), _j(rv.copy())
    tx = _t(x).requires_grad_()
    out = tF.batch_norm(tx, trm, trv, _t(w), _t(b), training, 0.9, 1e-5,
                        fmt, use_global)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jF.batch_norm(jx, jrm, jrv, _j(w), _j(b), training, 0.9, 1e-5,
                         fmt, use_global)
    _same(out, jout)
    _same(trm, jrm)
    _same(trv, jrv)
    out.square().sum().backward()
    jout.square().sum().backward()
    _same(tx.grad, jx.grad, dict(rtol=1e-4, atol=1e-4))


def test_batch_norm_layer_momentum_is_the_old_statistics_weight():
    bn = tnn.BatchNorm2D(3, momentum=0.9, **CPU)
    jbn = paddle.nn.BatchNorm2D(3, momentum=0.9)
    x = _rng(51).randn(4, 3, 5, 5).astype("float32") * 3 + 2
    _same(bn(_t(x)), jbn(_j(x)))
    _same(bn._mean, jbn._mean)
    _same(bn._variance, jbn._variance)
    # 0.1 of the batch mean, the unbiased variance
    np.testing.assert_allclose(bn._mean.numpy(),
                               0.1 * x.mean((0, 2, 3)), rtol=1e-5)
    np.testing.assert_allclose(
        bn._variance.numpy(), 0.9 + 0.1 * x.var((0, 2, 3), ddof=1),
        rtol=1e-5)
    assert bn._mean.dtype == torch.float32
    assert set(bn.state_dict()) == set(jbn.state_dict())
    bn.eval()
    jbn.eval()
    _same(bn(_t(x)), jbn(_j(x)))


def test_batch_norm_computes_in_fp32_for_bf16_activations():
    """AMP's case: bf16 activations into a training BatchNorm with fp32
    weights and statistics, against the JAX package's ``batch_norm`` and
    ``BatchNorm2D`` on the same bf16 input, in both formats. Both compute
    in fp32 and round the output to bf16, so the outputs lie within one
    bf16 rounding (2^-8 of the largest), the fp32 running statistics
    within TOL, and the input's bf16 gradients within two roundings."""
    import ml_dtypes

    rng = _rng(52)
    for fmt in ("NCHW", "NHWC"):
        x = (rng.randn(4, 3, 5, 6) * 2 + 1).astype(ml_dtypes.bfloat16)
        if fmt == "NHWC":
            x = np.moveaxis(x, 1, -1).copy()
        w, b = rng.randn(3).astype("float32"), rng.randn(3).astype("float32")
        rm, rv = rng.randn(3).astype("float32"), rng.rand(3).astype("float32")
        g = rng.randn(*x.shape).astype("float32")
        trm, trv = _t(rm.copy()), _t(rv.copy())
        jrm, jrv = _j(rm.copy()), _j(rv.copy())
        tx = _t(x.astype("float32")).bfloat16().requires_grad_()
        out = tF.batch_norm(tx, trm, trv, _t(w), _t(b), True, 0.9, 1e-5,
                            fmt)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jout = jF.batch_norm(jx, jrm, jrv, _j(w), _j(b), True, 0.9, 1e-5,
                             fmt)
        assert out.dtype == torch.bfloat16 and str(jout.dtype) == "bfloat16"
        assert trm.dtype == trv.dtype == torch.float32
        jo = np.asarray(jout.numpy()).astype("float32")
        np.testing.assert_allclose(out.float().detach().numpy(), jo,
                                   rtol=0, atol=2 ** -8 * np.abs(jo).max())
        _same(trm, jrm)
        _same(trv, jrv)
        (out.float() * _t(g)).sum().backward()
        (jout.astype("float32") * _j(g)).sum().backward()
        assert tx.grad.dtype == torch.bfloat16
        jg = np.asarray(jx.grad.numpy()).astype("float32")
        np.testing.assert_allclose(tx.grad.float().numpy(), jg, rtol=0,
                                   atol=2 ** -7 * np.abs(jg).max())
        # the layers, their buffers fp32
        bn = tnn.BatchNorm2D(3, data_format=fmt, **CPU)
        jbn = paddle.nn.BatchNorm2D(3, data_format=fmt)
        lo = bn(_t(x.astype("float32")).bfloat16())
        jlo = np.asarray(jbn(_j(x)).numpy()).astype("float32")
        assert lo.dtype == torch.bfloat16 and bn._mean.dtype == torch.float32
        np.testing.assert_allclose(lo.float().detach().numpy(), jlo, rtol=0,
                                   atol=2 ** -8 * np.abs(jlo).max())
        _same(bn._mean, jbn._mean)
        _same(bn._variance, jbn._variance)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_as_jax(fmt):
    rng = _rng(53)
    x = rng.randn(2, 6, 4, 5).astype("float32")
    if fmt == "NHWC":
        x = np.moveaxis(x, 1, -1).copy()
    w, b = rng.randn(6).astype("float32"), rng.randn(6).astype("float32")
    _same(tF.group_norm(_t(x), 3, 1e-5, _t(w), _t(b), fmt),
          jF.group_norm(_j(x), 3, 1e-5, _j(w), _j(b), fmt))
    layer = tnn.GroupNorm(3, 6, data_format=fmt, **CPU)
    jl = paddle.nn.GroupNorm(3, 6, data_format=fmt)
    _same(layer(_t(x)), jl(_j(x)))


def test_instance_norm_normalize_and_lrn_as_jax():
    rng = _rng(54)
    x = rng.randn(2, 5, 4, 6).astype("float32")
    w, b = rng.randn(5).astype("float32"), rng.randn(5).astype("float32")
    _same(tF.instance_norm(_t(x), weight=_t(w), bias=_t(b)),
          jF.instance_norm(_j(x), weight=_j(w), bias=_j(b)))
    _same(tnn.InstanceNorm2D(5, **CPU)(_t(x)),
          paddle.nn.InstanceNorm2D(5)(_j(x)))
    for p, axis in ((2, 1), (1, -1), (3, 0)):
        _same(tF.normalize(_t(x), p, axis), jF.normalize(_j(x), p, axis))
    for size, fmt in ((3, "NCHW"), (4, "NHWC")):
        _same(tF.local_response_norm(_t(x), size, data_format=fmt),
              jF.local_response_norm(_j(x), size, data_format=fmt))
    _same(tnn.LocalResponseNorm(5)(_t(x)),
          paddle.nn.LocalResponseNorm(5)(_j(x)))


# -------------------------------------------------- activations and losses
ACTS = ["relu", "relu6", "sigmoid", "tanh", "silu", "mish", "hardswish",
        "hardsigmoid", "tanhshrink", "softsign", "log_sigmoid", "elu",
        "selu", "celu", "leaky_relu", "hardtanh", "hardshrink",
        "softshrink", "thresholded_relu", "softplus", "softmax",
        "log_softmax", "glu", "gelu"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_functions_as_jax(name):
    x = _rng(60).randn(3, 8).astype("float32") * 3
    _same(getattr(tF, name)(_t(x)), getattr(jF, name)(_j(x)),
          dict(rtol=1e-6, atol=1e-6))


def test_activation_layers_as_jax():
    x = _rng(61).randn(2, 4, 3, 3).astype("float32") * 2
    pairs = [(tnn.ReLU(), paddle.nn.ReLU()),
             (tnn.LeakyReLU(0.2), paddle.nn.LeakyReLU(0.2)),
             (tnn.GELU(True), paddle.nn.GELU(True)),
             (tnn.Softmax(1), paddle.nn.Softmax(1)),
             (tnn.Hardtanh(-0.5, 0.5), paddle.nn.Hardtanh(-0.5, 0.5)),
             (tnn.Softplus(2.0, 5.0), paddle.nn.Softplus(2.0, 5.0)),
             (tnn.Maxout(2), paddle.nn.Maxout(2)),
             (tnn.PReLU(4, 0.1, **CPU), paddle.nn.PReLU(4, 0.1)),
             (tnn.RReLU().eval(), paddle.nn.RReLU().eval())]
    for t, j in pairs:
        _same(t(_t(x)), j(_j(x)), dict(rtol=1e-6, atol=1e-6))
    r = tnn.RReLU()(_t(-np.ones((64,), np.float32)))
    assert (r <= -1 / 8).all() and (r >= -1 / 3).all()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_as_jax(reduction):
    rng = _rng(62)
    a, b = rng.randn(4, 5).astype("float32"), rng.randn(4, 5).astype(
        "float32")
    logp = np.log(np.abs(a) / np.abs(a).sum(1, keepdims=True))
    lbl = np.array([0, 4, -100, 2])
    w = rng.rand(5).astype("float32")
    for t, j in ((tnn.MSELoss(reduction), paddle.nn.MSELoss(reduction)),
                 (tnn.L1Loss(reduction), paddle.nn.L1Loss(reduction))):
        _same(t(_t(a), _t(b)), j(_j(a), _j(b)))
    _same(tnn.NLLLoss(reduction=reduction)(_t(logp), _t(lbl)),
          paddle.nn.NLLLoss(reduction=reduction)(_j(logp), _j(lbl)))
    _same(tF.nll_loss(_t(logp), _t(lbl), _t(w), reduction=reduction),
          jF.nll_loss(_j(logp), _j(lbl), _j(w), reduction=reduction))
    if reduction != "sum":
        _same(tnn.CrossEntropyLoss(reduction=reduction)(_t(a), _t(lbl)),
              paddle.nn.CrossEntropyLoss(reduction=reduction)(_j(a),
                                                              _j(lbl)))


# --------------------------------------------------------------------- AMP
@pytest.mark.parametrize("name", ["conv1d", "conv2d", "conv3d"])
def test_amp_o1_casts_convolutions_as_jax(name):
    n = int(name[4])
    x, w, b = _conv_inputs(n, 1, False, _rng(70))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        out = getattr(tF, name)(_t(x), _t(w), _t(b), 1, 1)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout = getattr(jF, name)(_j(x), _j(w), _j(b), 1, 1)
    assert out.dtype == torch.bfloat16
    assert np.dtype(jout.dtype).name == "bfloat16"
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.numpy()).astype(np.float32),
                               rtol=2e-2, atol=5e-2)
    with pt.amp.auto_cast(level="O1", custom_black_list=[name]):
        assert getattr(tF, name)(_t(x), _t(w), _t(b), 1, 1).dtype == \
            torch.float32


# ------------------------------------------------- Linear, Embedding attrs
def test_linear_through_param_attr_as_jax():
    wv = _rng(80).randn(4, 3).astype("float32")
    bv = _rng(81).randn(3).astype("float32")
    t = tnn.Linear(4, 3, weight_attr=pt.ParamAttr(
        initializer=TI.Assign(wv)), bias_attr=TI.Constant(0.5), **CPU)
    from paddle_tpu.nn import initializer as JI

    j = paddle.nn.Linear(4, 3, weight_attr=paddle.ParamAttr(
        initializer=JI.Assign(wv)), bias_attr=JI.Constant(0.5))
    x = _rng(82).randn(2, 4).astype("float32")
    _same(t(_t(x)), j(_j(x)))
    assert torch.equal(t.bias, torch.full((3,), 0.5))
    frozen = tnn.Linear(4, 3, weight_attr=pt.ParamAttr(trainable=False),
                        bias_attr=False, **CPU)
    assert not frozen.weight.trainable and frozen.bias is None
    del bv


def test_embedding_padding_idx_and_weight_attr_as_jax():
    wv = _rng(83).randn(10, 4).astype("float32")
    from paddle_tpu.nn import initializer as JI

    t = tnn.Embedding(10, 4, padding_idx=2, weight_attr=pt.ParamAttr(
        initializer=TI.Assign(wv)), **CPU)
    j = paddle.nn.Embedding(10, 4, padding_idx=2, weight_attr=paddle.
                            ParamAttr(initializer=JI.Assign(wv)))
    _same(t.weight, j.weight, dict(rtol=0, atol=0))
    assert not t.weight[2].any()
    ids = np.array([[1, 2, 3], [2, 9, 0]])
    out = t(_t(ids))
    _same(out, j(_j(ids)), dict(rtol=0, atol=0))
    out.sum().backward()
    assert not t.weight.grad[2].any() and t.weight.grad[1].any()
    with pytest.raises(NotImplementedError):
        tnn.Embedding(10, 4, sparse=True, **CPU)


# ----------------------------------------------------------- the refusals
@pytest.mark.parametrize("call", [
    lambda: tF.avg_pool2d(torch.zeros(1, 1, 4, 4), 2, divisor_override=3),
    lambda: tF.adaptive_max_pool2d(torch.zeros(1, 1, 4, 4), 2, True),
    lambda: tF.conv2d_transpose(torch.zeros(1, 2, 4, 4),
                                torch.zeros(2, 2, 3, 3), padding="SAME"),
    lambda: tF.conv2d_transpose(torch.zeros(1, 2, 4, 4),
                                torch.zeros(2, 2, 3, 3), output_size=[9, 9]),
    lambda: tF.conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3),
                      data_format="NCWH"),
    lambda: tF.conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3),
                      padding=[[0, 0], [0, 0], [1, 1], [1, 1]]),
    lambda: tF.max_pool2d(torch.zeros(1, 1, 4, 4), 2, data_format="NWHC"),
    lambda: tF.max_pool3d(torch.zeros(1, 1, 4, 4, 4), [2, 2]),
    lambda: tnn.Conv2D(2, 2, 3, padding_mode="reflect", **CPU),
    lambda: tnn.SyncBatchNorm(4),
    lambda: tnn.SyncBatchNorm.convert_sync_batchnorm(tnn.ReLU()),
    lambda: pt.vision.models.resnet18(pretrained=True, **CPU)],
    ids=["divisor_override", "adaptive_mask", "transpose_string",
         "transpose_output_size", "conv_format", "conv_batch_pads",
         "pool_format", "pool_cycled_list", "padding_mode", "sync_bn",
         "convert_sync_bn", "pretrained"])
def test_unported_options_raise(call):
    with pytest.raises(NotImplementedError):
        call()


def test_layers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnn.Conv2D(2, 2, 3), lambda: tnn.BatchNorm2D(2),
                 lambda: tnn.GroupNorm(1, 2), lambda: tnn.PReLU(),
                 lambda: tnn.Linear(2, 2), lambda: tnn.Embedding(4, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # a layer that makes no tensor needs no card
    assert tnn.Sequential(tnn.ReLU(), tnn.MaxPool2D(2)) is not None
