"""The rest of ``nn`` in the PyTorch port (``paddle_tpu_torch/nn/
{functional/{common,loss,extras},layer/{common,loss,extras},utils}``)
against the JAX package on the CPU, fp32, on the same seeded numpy
inputs: one small shape per op family.

- ``interpolate`` in every mode, up and down, at 3, 4 and 5 dimensions
  (the JAX package's resize rule: half-pixel nearest, antialiased linear
  and cubic when shrinking, its own lerp under ``align_corners``);
- ``ctc_loss`` in each reduction, with a row that stops before the last
  step and an infeasible row (JAX's 1e30), and its gradient;
- ``rnnt_loss`` and its gradient, ``sparse_attention`` over a CSR mask;
- every other functional op, loss and layer of those files, the in-place
  activations and ``nn.utils``.

Tolerances: fp32 arithmetic in another order, rtol 1e-5 / atol 1e-6
(``F32``); ops that sum many terms or differentiate through a loop
(ctc, rnnt, their gradients; antialiased resizes) rtol 1e-4 / atol 1e-5
(``LOOSE``): the two packages' fp32 sums round in another order. The
random ops (dropouts, ``gumbel_softmax``) draw from PyTorch's generator,
never JAX's stream: they are held to the JAX package where it is
deterministic (outside training, p = 0) and by their rule otherwise."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.utils as jutils
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.utils as tutils
from torch_tensor_parity import (F32, assert_same, host, jax_call,
                                 jax_forward, jax_grad, jax_host_init, jx,
                                 tx)

LOOSE = dict(rtol=1e-4, atol=1e-5)
R = np.random.RandomState(22)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _u(*shape):
    return R.uniform(0.05, 0.95, shape).astype("float32")


def _i(high, *shape, low=0):
    return R.randint(low, high, shape).astype("int64")


X3 = _f(2, 3, 7)
X4 = _f(2, 3, 7, 6)
X5 = _f(1, 2, 4, 5, 6)
X4L = _f(2, 4, 6, 6)                     # for shuffles and padding
X4C = _f(2, 6, 6, 8)                     # channel-last shuffles
Z = _f(4, 5)
P = _u(4, 5)
T01 = (R.rand(4, 5) > 0.5).astype("float32")
PM1 = np.where(R.rand(4) > 0.5, 1.0, -1.0).astype("float32")
LBL = _i(5, 4)

# ctc: T = 6, B = 3, C = 5, L = 3; row 1 stops after 4 steps, row 2
# cannot emit its 3 labels (2 repeats need blanks) in 3 steps: 1e30
CTC_LP = _f(6, 3, 5)
CTC_LBL = np.array([[1, 2, 3], [2, 2, 4], [3, 3, 3]], "int64")
CTC_IN = np.array([6, 4, 3], "int64")
CTC_LEN = np.array([3, 2, 3], "int64")

# rnnt: B = 2, T = 4, U = 2, V = 4
RNNT_LOGITS = _f(2, 4, 3, 4)
RNNT_LBL = np.array([[1, 2], [3, 1]], "int32")
RNNT_T = np.array([4, 3], "int32")
RNNT_U = np.array([2, 1], "int32")


def _csr(S, rng):
    """A causal band of width 3 as CSR (B = 1, H = 2)."""
    offs, cols = [], []
    for h in range(2):
        o, c = [0], []
        for s in range(S):
            allowed = [t for t in range(max(0, s - 2 - h), s + 1)]
            c += allowed
            o.append(len(c))
        offs.append(o)
        cols.append(c)
    n = max(len(c) for c in cols)
    cols = [c + [0] * (n - len(c)) for c in cols]
    return (np.array([offs], "int32"), np.array([cols], "int32"))


CSR_OFF, CSR_COL = _csr(5, R)
THETA = (np.eye(2, 3)[None] + 0.1 * R.randn(2, 2, 3)).astype("float32")
GRID = R.uniform(-1.2, 1.2, (2, 3, 4, 2)).astype("float32")

# (name, args, kwargs, tol)
FUNCTIONAL = [
    # interpolate: every mode, up and down, 3-, 4- and 5-D
    ("nearest_up_4d", "interpolate", (X4,), dict(size=[14, 12]), F32),
    ("nearest_x4", "interpolate", (X4,), dict(scale_factor=4), F32),
    ("nearest_down_5_to_3", "interpolate", (X4,), dict(size=[3, 4]), F32),
    ("nearest_down_whole", "interpolate", (X4L,), dict(size=[3, 2]), F32),
    ("nearest_3d", "interpolate", (X3,), dict(size=[10],
                                              data_format="NCW"), F32),
    ("nearest_5d", "interpolate", (X5,), dict(size=[3, 7, 4],
                                              data_format="NCDHW"), F32),
    ("bilinear_up", "interpolate", (X4,), dict(size=[7, 9],
                                               mode="bilinear"), LOOSE),
    ("bilinear_down", "interpolate", (X4,), dict(size=[3, 4],
                                                 mode="bilinear"), LOOSE),
    ("bilinear_nhwc", "interpolate", (X4L,), dict(
        size=[4, 9], mode="bilinear", data_format="NHWC"), LOOSE),
    ("bilinear_align", "interpolate", (X4,), dict(
        size=[11, 4], mode="bilinear", align_corners=True), F32),
    ("bicubic_up", "interpolate", (X4,), dict(size=[12, 11],
                                              mode="bicubic"), LOOSE),
    ("bicubic_down", "interpolate", (X4,), dict(size=[3, 4],
                                                mode="bicubic"), LOOSE),
    ("bicubic_align", "interpolate", (X4,), dict(
        size=[5, 9], mode="bicubic", align_corners=True), F32),
    ("linear_up_3d", "interpolate", (X3,), dict(
        size=[12], mode="linear", data_format="NCW"), LOOSE),
    ("linear_down_3d", "interpolate", (X3,), dict(
        size=[4], mode="linear", data_format="NCW"), LOOSE),
    ("trilinear_up_down", "interpolate", (X5,), dict(
        size=[6, 3, 9], mode="trilinear", data_format="NCDHW"), LOOSE),
    ("trilinear_align", "interpolate", (X5,), dict(
        size=[6, 3, 9], mode="trilinear", align_corners=True,
        data_format="NCDHW"), F32),
    ("area_down", "interpolate", (X4,), dict(size=[3, 3], mode="area"),
     LOOSE),
    ("upsample", "upsample", (X4,), dict(scale_factor=2), F32),
    # pad
    ("pad_constant", "pad", (X4,), dict(pad=[1, 2, 0, 3], value=0.5), F32),
    ("pad_reflect", "pad", (X4,), dict(pad=[2, 1, 3, 2],
                                       mode="reflect"), F32),
    ("pad_replicate", "pad", (X4,), dict(pad=[2, 1, 3, 2],
                                         mode="replicate"), F32),
    ("pad_circular", "pad", (X4,), dict(pad=[2, 1, 3, 2],
                                        mode="circular"), F32),
    ("pad_full", "pad", (X3,), dict(pad=[0, 1, 2, 0, 1, 1]), F32),
    ("pad_nhwc", "pad", (X4L,), dict(pad=[1, 0, 2, 1], mode="reflect",
                                     data_format="NHWC"), F32),
    ("zeropad2d", "zeropad2d", (X4,), dict(padding=[1, 1, 2, 0]), F32),
    # shuffles, unfold / fold
    ("pixel_shuffle", "pixel_shuffle", (X4L,), dict(upscale_factor=2), F32),
    ("pixel_shuffle_nhwc", "pixel_shuffle", (X4C,), dict(
        upscale_factor=2, data_format="NHWC"), F32),
    ("pixel_unshuffle", "pixel_unshuffle", (X4L,), dict(
        downscale_factor=2), F32),
    ("pixel_unshuffle_nhwc", "pixel_unshuffle", (X4C,), dict(
        downscale_factor=3, data_format="NHWC"), F32),
    ("channel_shuffle", "channel_shuffle", (X4L,), dict(groups=2), F32),
    ("channel_shuffle_nhwc", "channel_shuffle", (X4L,), dict(
        groups=3, data_format="NHWC"), F32),
    ("unfold", "unfold", (X4,), dict(kernel_sizes=[2, 3], strides=[1, 2],
                                     paddings=[1, 0, 0, 2]), F32),
    ("fold", "fold", (_f(2, 12, 15),), dict(
        output_sizes=[5, 6], kernel_sizes=2, strides=[2, 1],
        paddings=[1, 0]), F32),
    # the rest of common
    ("cosine_similarity", "cosine_similarity", (Z, _f(4, 5)), dict(axis=1),
     F32),
    ("bilinear", "bilinear", (_f(3, 4), _f(3, 5), _f(2, 4, 5), _f(2)), {},
     F32),
    ("embedding_padding", "embedding", (_i(6, 2, 3), _f(6, 4)),
     dict(padding_idx=2), F32),
    ("one_hot", "one_hot", (_i(5, 3, 2),), dict(num_classes=5), F32),
    ("label_smooth", "label_smooth", (T01,), dict(epsilon=0.2), F32),
    ("label_smooth_prior", "label_smooth", (T01, _u(1, 5)),
     dict(epsilon=0.1), F32),
    ("sequence_mask", "sequence_mask", (np.array([3, 0, 5], "int64"),),
     dict(maxlen=6), F32),
    ("sequence_mask_host_width", "sequence_mask",
     (np.array([3, 1, 4], "int64"),), dict(dtype="float32"), F32),
    ("temporal_shift", "temporal_shift", (_f(6, 8, 2, 2),),
     dict(seg_num=3, shift_ratio=0.25), F32),
    ("dropout_eval", "dropout", (Z,), dict(p=0.4, training=False), F32),
    ("dropout2d_p0", "dropout2d", (X4,), dict(p=0.0), F32),
    ("dropout3d_eval", "dropout3d", (X5,), dict(p=0.3, training=False),
     F32),
    ("alpha_dropout_eval", "alpha_dropout", (Z,), dict(
        p=0.3, training=False), F32),
    # losses
    ("cross_entropy_weight", "cross_entropy", (Z, LBL), dict(
        weight=_u(5), reduction="mean"), F32),
    ("cross_entropy_ignore_sum", "cross_entropy", (Z, np.array(
        [1, -100, 3, 4], "int64")), dict(reduction="sum"), F32),
    ("cross_entropy_soft", "cross_entropy", (Z, P / P.sum(1, keepdims=True)),
     dict(soft_label=True), F32),
    ("cross_entropy_smooth", "cross_entropy", (Z, LBL), dict(
        label_smoothing=0.1, reduction="none"), F32),
    ("cross_entropy_probs", "cross_entropy", (P, LBL[:, None]), dict(
        use_softmax=False), F32),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     (Z, LBL[:, None]), dict(return_softmax=True), F32),
    ("nll_weight", "nll_loss", (np.log(P), LBL), dict(weight=_u(5)), F32),
    ("mse_sum", "mse_loss", (Z, P), dict(reduction="sum"), F32),
    ("l1_none", "l1_loss", (Z, P), dict(reduction="none"), F32),
    ("smooth_l1", "smooth_l1_loss", (Z, P), dict(delta=0.5), F32),
    ("huber", "huber_loss", (Z, P), dict(delta=0.7, reduction="sum"), F32),
    ("bce_weight", "binary_cross_entropy", (P, T01), dict(weight=_u(5)),
     F32),
    ("bce_logits", "binary_cross_entropy_with_logits", (Z, T01), {}, F32),
    ("bce_logits_pos_weight", "binary_cross_entropy_with_logits", (Z, T01),
     dict(weight=_u(5), pos_weight=_u(5) + 0.5, reduction="none"), F32),
    ("kl_div_batchmean", "kl_div", (np.log(P), _u(4, 5)), dict(
        reduction="batchmean"), F32),
    ("kl_div_log_target", "kl_div", (np.log(P), np.log(_u(4, 5))), dict(
        log_target=True, reduction="sum"), F32),
    ("margin_ranking", "margin_ranking_loss", (Z[:, 0], Z[:, 1], PM1),
     dict(margin=0.2), F32),
    ("hinge_embedding", "hinge_embedding_loss", (Z, np.where(
        T01 > 0, 1.0, -1.0).astype("float32")), dict(margin=0.5), F32),
    ("cosine_embedding", "cosine_embedding_loss", (Z, _f(4, 5), PM1),
     dict(margin=0.1), F32),
    ("triplet_margin_swap", "triplet_margin_loss", (Z, _f(4, 5), _f(4, 5)),
     dict(p=1.5, swap=True), F32),
    ("soft_margin", "soft_margin_loss", (Z, np.where(
        T01 > 0, 1.0, -1.0).astype("float32")), {}, F32),
    ("multi_label_soft_margin", "multi_label_soft_margin_loss", (Z, T01),
     dict(weight=_u(4)), F32),
    ("sigmoid_focal", "sigmoid_focal_loss", (Z, T01), dict(
        normalizer=np.array([3.0], "float32")), F32),
    ("log_loss", "log_loss", (P, T01), {}, F32),
    ("square_error_cost", "square_error_cost", (Z, P), {}, F32),
    ("ctc_mean", "ctc_loss", (CTC_LP, CTC_LBL, CTC_IN, CTC_LEN), {},
     LOOSE),
    ("ctc_sum", "ctc_loss", (CTC_LP, CTC_LBL, CTC_IN, CTC_LEN), dict(
        reduction="sum"), LOOSE),
    ("ctc_none", "ctc_loss", (CTC_LP, CTC_LBL, CTC_IN, CTC_LEN), dict(
        reduction="none"), LOOSE),
    ("ctc_blank_last", "ctc_loss", (CTC_LP, CTC_LBL - 1, CTC_IN, CTC_LEN),
     dict(blank=4, reduction="none"), LOOSE),
    ("npair", "npair_loss", (Z, _f(4, 5), np.array([0, 1, 0, 2], "int64")),
     {}, F32),
    ("dice", "dice_loss", (P / P.sum(1, keepdims=True), LBL[:, None]), {},
     F32),
    ("gaussian_nll_full", "gaussian_nll_loss", (Z, P, _u(4, 5)), dict(
        full=True), F32),
    ("poisson_nll", "poisson_nll_loss", (Z, 3 * P), {}, F32),
    ("poisson_nll_full", "poisson_nll_loss", (P, 3 * P), dict(
        log_input=False, full=True, reduction="none"), F32),
    ("multi_margin", "multi_margin_loss", (Z, LBL), dict(
        p=2, margin=0.8, weight=_u(5)), F32),
    ("rnnt", "rnnt_loss", (RNNT_LOGITS, RNNT_LBL, RNNT_T, RNNT_U), {},
     LOOSE),
    ("rnnt_none_blank", "rnnt_loss", (RNNT_LOGITS, RNNT_LBL - 1, RNNT_T,
                                      RNNT_U), dict(blank=3,
                                                    reduction="none"),
     LOOSE),
    # extras
    ("pairwise_distance", "pairwise_distance", (Z, P), dict(
        p=3.0, keepdim=True), F32),
    ("diag_embed", "diag_embed", (_f(2, 3),), dict(offset=1), F32),
    ("diag_embed_dims", "diag_embed", (_f(2, 3),), dict(
        offset=-2, dim1=0, dim2=2), F32),
    ("margin_cross_entropy", "margin_cross_entropy", (
        np.tanh(Z), LBL), dict(return_softmax=True, reduction="sum"),
     F32),
    ("affine_grid", "affine_grid", (THETA,), dict(out_shape=[2, 1, 3, 4]),
     F32),
    ("affine_grid_half", "affine_grid", (THETA,), dict(
        out_shape=[2, 1, 3, 4], align_corners=False), F32),
    ("grid_sample", "grid_sample", (_f(2, 3, 5, 6), GRID), {}, F32),
    ("grid_sample_nearest_border", "grid_sample", (_f(2, 3, 5, 6), GRID),
     dict(mode="nearest", padding_mode="border"), F32),
    ("grid_sample_reflection", "grid_sample", (_f(2, 3, 5, 6), GRID),
     dict(padding_mode="reflection", align_corners=False), F32),
    ("sparse_attention", "sparse_attention", (
        _f(1, 2, 5, 4), _f(1, 2, 5, 4), _f(1, 2, 5, 4), CSR_OFF, CSR_COL),
     dict(key_padding_mask=np.array([[0, 0, 0, -1e30, 0]], "float32"),
          attn_mask=0.1 * _f(5, 5)), F32),
]

# outputs the JAX package gives in float64 under the tests' x64 setting
# (its linspace / arange promote); the port keeps fp32
F64_ROWS = {"affine_grid", "affine_grid_half"}


# the rows whose JAX function reads its inputs' values on the host (a
# mask width, the CSR offsets): run eagerly, the others compiled
HOST_READ_ROWS = {"sequence_mask_host_width", "sparse_attention"}


@pytest.mark.parametrize("row", FUNCTIONAL, ids=lambda r: r[0])
def test_functional_matches_jax(row):
    label, name, args, kwargs, tol = row
    if label in HOST_READ_ROWS:
        j = getattr(JF, name)(*jx(args), **jx(kwargs))
    else:
        j = jax_call(getattr(JF, name), args, kwargs)
    t = getattr(TF, name)(*tx(args), **tx(kwargs))
    assert_same(j, t, tol, "float32" if label in F64_ROWS else None, label)


def _grads(name, args, kwargs, wrt=0):
    """Both packages' gradient of sum(F.name(...)) for args[wrt]."""
    ta = list(tx(args))
    ta[wrt].requires_grad_()
    getattr(TF, name)(*ta, **kwargs).sum().backward()
    return jax_grad(getattr(JF, name), args, kwargs, wrt), ta[wrt].grad


@pytest.mark.parametrize("name,args,kwargs", [
    # the feasible rows (an infeasible row's gradient is rounding noise
    # around -1e30 in both packages)
    ("ctc_loss", (CTC_LP[:, :2], CTC_LBL[:2], CTC_IN[:2], CTC_LEN[:2]), {}),
    ("rnnt_loss", (RNNT_LOGITS, RNNT_LBL, RNNT_T, RNNT_U), {}),
    ("interpolate", (X4,), dict(size=[3, 8], mode="bicubic")),
    ("interpolate", (X4,), dict(scale_factor=2, mode="nearest")),
    ("grid_sample", (_f(2, 3, 5, 6), GRID), {}),
], ids=["ctc", "rnnt", "bicubic", "nearest", "grid_sample"])
def test_gradients_match_jax(name, args, kwargs):
    j, t = _grads(name, args, kwargs)
    np.testing.assert_allclose(t.numpy(), host(j), **LOOSE)


def test_ctc_rows_past_input_length_and_infeasible():
    """Row 1's loss ignores the steps past its input length (the same loss
    as its first 4 steps alone); row 2 cannot emit its labels: ~1e30 in
    both packages, a finite gradient in the port."""
    lp = tx(CTC_LP).requires_grad_()
    loss = TF.ctc_loss(lp, tx(CTC_LBL), tx(CTC_IN), tx(CTC_LEN),
                       reduction="none")
    short = TF.ctc_loss(tx(CTC_LP[:4, 1:2]), tx(CTC_LBL[1:2]),
                        tx(CTC_IN[1:2]), tx(CTC_LEN[1:2]),
                        reduction="none")
    np.testing.assert_allclose(loss[1].item(), short.item(), rtol=1e-6)
    j = jax_call(JF.ctc_loss, (CTC_LP, CTC_LBL, CTC_IN, CTC_LEN),
                 dict(reduction="none"))
    assert host(j)[2] > 1e29 and loss[2].item() > 1e29
    loss[:2].sum().backward()
    assert torch.isfinite(lp.grad).all()


def test_ctc_runs_without_a_host_read():
    """The loop reads no device value on the host (a CUDA graph captures
    it): no ``.item()``, ``bool()`` or data-dependent shape inside."""
    from test_torch_train_graph import NoHostRead

    with NoHostRead():
        TF.ctc_loss(*tx((CTC_LP, CTC_LBL, CTC_IN, CTC_LEN)))


def test_class_center_sample():
    """Every positive is kept and the labels remapped into the sampled,
    sorted set (the JAX package's result when the positives fill it);
    with a seed the negatives repeat."""
    lbl = np.array([4, 1, 4, 7], "int64")
    j = JF.class_center_sample(paddle.to_tensor(lbl), 10, 3)
    t = TF.class_center_sample(torch.from_numpy(lbl), 10, 3)
    assert_same(j, t, F32, None, "class_center_sample")
    r1, s1 = TF.class_center_sample(torch.from_numpy(lbl), 10, 6, seed=3)
    r2, s2 = TF.class_center_sample(torch.from_numpy(lbl), 10, 6, seed=3)
    assert torch.equal(s1, s2) and torch.equal(r1, r2)
    s = s1.tolist()
    assert s == sorted(s) and len(s) == 6 and {1, 4, 7} <= set(s)
    assert [s[i] for i in r1.tolist()] == lbl.tolist()


def test_inplace_activations_overwrite_their_input():
    for name, kw in (("relu_", {}), ("elu_", dict(alpha=0.5)),
                     ("softmax_", dict(axis=0)), ("tanh_", {})):
        j = paddle.to_tensor(Z)
        jr = getattr(JF, name)(j, **kw)
        t = torch.from_numpy(Z.copy())
        tr = getattr(TF, name)(t, **kw)
        assert tr is t and jr is j
        np.testing.assert_allclose(t.numpy(), host(j), **F32, err_msg=name)


def test_dropouts_drop_by_their_rule():
    """Training masks from PyTorch's generator: dropout2d / 3d drop whole
    channels, the kept ones scaled by 1/(1 - p); ``downscale_in_infer``
    keeps them unscaled; alpha dropout keeps the mean and variance of a
    unit normal; ``gumbel_softmax`` rows sum to 1, ``hard`` rows are
    one-hot."""
    g = torch.Generator().manual_seed(0)
    x = torch.ones(64, 32, 3, 3)
    y = TF.dropout2d(x, p=0.25, generator=g)
    per_channel = y.reshape(64, 32, 9)
    assert ((per_channel == 0).all(-1) | (per_channel == 1 / 0.75).all(-1)
            ).all()
    assert abs((per_channel[..., 0] == 0).float().mean().item() - 0.25) < 0.05
    y3 = TF.dropout3d(torch.ones(8, 16, 2, 2, 2), p=0.5, generator=g)
    assert ((y3.reshape(8, 16, 8) == 0).all(-1)
            | (y3.reshape(8, 16, 8) == 2).all(-1)).all()
    yd = TF.dropout(x, p=0.5, mode="downscale_in_infer", generator=g)
    assert set(yd.unique().tolist()) <= {0.0, 1.0}
    z = torch.randn(200000, generator=g)
    za = TF.alpha_dropout(z, p=0.2, generator=g)
    assert abs(za.mean().item()) < 0.02 and abs(za.var().item() - 1) < 0.03
    s = TF.gumbel_softmax(torch.from_numpy(Z), temperature=0.5,
                          generator=g)
    np.testing.assert_allclose(s.sum(-1).numpy(), 1.0, rtol=1e-6)
    h = TF.gumbel_softmax(torch.from_numpy(Z), hard=True, generator=g)
    assert ((h == 0) | (h == 1)).all() and (h.sum(-1) == 1).all()


def test_max_unpool_1d_and_3d_match_jax():
    """Each package's max pool with its mask, then its unpool."""
    x1 = _f(2, 3, 8)
    x3 = _f(1, 2, 4, 4, 4)
    for what, x, pool, unpool in (
            ("max_unpool1d", x1, "max_pool1d",
             lambda F, out, mask: F.max_unpool1d(out, mask, 2)),
            ("max_unpool3d", x3, "max_pool3d",
             lambda F, out, mask: F.max_unpool3d(out, mask, 2)),
            ("MaxUnPool1D", x1, "max_pool1d",
             lambda F, out, mask: (jnn if F is JF else tnn).MaxUnPool1D(2)(
                 out, mask))):
        def run(F, x):
            return unpool(F, *getattr(F, pool)(x, 2, return_mask=True))

        assert_same(jax_call(lambda x: run(JF, x), (x,)),
                    run(TF, torch.from_numpy(x)), F32, None, what)


def _pair_layers(name, args, kw=None):
    """The layer ``name`` of both packages, the JAX one built to receive
    the port's parameters."""
    kw = kw or {}
    tl = getattr(tnn, name)(*args, **kw)
    with jax_host_init():
        jl = getattr(jnn, name)(*args)
    state = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
    missing, unexpected = jl.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return jl, tl


# (layer, constructor args, inputs, tolerance)
LAYERS = [
    ("Dropout2D", (0.3,), (X4,), F32),
    ("Dropout3D", (0.3,), (X5,), F32),
    ("AlphaDropout", (0.3,), (Z,), F32),
    ("Upsample", ([9, 8], None, "bicubic"), (X4,), LOOSE),
    ("UpsamplingBilinear2D", (None, 2), (X4,), F32),
    ("UpsamplingNearest2D", ([5, 5],), (X4,), F32),
    ("Pad1D", ([2, 1], "reflect"), (X3,), F32),
    ("Pad2D", ([1, 2, 0, 1], "replicate"), (X4,), F32),
    ("Pad3D", ([1, 0, 0, 1, 2, 2], "constant", 0.3), (X5,), F32),
    ("ZeroPad2D", ([1, 0, 1, 2],), (X4,), F32),
    ("CosineSimilarity", (0, 1e-6), (Z, P), F32),
    ("PixelShuffle", (2,), (X4L,), F32),
    ("PixelUnshuffle", (3,), (X4L,), F32),
    ("ChannelShuffle", (2,), (X4L,), F32),
    ("Unfold", (2, 2, 1), (X4,), F32),
    ("Fold", ([4, 5], 2), (_f(2, 8, 12),), F32),
    ("PairwiseDistance", (1.0,), (Z, P), F32),
    ("Softmax2D", (), (X4,), F32),
    ("BCELoss", (None, "sum"), (P, T01), F32),
    ("BCEWithLogitsLoss", (), (Z, T01), F32),
    ("KLDivLoss", ("sum",), (np.log(P), _u(4, 5)), F32),
    ("SmoothL1Loss", ("none", 0.3), (Z, P), F32),
    ("HuberLoss", ("sum", 0.3), (Z, P), F32),
    ("MarginRankingLoss", (0.1,), (Z[:, 0], Z[:, 1], PM1), F32),
    ("CTCLoss", (0, "sum"), (CTC_LP, CTC_LBL, CTC_IN, CTC_LEN), LOOSE),
    ("CosineEmbeddingLoss", (0.2,), (Z, P, PM1), F32),
    ("TripletMarginLoss", (0.5, 2.0, 1e-6, True), (Z, P, _f(4, 5)), F32),
    ("TripletMarginWithDistanceLoss", (None, 0.5), (Z, P, _f(4, 5)), F32),
    ("SoftMarginLoss", ("sum",), (Z, PM1[:, None] * np.ones(
        (1, 5), "float32")), F32),
    ("MultiLabelSoftMarginLoss", (), (Z, T01), F32),
    ("MultiMarginLoss", (1, 0.5), (Z, LBL), F32),
    ("HingeEmbeddingLoss", (0.4,), (Z, np.where(T01 > 0, 1.0, -1.0).astype(
        "float32")), F32),
    ("GaussianNLLLoss", (True,), (Z, P, _u(4, 5)), F32),
    ("PoissonNLLLoss", (False, True), (P, 3 * P), F32),
    ("RNNTLoss", (0, 0.0, "sum"), (RNNT_LOGITS, RNNT_LBL, RNNT_T, RNNT_U),
     LOOSE),
]


@pytest.mark.parametrize("row", LAYERS, ids=lambda r: r[0])
def test_layers_match_jax(row):
    name, args, inputs, tol = row
    jl, tl = _pair_layers(name, args)
    jl.eval()
    tl.eval()
    assert_same(jax_forward(jl, *inputs), tl(*tx(inputs)), tol, None, name)


def test_bilinear_layer_and_hsigmoid_match_jax_with_gradients():
    """The layers with parameters: the port's weights carried to JAX; the
    outputs and the weights' gradients. HSigmoidLoss on its default tree
    and on a custom one, and ``F.hsigmoid_loss`` with the same weights."""
    torch.manual_seed(0)
    for name, args, inputs in (
            ("Bilinear", (4, 5, 3), (_f(6, 4), _f(6, 5))),
            ("HSigmoidLoss", (5, 6), (_f(4, 5), _i(6, 4, 1)))):
        jl, tl = _pair_layers(name, args, dict(device="cpu"))
        jo = jl(*jx(inputs))
        to = tl(*tx(inputs))
        assert_same(jo, to, F32, None, name)
        paddle.sum(jo).backward()
        to.sum().backward()
        np.testing.assert_allclose(tl.weight.grad.numpy(),
                                   host(jl.weight.grad), **F32)
    x, y = _f(4, 5), _i(6, 4, 1)
    assert_same(JF.hsigmoid_loss(*jx((x, y)), 6, jl.weight, jl.bias),
                TF.hsigmoid_loss(*tx((x, y)), 6, tl.weight, tl.bias), F32,
                None, "F.hsigmoid_loss")
    table = np.array([[0, 1, -1], [0, 2, 3], [0, 1, 4], [0, 2, -1]],
                     "int64")
    code = (R.rand(4, 3) > 0.5).astype("float32")
    jl, tl = _pair_layers("HSigmoidLoss", (5, 6, None, None, True),
                          dict(device="cpu"))
    assert_same(jl(*jx((x, y, table, code))), tl(*tx((x, y, table, code))),
                F32, None, "HSigmoidLoss custom")


def test_weight_norm_and_remove_match_jax():
    """``weight_norm`` on a Linear (the norm over every axis but 0): the
    output and the gradients of g and v; ``remove_weight_norm`` folds the
    same weight back; parameters_to_vector / vector_to_parameters."""
    tl = tnn.Linear(4, 3, device="cpu")
    with jax_host_init():
        jl = jnn.Linear(4, 3)
    jl.set_state_dict({k: v.detach().numpy()
                       for k, v in tl.state_dict().items()})
    tutils.weight_norm(tl, dim=0)
    jutils.weight_norm(jl, dim=0)
    x = _f(2, 4)
    jo, to = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    assert_same(jo, to, F32, None, "weight_norm forward")
    paddle.sum(jo * jo).backward()
    (to * to).sum().backward()
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   host(getattr(jl, n).grad), **F32,
                                   err_msg=n)
    tutils.remove_weight_norm(tl)
    jutils.remove_weight_norm(jl)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               host(jl.weight), **F32)
    assert "weight_g" not in dict(tl.named_parameters())
    jv = jutils.parameters_to_vector(jl.parameters())
    tv = tutils.parameters_to_vector(tl.parameters())
    assert_same(jv, tv, F32, None, "parameters_to_vector")
    tutils.vector_to_parameters(tv * 2, tl.parameters())
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               2 * host(jl.bias), **F32)


def test_spectral_norm_matches_jax_and_updates_its_buffers_in_place():
    """``spectral_norm`` on a Conv2D with the JAX package's power-iteration
    vectors carried across: the output over two calls (u and v move each
    call, in place) and the weight's gradient; ``F.spectral_norm`` and the
    ``SpectralNorm`` layer."""
    tc = tnn.Conv2D(2, 3, 3, device="cpu")
    with jax_host_init():
        jc = jnn.Conv2D(2, 3, 3)
    jc.set_state_dict({k: v.detach().numpy()
                       for k, v in tc.state_dict().items()})
    tutils.spectral_norm(tc)
    jutils.spectral_norm(jc)
    jstate = {k: host(v) for k, v in jc.state_dict().items()}
    missing, unexpected = tc.set_state_dict(jstate)
    assert not missing and not unexpected
    u = tc.weight_u
    x = _f(1, 2, 5, 5)
    for _ in range(2):
        assert_same(jc(paddle.to_tensor(x)), tc(torch.from_numpy(x)), F32,
                    None, "spectral_norm forward")
    assert tc.weight_u is u
    np.testing.assert_allclose(u.numpy(), host(jc.weight_u), **F32)
    jo = jc(paddle.to_tensor(x))
    to = tc(torch.from_numpy(x))
    paddle.sum(jo * jo).backward()
    (to * to).sum().backward()
    np.testing.assert_allclose(tc.weight_orig.grad.numpy(),
                               host(jc.weight_orig.grad), **LOOSE)
    w = _f(3, 4, 2)
    assert_same(JF.spectral_norm(paddle.to_tensor(w), dim=1, power_iters=2),
                TF.spectral_norm(torch.from_numpy(w), dim=1, power_iters=2),
                F32, None, "F.spectral_norm")
    assert_same(jnn.SpectralNorm([3, 4, 2])(paddle.to_tensor(w)),
                tnn.SpectralNorm([3, 4, 2])(torch.from_numpy(w)), F32, None,
                "SpectralNorm")


def test_rms_norm_and_clip_functions_match_jax():
    x = _f(3, 8)
    w = _u(8)
    assert_same(JF.rms_norm(*jx((x, w))), TF.rms_norm(*tx((x, w))), F32,
                None, "rms_norm")
    tl = tnn.RMSNorm(8, device="cpu")
    with jax_host_init():
        jl = jnn.RMSNorm(8)
    assert_same(jl(paddle.to_tensor(x)), tl(torch.from_numpy(x)), F32, None,
                "RMSNorm")
    for norm_type in (2.0, float("inf")):
        jp = [paddle.to_tensor(_f(3, 2), stop_gradient=False)
              for _ in range(2)]
        tp = [torch.tensor(host(p)).requires_grad_() for p in jp]
        for p in jp:
            paddle.sum(p * p * 3).backward()
        for p in tp:
            (p * p * 3).sum().backward()
        jt = jnn.clip_grad_norm_(jp, 1.0, norm_type)
        tt = tnn.clip_grad_norm_(tp, 1.0, norm_type)
        np.testing.assert_allclose(tt.item(), float(host(jt)), rtol=1e-6)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.grad.numpy(), host(a.grad), **F32)
    jnn.clip_grad_value_(jp, 0.5)
    tnn.clip_grad_value_(tp, 0.5)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.grad.numpy(), host(a.grad), **F32)


def test_every_name_of_the_jax_package_is_exported():
    """``paddle.nn``, ``nn.functional`` and ``nn.utils`` export every
    name the JAX package's do; the unported Transformer raises naming
    its ROADMAP item."""
    for jm, tm in ((jnn, tnn), (JF, TF), (jutils, tutils)):
        missing = sorted(set(jm.__all__) - set(dir(tm)))
        assert not missing, (tm.__name__, missing)
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        pt.nn.Transformer()
