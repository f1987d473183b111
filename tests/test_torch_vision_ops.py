"""``paddle_tpu_torch/vision/ops.py`` against the JAX package's
``vision/ops.py`` on the CPU: every op forward, and the gradient of every
op that is differentiable there (``box_coder``, ``yolo_box``,
``yolo_loss``, ``roi_align``, ``roi_pool``, ``psroi_pool``,
``deform_conv2d``), on the same seeded inputs.

The dense ops' JAX side runs compiled, forward and gradients in one
program a case (``_jax_fwd_grads``), but ``roi_pool``, which runs
eagerly (see its test); the host ops (NMS family, proposals, FPN
routing, prior boxes) read their inputs back in both packages and run
eagerly. fp32
results within rtol 1e-5 / atol 1e-5 of the JAX package's (gathers and
short sums; the deformable product within 1e-4 of its largest value, its
sum order differs), indices and counts exactly. The RoI inputs are
random floats: no two values of a pooling bin tie, so the max's gradient
goes to one element in both packages."""
import numpy as np
import pytest
import torch

import paddle_tpu.vision.ops as J
import paddle_tpu_torch.vision.ops as T
from torch_tensor_parity import (_traced, assert_same, host, jax_compiled,
                                 jax_values, tx)

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.RandomState(0)


def _rand(*shape, lo=0.0, hi=1.0):
    return (RNG.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def _boxes(n, size, rng=RNG):
    xy = rng.rand(n, 2) * size * 0.7
    wh = rng.rand(n, 2) * size * 0.5 + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _torch_grad(fn, args, wrt):
    a = list(tx(args))
    a[wrt] = a[wrt].requires_grad_(True)
    fn(*a).sum().backward()
    return a[wrt].grad


def _jax_fwd_grads(jfn, args, kwargs, wrts):
    """The JAX package's ``jfn(*args, **kwargs)`` and the gradients of its
    sum for the argument positions ``wrts``, one compiled program (see
    ``torch_tensor_parity.jax_call``)."""
    import jax
    import jax.numpy as jnp

    place, xs = _traced(args, kwargs)
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    ks = tuple(pos.index(w) for w in wrts)

    def run(*xs):
        a, kw = place(xs)
        return jfn(*a, **kw)

    def both(*xs):
        total = lambda *v: jnp.sum(jax_values(_sum(run(*v))))
        grads = jax.grad(total, argnums=ks)(*xs) if ks else ()
        return jax_values(run(*xs)), grads

    return jax_compiled(both, *xs)


def _check(jfn, tfn, args, kwargs=None, grads=(), tol=TOL, what="",
           dtype=None):
    """Forward (and the gradients of the sum for the argument positions
    ``grads``) of both packages on the same numpy ``args``."""
    kwargs = kwargs or {}
    j, jgrads = _jax_fwd_grads(jfn, args, kwargs, grads)
    t = tfn(*tx(args), **tx(kwargs))
    assert_same(j, t, tol, dtype, what=what)
    for k, jg in zip(grads, jgrads):
        tg = _torch_grad(lambda *a: _sum(tfn(*a, **tx(kwargs))), args, k)
        np.testing.assert_allclose(host(tg), jg, err_msg=f"{what} grad {k}",
                                   **tol)


def _sum(out):
    """One output, or the sum of a tuple's (each package's tensors)."""
    if isinstance(out, (list, tuple)):
        return sum(o.sum() for o in out)
    return out


# each RoI's image, as a concrete JAX-package tensor made outside the
# compiled call (the JAX ops read it on the host)
def _jnum(counts):
    import paddle_tpu as jpaddle

    return jpaddle.to_tensor(np.asarray(counts, np.int64))


# ------------------------------------------------------------- RoI family

FEAT = _rand(2, 8, 12, 14, lo=-1, hi=1)
ROIS = _boxes(9, 14)
PS_FEAT = _rand(2, 2 * 3 * 3, 12, 14, lo=-1, hi=1)


@pytest.mark.parametrize("kw", [
    dict(output_size=3, spatial_scale=1.0),
    dict(output_size=(2, 4), spatial_scale=0.5, aligned=False),
    dict(output_size=3, spatial_scale=1.0, sampling_ratio=2)],
    ids=["3", "2x4_unaligned", "sampling_ratio_ignored"])
def test_roi_align_matches_jax(kw):
    _check(lambda x, b, n=_jnum([4, 5]): J.roi_align(x, b, n, **kw),
           lambda x, b: T.roi_align(x, b, torch.tensor([4, 5]), **kw),
           (FEAT, ROIS), grads=(0, 1), what="roi_align")


def _jax_eager(fn, args, wrt):
    """``fn(*args)`` of the JAX package run eagerly, op by op, and the
    gradient of its sum for ``args[wrt]`` (numpy out)."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as jpaddle

    def call(x):
        a = [jpaddle.to_tensor(v) for v in args]
        a[wrt] = jpaddle.Tensor(x)
        return fn(*a).value

    x = jnp.asarray(args[wrt])
    return (np.asarray(call(x)),
            np.asarray(jax.grad(lambda v: jnp.sum(call(v)))(x)))


@pytest.mark.parametrize("kw,chunk", [
    (dict(output_size=3), 8 * 12 * 3 * 14 * 2),
    (dict(output_size=(2, 3), spatial_scale=0.5), None)],
    ids=["3_in_chunks", "2x3_half"])
def test_roi_pool_matches_jax(kw, chunk, monkeypatch):
    """Against the JAX op run eagerly: compiled by XLA, the JAX package
    puts a bin edge a rounding away where ``(i + 1) · rh`` is a whole
    number (7 / 3 · 3 rounds above 7 there: a bin a row larger), which
    eager JAX and the port, its edges in float64, do not. RoIs in chunks,
    and boxes past the map's edge whose bins are empty (0)."""
    if chunk:
        monkeypatch.setattr(T, "_CHUNK_ELEMS", chunk)
    rois = np.concatenate([ROIS, np.float32([[20, 20, 30, 30],
                                             [13, 11, 40, 50]])])
    n = _jnum([6, 5])
    j, jg = _jax_eager(lambda x, b: J.roi_pool(x, b, n, **kw), (FEAT, rois),
                       0)
    x = torch.from_numpy(FEAT.copy()).requires_grad_(True)
    t = T.roi_pool(x, torch.from_numpy(rois), torch.tensor([6, 5]), **kw)
    t.sum().backward()
    np.testing.assert_allclose(host(t), j, **TOL)
    np.testing.assert_allclose(host(x.grad), jg, **TOL)
    assert (host(t)[9:] == 0).any()             # an empty bin


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_psroi_pool_matches_jax(scale, monkeypatch):
    monkeypatch.setattr(T, "_CHUNK_ELEMS", 18 * 12 * 14 * 4)
    _check(lambda x, b, n=_jnum([3, 6]): J.psroi_pool(x, b, n, 3, scale),
           lambda x, b: T.psroi_pool(x, b, torch.tensor([3, 6]), 3, scale),
           (PS_FEAT, ROIS), grads=(0,), what="psroi_pool")


def test_roi_layers_match_their_functions():
    """The layers call the functions held to JAX above, with their
    output size and scale."""
    x, b, n = (torch.from_numpy(FEAT), torch.from_numpy(ROIS),
               torch.tensor([4, 5]))
    ps = torch.from_numpy(PS_FEAT)
    for layer, fn, feat in ((T.RoIAlign(2, 0.5), T.roi_align, x),
                            (T.RoIPool(3), T.roi_pool, x),
                            (T.PSRoIPool(3), T.psroi_pool, ps)):
        want = fn(feat, b, n, layer._output_size, layer._spatial_scale)
        assert torch.equal(layer(feat, b, n), want), type(layer).__name__
    assert torch.equal(T.RoIAlign(2)(x, b, n, aligned=False),
                       T.roi_align(x, b, n, 2, aligned=False))


# ------------------------------------------------------------- deformable

X = _rand(2, 4, 7, 8, lo=-1, hi=1)
W = _rand(6, 4, 3, 3, lo=-0.5, hi=0.5)
BIAS = _rand(6)
# offsets that reach past the map's edges (the zero reads)
OFF = _rand(2, 2 * 9, 7, 8, lo=-2.5, hi=2.5)
MASK = _rand(2, 9, 7, 8)
DTOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_matches_jax(v2):
    args = (X, OFF, W, BIAS) + ((MASK,) if v2 else ())

    def make(mod):
        def f(x, off, w, b, m=None):
            return mod.deform_conv2d(x, off, w, b, stride=1, padding=1,
                                     mask=m)
        return f

    _check(make(J), make(T), args, grads=(0, 1, 2) + ((4,) if v2 else ()),
           tol=DTOL, what=f"deform_conv2d v{2 if v2 else 1}")


def test_deform_conv2d_groups_stride_dilation_match_jax():
    x = _rand(1, 4, 9, 9, lo=-1, hi=1)
    w = _rand(4, 2, 3, 3, lo=-0.5, hi=0.5)
    off = _rand(1, 2 * 2 * 9, 5, 3, lo=-1.5, hi=1.5)   # Ho 5, Wo 3

    def make(mod):
        return lambda x, off, w: mod.deform_conv2d(
            x, off, w, None, stride=2, padding=(1, 0), dilation=(1, 2),
            deformable_groups=2, groups=2)

    _check(make(J), make(T), (x, off, w), grads=(0, 1), tol=DTOL,
           what="deform_conv2d groups")


def test_deform_conv2d_layer_matches_jax_shapes_and_its_function():
    torch.manual_seed(0)
    tl = T.DeformConv2D(4, 6, 3, padding=1, device="cpu")
    jl = J.DeformConv2D(4, 6, 3, padding=1)
    assert [tuple(p.shape) for p in tl.parameters()] == \
        [tuple(p.shape) for p in jl.parameters()]
    assert list(tl.state_dict()) == list(jl.state_dict())
    x, off, m = map(torch.from_numpy, (X, OFF, MASK))
    want = T.deform_conv2d(x, off, tl.weight, tl.bias, padding=1, mask=m)
    assert torch.equal(tl(x, off, m), want)
    assert T.DeformConv2D(4, 6, 3, bias_attr=False, device="cpu").bias is None


# ------------------------------------------------------------- YOLO

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
YX = _rand(2, 3 * (5 + 4), 5, 6, lo=-2, hi=2)


@pytest.mark.parametrize("kw", [dict(), dict(clip_bbox=False, scale_x_y=1.2),
                                dict(iou_aware=True, iou_aware_factor=0.4)],
                         ids=["plain", "unclipped_scaled", "iou_aware"])
def test_yolo_box_matches_jax(kw):
    x = YX if not kw.get("iou_aware") else _rand(2, 3 * 10, 5, 6, lo=-2,
                                                 hi=2)
    img = np.int32([[160, 190], [150, 200]])
    _check(lambda x, im: J.yolo_box(x, im, ANCHORS[:6], 4, 0.3, 32, **kw),
           lambda x, im: T.yolo_box(x, im, ANCHORS[:6], 4, 0.3, 32, **kw),
           (x, img), grads=(0,), what="yolo_box")


@pytest.mark.parametrize("grad", [True, False], ids=["plain", "variants"])
def test_yolo_loss_matches_jax(grad):
    """Two ground-truth slots (the JAX loss unrolls a scatter a slot and an
    anchor, which compiles for seconds), one of them empty; the plain loss
    with its gradient, then label smoothing off, ``scale_x_y`` and
    ``gt_score`` together, forward."""
    rng = np.random.RandomState(5)
    gt = np.concatenate([rng.rand(2, 2, 2) * 0.8 + 0.1,
                         rng.rand(2, 2, 2) * 0.5 + 0.05], -1).astype(
        np.float32)
    gt[1, 1] = 0
    lbl = rng.randint(0, 4, (2, 2)).astype(np.int32)
    score = rng.rand(2, 2).astype(np.float32)
    kw = {} if grad else dict(use_label_smooth=False, scale_x_y=1.1)
    args = (YX, gt, lbl) + (() if grad else (score,))

    def make(mod):
        def f(x, g, l, s=None):
            return mod.yolo_loss(x, g, l, ANCHORS, [3, 4, 5], 4, 0.5, 32,
                                 gt_score=s, **kw)
        return f

    # the JAX package's loss is float64 under the tests' 64-bit setting
    # (its targets are made in the default float type); the port's fp32
    _check(make(J), make(T), args, grads=(0,) if grad else (),
           what="yolo_loss", dtype="float32")


# ------------------------------------------------------------- boxes

PRIORS = _boxes(5, 1.0, np.random.RandomState(1))
TARGETS = _boxes(3, 1.0, np.random.RandomState(2))


@pytest.mark.parametrize("case", ["encode", "encode_var", "decode0",
                                  "decode1", "unnormalized"])
def test_box_coder_matches_jax(case):
    var = _rand(5, 4, lo=0.1, hi=0.3)
    deltas = _rand(3, 5, 4, lo=-0.5, hi=0.5)
    if case == "encode":
        args, kw = (PRIORS, TARGETS), {}
        fn = lambda m: lambda p, t: m.box_coder(p, None, t)
    elif case == "encode_var":
        args, kw = (PRIORS, var, TARGETS), {}
        fn = lambda m: lambda p, v, t: m.box_coder(p, v, t)
    elif case == "unnormalized":
        args, kw = (PRIORS * 50, TARGETS * 50), {}
        fn = lambda m: lambda p, t: m.box_coder(p, None, t,
                                                box_normalized=False)
    else:
        axis = int(case[-1])
        d = deltas if axis == 0 else deltas.transpose(1, 0, 2).copy()
        args, kw = (PRIORS, var, d), {}
        fn = lambda m: lambda p, v, t: m.box_coder(
            p, v if axis == 0 else None, t, "decode_center_size", axis=axis)
    _check(fn(J), fn(T), args, kw, grads=(len(args) - 1,), what=case)


def test_prior_box_matches_jax():
    import paddle_tpu as jpaddle

    feat, image = np.zeros((1, 8, 3, 4), np.float32), np.zeros(
        (1, 3, 30, 40), np.float32)
    for kw in (dict(min_sizes=[4.0], aspect_ratios=[2.0], flip=True),
               dict(min_sizes=[4.0, 8.0], max_sizes=[6.0, 12.0], clip=True,
                    min_max_aspect_ratios_order=True, aspect_ratios=[1.0,
                                                                     3.0]),
               dict(min_sizes=[5.0], steps=(8.0, 9.0), offset=0.3)):
        j = J.prior_box(jpaddle.to_tensor(feat), jpaddle.to_tensor(image),
                        **kw)
        t = T.prior_box(torch.from_numpy(feat), torch.from_numpy(image),
                        **kw)
        assert_same(j, t, TOL, what=str(kw))


# ------------------------------------------------------------- host ops

def _eager(name, args, kwargs=None):
    """Both packages' ``name`` called eagerly on ``args`` (numpy arrays
    entering as each package's tensors)."""
    from torch_tensor_parity import jx

    kwargs = kwargs or {}
    return (getattr(J, name)(*jx(args), **jx(kwargs)),
            getattr(T, name)(*tx(args), **tx(kwargs)))


NMS_BOXES = _boxes(30, 20, np.random.RandomState(3))
NMS_SCORES = np.random.RandomState(4).rand(30).astype(np.float32)
CATS = np.random.RandomState(5).randint(0, 3, 30).astype(np.int64)


@pytest.mark.parametrize("kw", [
    dict(), dict(scores=NMS_SCORES, iou_threshold=0.1),
    dict(scores=NMS_SCORES, category_idxs=CATS, top_k=7),
    dict(scores=NMS_SCORES, category_idxs=CATS, categories=[0, 2])],
    ids=["unscored", "scored", "categories_top_k", "some_categories"])
def test_nms_matches_jax(kw):
    j, t = _eager("nms", (NMS_BOXES,), kw)
    assert_same(j, t, what="nms")


@pytest.mark.parametrize("kw", [
    dict(), dict(use_gaussian=True, gaussian_sigma=0.5, return_index=True),
    dict(post_threshold=0.2, keep_top_k=5, background_label=-1,
         return_rois_num=False)], ids=["linear", "gaussian", "kept"])
def test_matrix_nms_matches_jax(kw):
    rng = np.random.RandomState(6)
    boxes = np.stack([_boxes(12, 1.0, rng) for _ in range(2)])
    scores = rng.rand(2, 3, 12).astype(np.float32)
    j, t = _eager("matrix_nms", (boxes, scores, 0.3), kw)
    assert_same(j, t, TOL, what="matrix_nms")


@pytest.mark.parametrize("with_num", [False, True])
def test_distribute_fpn_proposals_matches_jax(with_num):
    rois = _boxes(20, 400, np.random.RandomState(7))
    kw = dict(rois_num=np.int32([12, 8])) if with_num else {}
    j, t = _eager("distribute_fpn_proposals", (rois, 2, 5, 4, 224), kw)
    assert_same(j[0], t[0], what="levels")
    assert_same(j[1], t[1], what="restore")
    assert (j[2] is None) == (t[2] is None)
    if with_num:
        assert_same(j[2], t[2], what="counts")


@pytest.mark.parametrize("kw", [dict(), dict(pixel_offset=True,
                                             return_rois_num=True,
                                             post_nms_top_n=5)],
                         ids=["default", "offset_counts"])
def test_generate_proposals_matches_jax(kw):
    rng = np.random.RandomState(8)
    A, H, W = 3, 4, 5
    scores = rng.rand(2, A, H, W).astype(np.float32)
    deltas = (rng.randn(2, 4 * A, H, W) * 0.2).astype(np.float32)
    anchors = _boxes(H * W * A, 60, rng).reshape(H, W, A, 4)
    var = np.ones((H, W, A, 4), np.float32)
    img = np.float32([[64, 64], [60, 70]])
    j, t = _eager("generate_proposals", (scores, deltas, img, anchors, var),
                  dict(pre_nms_top_n=40, min_size=2.0, **kw))
    assert_same(j, t, TOL, what="generate_proposals")


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    from PIL import Image

    path = tmp_path / "x.jpg"
    img = (np.random.RandomState(9).rand(12, 10, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(path, quality=90)
    j = J.read_file(str(path))
    t = T.read_file(str(path))
    assert_same(j, t, what="read_file")
    assert t.device.type == "cpu"
    for mode in ("unchanged", "gray", "rgb"):
        assert_same(J.decode_jpeg(j, mode), T.decode_jpeg(t, mode),
                    what=mode)
