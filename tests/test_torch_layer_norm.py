"""LayerNorm in the PyTorch port (``paddle_tpu_torch/ops/fused_norm.py``,
row 8 of the kernel table) against the JAX package on the CPU, with the
same numpy inputs: the plain version and the autograd function against
JAX's ``_ln_ref`` at any row count, against the Pallas kernel in interpret
mode at the row counts its tile takes, and against JAX's gradient; the
incubate entry points and ``F.layer_norm``'s dispatch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as jinc
from paddle_tpu.nn import functional as jF
from paddle_tpu.ops import fused_norm as jfn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.incubate.nn import functional as tinc
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops import fused_norm as tfn

# fp32 on both sides: only the order of the D-term sums differs, which
# moves mean and variance by a few ulps of the row's scale
TOL = dict(rtol=1e-5, atol=1e-6)
# gradients: dx sums D products per element (the mean terms of the
# LayerNorm gradient): rtol 1e-5, atol 1e-5. dw and db are sums over the
# rows, whose fp32 summation-order error grows with the terms' sizes, not
# with the sum: an entry that cancels to near 0 keeps an error of a few
# ulps of the largest entries, so their atol is 1e-6 of the largest entry
GRAD_RTOL = 1e-5
DX_ATOL = 1e-5


def _case(rows, D=768, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = (shift + rng.standard_normal((rows, D))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, w, b


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("rows", [1, 13, 4096])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_plain_and_autograd_forward_match_jax_ref_at_any_row_count(rows,
                                                                   eps):
    x, w, b = _case(rows, seed=rows)
    ref = np.asarray(jfn._ln_ref(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), eps))
    plain = tfn._ln_ref(*_t(x, w, b), eps)
    out = tfn.fused_layer_norm(*_t(x, w, b), eps)
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows, 768)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("rows", [16, 24])
def test_matches_pallas_kernel_in_interpret_mode(rows):
    """The Pallas kernel tiles rows it can divide (its ``_block_rows``
    refuses a single row): 16 and 24 rows, a 3-d input, a row mean far
    from 0 (the variance is taken about the mean in both)."""
    x, w, b = _case(rows, D=256, seed=5, shift=3.0)
    x3 = x.reshape(2, rows // 2, 256)
    pallas = np.asarray(jfn._ln_pallas(jnp.asarray(x3), jnp.asarray(w),
                                       jnp.asarray(b), 1e-5, interpret=True))
    out = tfn.fused_layer_norm(*_t(x3, w, b), 1e-5)
    assert tuple(out.shape) == x3.shape
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)


@pytest.mark.parametrize("rows", [13, 4096])
def test_backward_matches_jax_vjp(rows):
    x, w, b = _case(rows, seed=7)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: jfn.fused_layer_norm(x_, w_, b_,
                                                             1e-5),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    xt, wt, bt = (t.requires_grad_() for t in _t(x, w, b))
    tfn.fused_layer_norm(xt, wt, bt, 1e-5).backward(torch.from_numpy(g))
    for got, ref, name in zip((xt.grad, wt.grad, bt.grad), want,
                              ("dx", "dw", "db")):
        atol = DX_ATOL if name == "dx" else 1e-6 * np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, err_msg=name,
                                   rtol=GRAD_RTOL, atol=atol)


def test_bf16_output_within_one_rounding_of_jax():
    """bf16 in, fp32 math, bf16 out on both sides: the outputs may differ
    by one bf16 rounding step (2^-7 of the value; the fp32 sums differ in
    order) plus the bf16 step of the bias (2^-8 of its scale, 0.1) where
    the normalised term and the bias cancel."""
    x, w, b = _case(64, seed=2)
    ref = np.asarray(jfn._ln_ref(*(jnp.asarray(a).astype(jnp.bfloat16)
                                   for a in (x, w, b)),
                                 1e-12).astype(jnp.float32))
    out = tfn.fused_layer_norm(*(t.bfloat16() for t in _t(x, w, b)), 1e-12)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=0.1 * 2 ** -8)


def test_constant_row_at_eps_1e12_stays_finite():
    """A constant row has var = 0: rsqrt(1e-12) = 1e6 in fp32, finite, and
    (x - mu) = 0 exactly, so the row's output is the bias."""
    x = np.full((3, 128), 2.5, np.float32)
    _, w, b = _case(1, D=128, seed=3)
    out = tfn.fused_layer_norm(*_t(x, w, b), 1e-12)
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(b, x.shape))


def test_incubate_entry_points_match_jax():
    x, w, b = _case(24, D=128, seed=4)
    want_ln = np.asarray(jinc.fused_layer_norm(
        *(paddle.to_tensor(a) for a in (x, w, b)), 1e-6).value)
    want_rms = np.asarray(jinc.fused_rms_norm(
        paddle.to_tensor(x), paddle.to_tensor(w), 1e-6).value)
    np.testing.assert_allclose(
        tinc.fused_layer_norm(*_t(x, w, b), 1e-6).numpy(), want_ln, **TOL)
    np.testing.assert_allclose(
        tinc.fused_rms_norm(*_t(x, w), 1e-6).numpy(), want_rms, **TOL)


@pytest.mark.parametrize("form", ["one_axis", "two_axes", "no_bias",
                                  "no_weight"])
def test_functional_layer_norm_matches_jax_and_takes_the_kernel_form(
        monkeypatch, form):
    """``F.layer_norm`` sends one axis with weight and bias through
    ``fused_layer_norm`` (the kernel on the card) and every other form
    through the plain composition; each matches the JAX ``F.layer_norm``."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    ns = [4, 32] if form == "two_axes" else [32]
    w = (1 + 0.1 * rng.standard_normal(ns)).astype(np.float32)
    b = (0.1 * rng.standard_normal(ns)).astype(np.float32)
    w = None if form == "no_weight" else w
    b = None if form == "no_bias" else b
    want = np.asarray(jF.layer_norm(
        paddle.to_tensor(x), ns, None if w is None else paddle.to_tensor(w),
        None if b is None else paddle.to_tensor(b), 1e-5).value)
    calls = []
    orig = tnorm.fused_layer_norm
    monkeypatch.setattr(tnorm, "fused_layer_norm",
                        lambda *a: calls.append(1) or orig(*a))
    got = tF.layer_norm(torch.from_numpy(x), ns,
                        None if w is None else torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert calls == ([1] if form == "one_axis" else [])


def test_cpu_tensors_never_launch_and_the_wrapper_refuses_them():
    x, w, b = _t(*_case(4, D=64))
    tops.reset_launch_counts()
    tfn.fused_layer_norm(x, w, b, 1e-5)
    assert tops.launch_counts()["layer_norm"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tfn.layer_norm_cuda(x, w, b, 1e-5)
    assert tops.launch_counts()["layer_norm"] == 0


def test_reference_mode_runs_the_plain_version():
    x, w, b = _t(*_case(5, D=64, seed=6))
    tops.set_kernel_mode("reference")
    try:
        out = tfn.fused_layer_norm(x, w, b, 1e-5)
    finally:
        tops.set_kernel_mode("auto")
    np.testing.assert_array_equal(out.numpy(),
                                  tfn._ln_ref(x, w, b, 1e-5).numpy())
