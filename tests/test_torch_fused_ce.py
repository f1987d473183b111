"""Fused chunked lm-head + cross-entropy in the PyTorch port
(paddle_tpu_torch/ops/fused_ce.py) against the JAX package's
``fused_linear_cross_entropy`` on the CPU, fp32, same numpy inputs: the
loss and both gradients, with ignored rows, chunks that do not divide the
token count, tied (transposed) weights, and non-finite activations on
ignored rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_ce import capped_chunk_size as jcap
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jflce
from paddle_tpu_torch.ops.fused_ce import (capped_chunk_size,
                                           fused_linear_cross_entropy)

# fp32 on both sides; the logsumexp and the dW contraction sum in other
# orders (XLA vs torch)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _case(n, h, v, seed, transpose=False, ignored=(3,)):
    rng = np.random.default_rng(seed)
    hx = rng.standard_normal((n, h)).astype(np.float32)
    w = (0.1 * rng.standard_normal((v, h) if transpose else (h, v))).astype(
        np.float32)
    lbl = rng.integers(0, v, n).astype(np.int64)
    lbl[list(ignored)] = -100
    return hx, w, lbl


def _both(hx, w, lbl, chunk, transpose=False):
    def jf(a, b):
        return jflce(a, b, jnp.asarray(lbl), chunk_size=chunk,
                     transpose_weight=transpose)

    jl, (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hx), jnp.asarray(w))
    th = torch.from_numpy(hx).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                    chunk_size=chunk,
                                    transpose_weight=transpose)
    tl.backward()
    return (tl, th.grad, tw.grad), (jl, jdh, jdw)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_loss_and_grads_match_jax(chunk):
    """37 tokens: a chunk of 8 or 16 leaves a padded last chunk, 64 covers
    all tokens in one (clamped to 37); token 3 is ignored."""
    hx, w, lbl = _case(37, 16, 53, seed=0)
    (tl, tdh, tdw), (jl, jdh, jdw) = _both(hx, w, lbl, chunk)
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **GRAD_TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **GRAD_TOL)
    assert np.all(tdh.numpy()[3] == 0)        # the ignored row


@pytest.mark.parametrize("chunk", [8, 24])
def test_transposed_weight_matches_jax(chunk):
    """Tied embeddings: weight [V, H] with ``transpose_weight``; dW comes
    back in the [V, H] layout."""
    hx, w, lbl = _case(24, 8, 31, seed=1, transpose=True, ignored=(0, 5))
    (tl, tdh, tdw), (jl, jdh, jdw) = _both(hx, w, lbl, chunk,
                                           transpose=True)
    assert tuple(tdw.shape) == w.shape
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **GRAD_TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **GRAD_TOL)


def test_batched_hidden_and_labels_match_jax():
    """[B, S, H] hidden with [B, S] labels reshape to tokens on both sides."""
    rng = np.random.default_rng(2)
    hx = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((16, 40))).astype(np.float32)
    lbl = rng.integers(0, 40, (2, 9)).astype(np.int64)
    lbl[1, -3:] = -100
    jl = jflce(jnp.asarray(hx), jnp.asarray(w), jnp.asarray(lbl),
               chunk_size=4)
    th = torch.from_numpy(hx).requires_grad_()
    tl = fused_linear_cross_entropy(th, torch.from_numpy(w),
                                    torch.from_numpy(lbl), chunk_size=4)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    assert tuple(th.grad.shape) == hx.shape


def test_ignored_rows_tolerate_nonfinite_activations():
    """An ignored row holding inf must not reach the loss or dW (the row is
    zeroed before the dW contraction)."""
    hx, w, lbl = _case(8, 16, 32, seed=3, ignored=(0,))
    hx[0] = np.inf
    th = torch.from_numpy(hx).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                      chunk_size=4)
    loss.backward()
    assert np.isfinite(loss.item())
    assert torch.isfinite(tw.grad).all()
    assert torch.isfinite(th.grad[1:]).all()


def test_all_rows_ignored_gives_zero_loss_and_grads():
    hx, w, lbl = _case(6, 8, 16, seed=4, ignored=range(6))
    (tl, tdh, tdw), (jl, _, _) = _both(hx, w, lbl, 4)
    assert tl.item() == float(jl) == 0.0
    assert not tdh.any() and not tdw.any()


@pytest.mark.parametrize("chunk,seq", [(16384, 2048), (16384, 8192),
                                       (16384, 16384), (4096, 32768)])
def test_capped_chunk_size_matches_jax(chunk, seq):
    assert capped_chunk_size(chunk, seq) == jcap(chunk, seq)
