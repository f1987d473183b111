"""Flash attention in the PyTorch port (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package on the CPU, fp32, same numpy inputs: the port's
plain forward (O, LSE) and backward (dQ, dK, dV) against the Pallas loop
kernels ``_flash_fwd_bhsd_loop`` / ``_flash_bwd_bhsd_loop`` run in
interpret mode, and the autograd ``flash_attention`` against ``jax.grad``
of the JAX ``flash_attention``."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the submodule)
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import flash_attention as tfa

jfa = sys.modules["paddle_tpu.ops.flash_attention"]

# fp32 on both sides; the kernels sum in 128-key blocks, the port in one
# pass per row, so only the order of fp32 sums differs (the JAX package's
# own kernel tests hold the loop kernels to the same 2e-5)
TOL = dict(rtol=2e-5, atol=2e-5)
# B, H, Hkv, Sq, Sk, D: GQA (two query heads per KV head), S = 256 in two
# 128-row blocks, and a bottom-right-aligned Sq < Sk case
SHAPES = [(1, 4, 2, 256, 256, 64), (1, 4, 2, 128, 256, 64)]
BLOCK = 128


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Run the JAX package's Pallas kernels in interpret mode, for this
    module only (as tests/test_flash_attention.py does)."""
    os.environ["PT_FLASH_INTERPRET"] = "1"
    yield
    os.environ.pop("PT_FLASH_INTERPRET", None)


def _inputs(B, H, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"Sq{s[3]}_Sk{s[4]}")
def test_plain_forward_matches_pallas_loop_kernel(shape, causal):
    q, k, v, _ = _inputs(*shape)
    s = 1.0 / math.sqrt(shape[-1])
    jo, jl = jfa._flash_fwd_bhsd_loop(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, s, BLOCK, BLOCK)
    to, tl = tfa._flash_fwd_plain(*_t(q, k, v), causal, s)
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    assert tuple(tl.shape) == shape[:2] + (shape[3],)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"Sq{s[3]}_Sk{s[4]}")
def test_plain_backward_matches_pallas_loop_kernels(shape, causal):
    """dQ and the GQA-summed dK/dV from the same (q, k, v, dO, LSE, delta)
    — the JAX forward's LSE and delta = rowsum(dO·O) feed both sides."""
    q, k, v, do = _inputs(*shape, seed=1)
    s = 1.0 / math.sqrt(shape[-1])
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa._flash_fwd_bhsd_loop(jq, jk, jv, causal, s, BLOCK, BLOCK)
    delta = np.array(jnp.sum(jdo * jo, axis=-1), np.float32)
    lse = np.array(jl, np.float32)
    want = jfa._flash_bwd_bhsd_loop(jq, jk, jv, jdo, jnp.asarray(lse),
                                    jnp.asarray(delta), causal, s, BLOCK,
                                    BLOCK)
    got = tfa._flash_bwd_plain(*_t(q, k, v, do, lse, delta), causal, s)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"Sq{s[3]}_Sk{s[4]}")
def test_autograd_flash_attention_matches_jax_grad(shape, causal):
    """Output and (dQ, dK, dV) of sum(out · dO) through the autograd
    Function against jax.value_and_grad of the JAX custom-vjp op."""
    q, k, v, do = _inputs(*shape, seed=2)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal) * do)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal)
    loss = (out * torch.from_numpy(do)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-4)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=name, **TOL)


# (B, H, Hkv, Sq, Sk, D, causal) that straddle the CUDA backward kernels'
# 128-row (dQ) and 128-key (dK/dV) blocks and their 64-row tiles: Sk = 130
# and 200, Sq = 300 against Sk = 1000 (bottom-right alignment), Sq < Sk
# across a block edge; GQA groups of 4 and 1, head dims 64 and 128
EDGE_SHAPES = [(1, 4, 1, 130, 130, 64, True), (1, 4, 4, 130, 130, 128, False),
               (1, 4, 1, 200, 200, 128, True), (1, 4, 4, 200, 200, 64, True),
               (1, 4, 1, 300, 1000, 128, True), (1, 4, 4, 300, 1000, 64, True),
               (1, 4, 1, 300, 1000, 64, False), (2, 4, 4, 130, 200, 128, True)]


def _edge_id(s):
    return f"Sq{s[3]}_Sk{s[4]}_g{s[1] // s[2]}_D{s[5]}_" + \
        ("causal" if s[6] else "full")


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=_edge_id)
def test_plain_backward_at_tile_edges_matches_jax_grad_of_reference(shape):
    """The plain backward (the CUDA kernels' twin), fed its own forward's
    LSE and delta = rowsum(dO·O), against jax.vjp of the JAX reference
    composition ``_ref_bhsd`` with cotangent dO. fp32 on both sides; TOL
    (2e-5): the reference normalises each softmax row by its sum, the port
    subtracts the LSE, so only fp32 rounding and sum order differ."""
    B, H, Hkv, Sq, Sk, D, causal = shape
    q, k, v, do = _inputs(B, H, Hkv, Sq, Sk, D, seed=6)
    s = 1.0 / math.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: jfa._ref_bhsd(a, b, c, causal, s),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa._flash_fwd_plain(tq, tk, tv, causal, s)
    delta = (tdo * out).sum(-1)
    got = tfa._flash_bwd_plain(tq, tk, tv, tdo, lse, delta, causal, s)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("shape", [EDGE_SHAPES[5], EDGE_SHAPES[2]],
                         ids=_edge_id)
def test_plain_backward_at_tile_edges_matches_pallas_loop_kernels(shape):
    """Two of the edge shapes through the Pallas loop kernels in interpret
    mode (their blocks are the whole extent where 128 does not divide it),
    from the JAX forward's LSE and delta; TOL (2e-5), as the other
    loop-kernel tests."""
    B, H, Hkv, Sq, Sk, D, causal = shape
    q, k, v, do = _inputs(B, H, Hkv, Sq, Sk, D, seed=7)
    s = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa._flash_fwd_bhsd_loop(jq, jk, jv, causal, s, BLOCK, BLOCK)
    delta = np.array(jnp.sum(jdo * jo, axis=-1), np.float32)
    lse = np.array(jl, np.float32)
    want = jfa._flash_bwd_bhsd_loop(jq, jk, jv, jdo, jnp.asarray(lse),
                                    jnp.asarray(delta), causal, s, BLOCK,
                                    BLOCK)
    got = tfa._flash_bwd_plain(*_t(q, k, v, do, lse, delta), causal, s)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


# the edge shapes and a single query row against 1000 keys, where the CUDA
# forward's 128-row block holds one row and its second warpgroup none
FWD_EDGE_SHAPES = EDGE_SHAPES + [(1, 4, 1, 1, 1000, 128, True)]


def _jax_lse(q, k, causal, s):
    """fp32 logsumexp over keys of the JAX reference's logits (the
    composition of ``_ref_bhsd``: repeated K, masked logits -1e30)."""
    q, k = jnp.asarray(q), jnp.asarray(k)
    k = jnp.repeat(k, q.shape[1] // k.shape[1], axis=1)
    logits = jnp.einsum("bhsd,bhtd->bhst", q, k).astype(jnp.float32) * s
    if causal:
        sq, sk = logits.shape[-2:]
        logits = jnp.where(jnp.tril(jnp.ones((sq, sk), bool), k=sk - sq),
                           logits, jfa.NEG_INF)
    return jax.nn.logsumexp(logits, axis=-1)


@pytest.mark.parametrize("shape", FWD_EDGE_SHAPES, ids=_edge_id)
def test_plain_forward_at_tile_edges_matches_jax_reference(shape):
    """The plain forward (the CUDA kernel's twin) against the JAX
    reference composition ``_ref_bhsd`` (O) and the logsumexp of its
    logits (LSE), fp32 on both sides; TOL (2e-5): only fp32 rounding and
    sum order differ."""
    B, H, Hkv, Sq, Sk, D, causal = shape
    q, k, v, _ = _inputs(B, H, Hkv, Sq, Sk, D, seed=8)
    s = 1.0 / math.sqrt(D)
    want = jfa._ref_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, s)
    out, lse = tfa._flash_fwd_plain(*_t(q, k, v), causal, s)
    assert tuple(out.shape) == want.shape and tuple(lse.shape) == (B, H, Sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), err_msg="o",
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k, causal,
                                                                s)),
                               err_msg="lse", **TOL)


@pytest.mark.parametrize("shape", [FWD_EDGE_SHAPES[-1], EDGE_SHAPES[3]],
                         ids=_edge_id)
def test_plain_forward_at_tile_edges_matches_pallas_loop_kernel(shape):
    """Two of those shapes through the Pallas loop kernel in interpret
    mode (O and LSE); TOL (2e-5), as the other loop-kernel tests."""
    B, H, Hkv, Sq, Sk, D, causal = shape
    q, k, v, _ = _inputs(B, H, Hkv, Sq, Sk, D, seed=9)
    s = 1.0 / math.sqrt(D)
    jo, jl = jfa._flash_fwd_bhsd_loop(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, s, BLOCK, BLOCK)
    out, lse = tfa._flash_fwd_plain(*_t(q, k, v), causal, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), err_msg="o",
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), err_msg="lse",
                               **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_composition_matches_jax(causal):
    q, k, v, _ = _inputs(1, 4, 2, 128, 256, 64, seed=3)
    s = 0.1
    want = jfa._ref_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, s)
    got = tfa._ref_bhsd(*_t(q, k, v), causal, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [200, 77])
def test_ragged_lengths_match_reference_and_bshd_layout(S):
    """Lengths that fill no 128-block exactly go through the same plain
    path (the kernels mask a ragged last tile; nothing falls back), and
    the (B, S, H, D) wrapper is the transpose of the BHSD op."""
    q, k, v, _ = _inputs(2, 4, 1, S, S, 32, seed=4)
    tq, tk, tv = _t(q, k, v)
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    ref = tfa._ref_bhsd(tq, tk, tv, True, 1.0 / math.sqrt(32))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    bshd = tfa.flash_attention_bshd(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2), causal=True)
    np.testing.assert_allclose(bshd.transpose(1, 2).numpy(), out.numpy(),
                               rtol=0, atol=0)


def test_cpu_tensors_never_launch_and_cuda_wrappers_refuse_them():
    q, k, v, do = _t(*_inputs(1, 2, 1, 16, 16, 128, seed=5))
    tops.reset_launch_counts()
    tq = q.clone().requires_grad_()
    tfa.flash_attention(tq, k, v, causal=True).sum().backward()
    counts = tops.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 0
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_fwd_cuda(q, k, v, True, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_bwd_dq_cuda(q, k, v, do, lse, lse, True, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_bwd_dkv_cuda(q, k, v, do, lse, lse, True, 0.1)
