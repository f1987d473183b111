"""The streaming flash forms of the PyTorch port (rows 2, 5 and 6 of the
kernel table) on the CPU, fp32: the port's ``_flash_fwd_bhsd_stream`` /
``_flash_bwd_bhsd_stream`` (their plain versions on CPU tensors) against
the JAX package's Pallas stream kernels in interpret mode with 128-row
blocks (a multi-block grid, as ``tests/test_flash_attention.py`` forces
it); the dispatch that takes them past ``_FULL_K_MAX`` keys, read by the
route taken on CPU and on (pretended) CUDA tensors without running a
kernel; and the wrappers' guard against tensors of 2**31 elements or
more, on meta tensors that allocate nothing."""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the submodule)
import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import flash_attention_cuda as tfac

jfa = sys.modules["paddle_tpu.ops.flash_attention"]

# fp32 on both sides, only the order of fp32 sums differs (the JAX
# package's own stream-kernel test holds O to 2e-5 and the gradients to
# 1e-4)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 128


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Run the JAX package's Pallas kernels in interpret mode, for this
    module only (as tests/test_flash_attention.py does)."""
    os.environ["PT_FLASH_INTERPRET"] = "1"
    yield
    os.environ.pop("PT_FLASH_INTERPRET", None)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    k = rng.standard_normal((1, 1, 256, 64)).astype(np.float32)
    v = rng.standard_normal((1, 1, 256, 64)).astype(np.float32)
    do = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
def test_stream_forms_match_the_pallas_stream_kernels(causal):
    """Forward (O, LSE) and backward (dQ, dK, dV) from the same inputs;
    the backward on both sides takes the JAX forward's LSE and
    delta = rowsum(dO·O)."""
    q, k, v, do = _inputs(20 + causal)
    s = 1.0 / math.sqrt(64)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa._flash_fwd_bhsd_stream(jq, jk, jv, causal, s,
                                        block_q=BLOCK, block_k=BLOCK)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tl = tfa._flash_fwd_bhsd_stream(tq, tk, tv, causal, s)
    assert to.dtype == tl.dtype == torch.float32
    assert tuple(tl.shape) == (1, 2, 256)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    delta = np.array(jnp.sum(jdo * jo, axis=-1), np.float32)
    lse = np.array(jl, np.float32)
    want = jfa._flash_bwd_bhsd_stream(jq, jk, jv, jdo, jnp.asarray(lse),
                                      jnp.asarray(delta), causal, s,
                                      block_q=BLOCK, block_k=BLOCK)
    got = tfa._flash_bwd_bhsd_stream(tq, tk, tv, tdo, torch.from_numpy(lse),
                                     torch.from_numpy(delta), causal, s)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


def _recorder(log, tag, result):
    def fn(*args):
        log.append(tag)
        return result
    return fn


@pytest.mark.parametrize("cuda", [False, True], ids=["cpu", "cuda"])
@pytest.mark.parametrize("sk", [tfa._FULL_K_MAX, tfa._FULL_K_MAX + 1])
def test_dispatch_takes_the_stream_form_exactly_past_full_k_max(
        monkeypatch, sk, cuda):
    """Sk <= 8192 keys take the loop form, Sk > 8192 the streaming one (as
    in JAX): on CPU tensors both end in the plain versions, on CUDA
    tensors in the loop or the stream kernels' wrappers, never crossed."""
    log = []
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 1, sk, 8)
    rows = torch.zeros(1, 2, 4)
    monkeypatch.setattr(tops, "use_kernel", lambda x: cuda)
    monkeypatch.setattr(tfa, "_flash_fwd_plain",
                        _recorder(log, "fwd_plain", (q, rows)))
    monkeypatch.setattr(tfa, "_flash_bwd_plain",
                        _recorder(log, "bwd_plain", (q, k, k)))
    for name in ("flash_fwd_cuda", "flash_fwd_stream_cuda"):
        monkeypatch.setattr(tfac, name, _recorder(log, name, (q, rows)))
    for name in ("flash_bwd_dq_cuda", "flash_bwd_dq_stream_cuda"):
        monkeypatch.setattr(tfac, name, _recorder(log, name, q))
    for name in ("flash_bwd_dkv_cuda", "flash_bwd_dkv_stream_cuda"):
        monkeypatch.setattr(tfac, name, _recorder(log, name, (k, k)))
    tfa._flash_fwd_bhsd(q, k, k, True, 0.1)
    tfa._flash_bwd_bhsd(q, k, k, q, rows, rows, True, 0.1)
    stream = sk > tfa._FULL_K_MAX
    if not cuda:
        assert log == ["fwd_plain", "bwd_plain"]
    elif stream:
        assert log == ["flash_fwd_stream_cuda", "flash_bwd_dq_stream_cuda",
                       "flash_bwd_dkv_stream_cuda"]
    else:
        assert log == ["flash_fwd_cuda", "flash_bwd_dq_cuda",
                       "flash_bwd_dkv_cuda"]


@pytest.mark.parametrize("name", ["flash_fwd_stream_cuda",
                                  "flash_bwd_dq_stream_cuda",
                                  "flash_bwd_dkv_stream_cuda",
                                  "flash_fwd_cuda"])
@pytest.mark.parametrize("which", ["q", "kv"])
def test_wrappers_refuse_tensors_of_2_31_elements(name, which):
    """B·H·S·D of 2**31 or more (here 1·32·2**19·128) raises a ValueError
    before anything is launched or allocated: the kernels' 32-bit row and
    batch·head products must not wrap."""
    big = torch.empty(1, 32, 2 ** 19, 128, dtype=torch.bfloat16,
                      device="meta")
    small_q = torch.empty(1, 32, 8, 128, dtype=torch.bfloat16, device="meta")
    small_kv = torch.empty(1, 8, 8, 128, dtype=torch.bfloat16, device="meta")
    if which == "q":
        q, kv = big, small_kv
    else:
        q, kv = small_q, torch.empty(1, 8, 2 ** 21, 128,
                                     dtype=torch.bfloat16, device="meta")
    assert max(q.numel(), kv.numel()) >= 2 ** 31
    rows = torch.empty(q.shape[:3], device="meta")
    fn = getattr(tfac, name)
    args = (q, kv, kv, True, 0.1) if "fwd" in name else \
        (q, kv, kv, q, rows, rows, True, 0.1)
    before = fn.launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        fn(*args)
    assert fn.launches == before
