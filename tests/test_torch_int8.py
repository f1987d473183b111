"""Weight-only int8 in the PyTorch port (``paddle_tpu_torch/ops/int8.py``,
``nn/quant``, ``LlamaForCausalLM.quantize_int8``, ``models/convert.py``)
against the JAX package on the CPU: per-channel codes and scales bitwise,
the kernel's plain twin against the Pallas ``_w8_matmul_pallas`` in
interpret mode, the shape rule that picks the streaming kernel, and a
quantized model's logits and paged decode against the JAX quantized model
on the same codes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.framework.core import Tensor
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import int8 as jint8
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.models.convert import param_shapes, params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.quant import Int8Linear
from paddle_tpu_torch.ops import int8 as tint8

# hidden 128 (multiples of 128 everywhere): decode rows stream int8
SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
# fp32 on both sides: the same exact products summed in another order,
# times the same scale
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    jops.set_kernel_mode("auto")
    tops.set_kernel_mode("auto")


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    jm.quantize_int8()
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu").quantize_int8()
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm, state


@pytest.mark.parametrize("shape", [(64, 128), (256, 384), (100, 7)])
def test_quantize_per_channel_is_bitwise_jax(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero column: the scale floor
    jq, js = jint8.quantize_per_channel(jnp.asarray(w))
    tq, ts = tint8.quantize_per_channel(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N", [(1, 128, 256), (8, 256, 384),
                                   (16, 384, 128)])
def test_w8_plain_matches_the_pallas_kernel_in_interpret_mode(M, K, N):
    """The twin follows the kernel's formula: exact code products summed in
    fp32, times the scale, rounded once; held against the Pallas kernel
    itself (interpret mode)."""
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jq, js = jint8.quantize_per_channel(jnp.asarray(w))
    jops.set_kernel_mode("pallas")
    want = np.asarray(jint8._w8_matmul_pallas(jnp.asarray(x), jq, js,
                                              jnp.float32))
    jops.set_kernel_mode("auto")
    got = tint8._w8_plain(torch.from_numpy(x),
                          torch.from_numpy(np.array(jq)),
                          torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("M,K,N,streams", [(8, 128, 256, True),
                                           (16, 256, 128, True),
                                           (128, 128, 256, True),
                                           (256, 128, 256, False),
                                           (8, 100, 256, False),
                                           (8, 128, 200, False)])
def test_w8_matmul_routes_by_shape(M, K, N, streams, monkeypatch):
    """Up to 128 rows with K and N multiples of 128 (decode ticks, verify
    windows, prefill chunks) take the kernel's plain twin on the CPU; the
    rest dequantize once, as JAX's ``w8_matmul`` outside Pallas. Both
    agree with the JAX function (which dequantizes past 16 rows)."""
    calls = []
    for name in ("_w8_plain", "_w8_dequant"):
        orig = getattr(tint8, name)
        monkeypatch.setattr(tint8, name, lambda *a, _o=orig, _n=name:
                            calls.append(_n) or _o(*a))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, M // 2 if M > 1 else 1, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    tq, ts = tint8.quantize_per_channel(torch.from_numpy(w))
    assert tint8.streams_int8(M, K, N) is streams
    tops.reset_launch_counts()
    got = tint8.w8_matmul(torch.from_numpy(x), tq, ts)
    assert got.shape == (*x.shape[:-1], N)
    assert calls == ["_w8_plain" if streams else "_w8_dequant"]
    assert tops.launch_counts()["w8_matmul"] == 0      # CPU: no kernel
    want = np.asarray(jint8.w8_matmul(jnp.asarray(x),
                                      jnp.asarray(tq.numpy()),
                                      jnp.asarray(ts.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_linear_from_linear():
    rng = np.random.default_rng(2)
    lin = torch.nn.Linear(128, 256, bias=False)
    w = (rng.standard_normal((128, 256)) * 0.05).astype(np.float32)
    lin.weight = torch.nn.Parameter(torch.from_numpy(w))   # (in, out)
    layer = Int8Linear.from_linear(lin)
    jq, js = jint8.quantize_per_channel(jnp.asarray(w))
    assert {n for n, _ in layer.named_buffers()} == {"weight_q",
                                                     "weight_scale"}
    assert not list(layer.parameters())
    np.testing.assert_array_equal(layer.weight_q.numpy(), np.asarray(jq))
    x = rng.standard_normal((3, 128)).astype(np.float32)
    np.testing.assert_allclose(
        layer(torch.from_numpy(x)).numpy(),
        np.asarray(jint8.w8_matmul(jnp.asarray(x), jq, js)), **TOL)
    with pytest.raises(ValueError, match="int8"):
        Int8Linear(torch.zeros(4, 4), torch.ones(4))


def test_params_from_jax_carries_an_int8_state(models):
    _, tm, state = models
    sd = tm.state_dict()
    want = param_shapes(tm.cfg, int8=True)
    assert set(state) == set(want)
    assert set(sd) == set(want)
    for name, arr in state.items():
        assert sd[name].dtype == (torch.int8 if name.endswith("weight_q")
                                  else torch.float32), name
        np.testing.assert_array_equal(sd[name].numpy(), arr)
    assert tm.quantized
    bad = dict(state)
    bad["lm_head.weight_q"] = bad["lm_head.weight_q"].astype(np.int16)
    with pytest.raises(ValueError, match="int8"):
        params_from_jax(bad, tm.cfg)


def test_quantize_int8_matches_jax_codes():
    """The port's own quantize_int8 of the same fp weights gives the JAX
    model's codes and scales, the embedding kept in the model dtype."""
    paddle.seed(5)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    jm.quantize_int8()
    tm.quantize_int8()
    want = {k: np.asarray(v) for k, v in state_values(jm).items()}
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), arr)


def test_quantized_model_logits_match_jax(models):
    """Dense forward (24 rows: every projection streams int8 through the
    kernel's plain twin, where JAX dequantizes) and a paged decode step (8
    rows: the projections and the lm-head stream in both)."""
    jm, tm, _ = models
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    jl = np.asarray(jm(Tensor(jnp.asarray(ids))).value)
    tl = tm(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(tl, jl, **TOL)
    N, bs, KV, D, B = 12, 4, 2, 32, 8
    tables = np.zeros((B, 4), np.int32)
    tables[:, 0] = np.arange(1, B + 1)
    pos = np.full((B,), 2, np.int32)
    tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
    jpools = [(Tensor(jnp.zeros((N, bs, KV, D), jnp.float32)),
               Tensor(jnp.zeros((N, bs, KV, D), jnp.float32)))
              for _ in range(2)]
    tpools = [(torch.zeros(N, bs, KV, D), torch.zeros(N, bs, KV, D))
              for _ in range(2)]
    jh, _ = jm.model.paged_decode_step(Tensor(jnp.asarray(tok)), jpools,
                                       jnp.asarray(tables), jnp.asarray(pos))
    th, _ = tm.model.paged_decode_step(torch.from_numpy(tok).long(), tpools,
                                       torch.from_numpy(tables),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh.value), **TOL)
    np.testing.assert_allclose(tm.head(th).numpy(),
                               np.asarray(jm.lm_head(jh).value), **TOL)


def test_dequantize_is_the_fp32_product_rounded_once():
    """The prefill path's one-pass dequantize equals ``(w_q · scale)`` in
    fp32 rounded to the activation dtype, as JAX's dequantize path."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    tq, ts = tint8.quantize_per_channel(torch.from_numpy(w))
    for dt in (torch.float32, torch.bfloat16):
        got = tint8.dequantize(tq, ts, dt)
        assert got.dtype == dt
        assert torch.equal(got, (tq.float() * ts).to(dt))
