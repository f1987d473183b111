"""GPT in the port (``paddle_tpu_torch/models/gpt.py``) against the JAX
model on the CPU in fp32, with the JAX weights carried over by
``models/convert.py``'s ``gpt_params_from_jax``: the forward's logits (the
reference attention at S = 12, the flash path's plain twin at S = 128 with
head dim 64), the loss, the prefill's caches and hidden states, and the
decode step at each position; the conversion's name and shape checks and
the options that are not ported yet."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.jit import state_values
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small_config
from paddle_tpu_torch.models.convert import (gpt_param_shapes,
                                             gpt_params_from_jax)
from paddle_tpu_torch.models.gpt import GPTConfig

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=160, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# head dim 64: the flash path at S % 128 == 0
D64 = dict(TINY, hidden_size=128, num_attention_heads=2)
# fp32 on both sides: summation order only
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg_kw, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**cfg_kw))
    jm.eval()
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLM(cfg, device="cpu", seed=seed)
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    tm.load_state_dict(gpt_params_from_jax(state, cfg, device="cpu"))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.mark.parametrize("cfg_kw,S", [(TINY, 12), (D64, 128)],
                         ids=["sdpa_ref", "flash_d64"])
def test_forward_logits_and_loss_match_jax(cfg_kw, S):
    jm, tm = _pair(cfg_kw, seed=1)
    ids = np.random.RandomState(0).randint(0, 96, (2, S)).astype(np.int32)
    labels = np.random.RandomState(1).randint(0, 96, (2, S)).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids)).value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
        loss = tm.loss_fn(got, torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jloss = jm.loss_fn(paddle.to_tensor(want), paddle.to_tensor(labels))
    np.testing.assert_allclose(float(loss), float(np.asarray(jloss.value)),
                               rtol=1e-5)


def _caches(B, L, cfg, zeros):
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    return [(zeros((B, L, cfg["num_attention_heads"], hd)),
             zeros((B, L, cfg["num_attention_heads"], hd)))
            for _ in range(cfg["num_hidden_layers"])]


def test_prefill_hidden_and_caches_match_jax(tiny):
    jm, tm = tiny
    B, P, L = 2, 7, 16
    ids = np.random.RandomState(2).randint(0, 96, (B, P)).astype(np.int32)
    jh, jc = jm.transformer.prefill(
        paddle.to_tensor(ids),
        _caches(B, L, TINY, lambda s: Tensor(np.zeros(s, np.float32))))
    with torch.no_grad():
        th, tc = tm.transformer.prefill(torch.from_numpy(ids),
                                        _caches(B, L, TINY, torch.zeros))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh.value), **TOL)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk.value), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv.value), **TOL)


def test_decode_step_matches_jax_at_each_position(tiny):
    """The decode step (wpe read at pos, the token's K/V written at pos)
    after a prefill, position after position, against JAX's: hidden
    states and caches."""
    jm, tm = tiny
    B, P, L = 2, 4, 12
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 96, (B, P)).astype(np.int32)
    _, jc = jm.transformer.prefill(
        paddle.to_tensor(ids),
        _caches(B, L, TINY, lambda s: Tensor(np.zeros(s, np.float32))))
    with torch.no_grad():
        _, tc = tm.transformer.prefill(torch.from_numpy(ids),
                                       _caches(B, L, TINY, torch.zeros))
    for pos in range(P, P + 5):
        tok = rng.randint(0, 96, (B, 1)).astype(np.int32)
        jh, jc = jm.transformer.decode_step(paddle.to_tensor(tok), jc, pos)
        with torch.no_grad():
            th, tc = tm.transformer.decode_step(
                torch.from_numpy(tok), tc, torch.tensor(pos))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh.value), **TOL)
        for (tk, tv), (jk, jv) in zip(tc, jc):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk.value),
                                       **TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv.value),
                                       **TOL)


def test_decode_step_takes_a_position_a_row(tiny):
    """Per-row positions (as a slot batch): each row equals its own
    single-row step at its position."""
    _, tm = tiny
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, 96, (2, 6)).astype(np.int32))
    with torch.no_grad():
        _, c = tm.transformer.prefill(ids, _caches(2, 12, TINY, torch.zeros))
        tok = torch.tensor([[5], [9]], dtype=torch.int32)
        both, _ = tm.transformer.decode_step(
            tok, [(k.clone(), v.clone()) for k, v in c],
            torch.tensor([6, 3]))
        for b, pos in ((0, 6), (1, 3)):
            one, _ = tm.transformer.decode_step(
                tok[b:b + 1], [(k[b:b + 1].clone(), v[b:b + 1].clone())
                               for k, v in c], pos)
            torch.testing.assert_close(both[b:b + 1], one, **TOL)


def test_param_shapes_and_conversion_checks(tiny):
    jm, tm = tiny
    cfg = GPTConfig(**TINY)
    shapes = gpt_param_shapes(cfg)
    assert shapes == {n: tuple(p.shape) for n, p in tm.named_parameters()}
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    assert set(shapes) == set(state)
    bad = dict(state)
    bad.pop("transformer.ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        gpt_params_from_jax(bad, cfg, device="cpu")
    bad = dict(state, **{"transformer.wpe.weight": np.zeros((4, 32))})
    with pytest.raises(ValueError, match="wpe.weight"):
        gpt_params_from_jax(bad, cfg, device="cpu")
    bf = gpt_params_from_jax(state, GPTConfig(**TINY, dtype="bfloat16"),
                             device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in bf.values())


def test_init_draws_from_the_seed_and_unported_options_raise(monkeypatch):
    cfg = GPTConfig(**TINY)
    a = GPTForCausalLM(cfg, device="cpu", seed=3)
    b = GPTForCausalLM(cfg, device="cpu", seed=3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    w = a.transformer.h[0].c_fc.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.004
    assert float(a.transformer.h[0].c_fc.bias.abs().sum()) == 0
    assert float(a.transformer.ln_f.weight.min()) == 1.0
    assert gpt2_small_config().hidden_size == 768
    # LoRA is ported: lora_rank wraps every block projection at
    # construction, over the base the same seed draws without it
    lo = GPTForCausalLM(GPTConfig(**TINY, lora_rank=4), device="cpu", seed=3)
    assert type(lo.transformer.h[0].c_attn).__name__ == "LoRALinear"
    assert torch.equal(lo.transformer.h[0].c_fc.base.weight, w)
    a.attach_lora(4)
    assert a.merge_lora() is a
    assert torch.equal(a.transformer.h[0].c_fc.weight, w)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(cfg)
