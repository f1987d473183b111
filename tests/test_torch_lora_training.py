"""LoRA training in the port (``paddle_tpu_torch/nn/lora.py``, Llama's and
GPT's ``lora_rank`` / ``attach_lora`` / ``merge_lora``, the engine's
trainable parameters) against the JAX package on the CPU in fp32, with the
same seeded numpy inputs: attach, forward, merge, the adapter state and
its ``.npz`` export read by the other package; three engine steps of a
2-layer Llama with ``lora_rank=4``; GPT's attach and merge; the train →
export → serve round trip on the paged server; and the repaired fault: a
parameter the user froze was trained by the port's engine."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn import lora as jlora
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.inference.lora import AdapterRegistry, LoRAConfig
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import (gpt_params_from_jax,
                                             params_from_jax)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import lora as tlora
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32", use_flash_attention=False)
GPT_TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
B, S, STEPS = 2, 16, 3
# fp32 on both sides: the same products summed in another order
TOL = dict(rtol=1e-5, atol=1e-5)
# after three Adam steps a factor moves by ~lr·m/sqrt(v) a step, where a
# tiny gradient's ratio amplifies the sums' fp32 noise
FACTOR_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kick_b(jm, seed):
    """Move every JAX ``lora_B`` off its zero init (a stand-in for
    training), seeded."""
    rng = np.random.RandomState(seed)
    for _, layer in jm.named_sublayers(include_self=True):
        if isinstance(layer, jlora.LoRALinear):
            layer.lora_B.set_value(rng.normal(
                0, 0.05, layer.lora_B.shape).astype(np.float32))


def _llama_pair(seed=3, kick=True, **kw):
    cfg_kw = dict(TINY, **kw)
    paddle.seed(seed)
    jm = JModel(JConfig(**cfg_kw))
    if kick:
        _kick_b(jm, seed)
    cfg = LlamaConfig(**cfg_kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _ids(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


def _logits(jm, tm, ids):
    jl = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids).long()).numpy()
    return jl, tl


def test_attach_merge_state_and_adapter_files_across_packages(tmp_path):
    jm, tm = _llama_pair(lora_rank=4, lora_alpha=8.0)
    assert sum(isinstance(m, tlora.LoRALinear) for m in tm.modules()) == \
        2 * 7
    assert len(tlora.lora_parameters(tm)) == len(jlora.lora_parameters(jm))
    ids = _ids(TINY["vocab_size"])
    jl, tl = _logits(jm, tm, ids)
    np.testing.assert_allclose(tl, jl, **TOL)
    # the adapter state, key for key and array for array
    js, ts = jlora.lora_state(jm), tlora.lora_state(tm)
    assert set(js) == set(ts) and js["__meta__"] == ts["__meta__"]
    for k in (k for k in js if k != "__meta__"):
        for ab in ("A", "B"):
            np.testing.assert_array_equal(ts[k][ab], js[k][ab], err_msg=k)
    # a file either package wrote, read by the other
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jlora.export_adapter(jm, jpath)
    tlora.export_adapter(tm, tpath)
    for got in (tlora.load_adapter(jpath), jlora.load_adapter(tpath)):
        assert set(got) == set(js) and got["__meta__"] == js["__meta__"]
        for k in (k for k in js if k != "__meta__"):
            np.testing.assert_array_equal(got[k]["A"], js[k]["A"])
            np.testing.assert_array_equal(got[k]["B"], js[k]["B"])
    # load_lora_state into a fresh port model with LoRA attached
    fresh = LlamaForCausalLM(LlamaConfig(**TINY, lora_rank=4,
                                         lora_alpha=8.0), device="cpu")
    fresh.load_state_dict(tm.state_dict())
    with torch.no_grad():
        for p in tlora.lora_parameters(fresh):
            p.zero_()
    tlora.load_lora_state(fresh, tlora.load_adapter(jpath))
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh(torch.from_numpy(ids).long()).numpy(), tl)
    # merge: plain projections back, the delta folded in
    jm.merge_lora()
    assert tm.merge_lora() is tm
    assert not any(isinstance(m, tlora.LoRALinear) for m in tm.modules())
    w = tm.model.layers[1].mlp.up_proj.weight
    assert getattr(w, "trainable", True)
    np.testing.assert_allclose(
        w.detach().numpy(),
        np.asarray(jm.model.layers[1].mlp.up_proj.weight.numpy()), **TOL)
    jl2, tl2 = _logits(jm, tm, ids)
    np.testing.assert_allclose(tl2, jl2, **TOL)
    np.testing.assert_allclose(tl2, tl, **TOL)


def test_lora_rank_keeps_the_seeds_base_and_freezes_it():
    cfg = LlamaConfig(**TINY, lora_rank=4, lora_targets=("q_proj",
                                                         "down_proj"))
    lo = LlamaForCausalLM(cfg, device="cpu", seed=5)
    plain = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=5)
    base = dict(plain.named_parameters())
    for n, p in lo.named_parameters():
        if n.endswith(("lora_A", "lora_B")):
            assert p.dtype == torch.float32 and p.requires_grad
            continue
        assert torch.equal(p, base[n.replace(".base", "")]), n
        assert getattr(p, "trainable", True) == (".base." not in n), n
    with pytest.raises(ValueError, match="no Linear targets"):
        tlora.attach_lora(plain, 2, targets=("nope",))
    with pytest.raises(ValueError, match="rank"):
        plain.attach_lora(0)


def _freeze_all_but_lora(jm):
    for n, p in jm.named_parameters():
        if "lora_" not in n:
            p.trainable = False
            p.stop_gradient = True


def test_three_lora_engine_steps_match_jax_and_leave_the_base():
    jm, tm = _llama_pair(kick=False, lora_rank=4, lora_alpha=8.0)
    _freeze_all_but_lora(jm)
    jeng = JEngine(jm, optimizer=JAdamW(
        learning_rate=1e-2, parameters=jlora.lora_parameters(jm)))
    teng = ParallelEngine(tm, optimizer=AdamW(
        learning_rate=1e-2, parameters=tlora.lora_parameters(tm)))
    assert {n for n, _ in teng.trained} == {
        n for n, _ in tm.named_parameters() if "lora_" in n}
    base0 = {n: p.detach().clone() for n, p in tm.named_parameters()
             if "lora_" not in n}
    ids = _ids(TINY["vocab_size"], seed=1)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)],
                            1).astype(np.int64)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids).long(),
                                   torch.from_numpy(labels)).item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    assert set(ts["opt_state"]) == set(js["opt_state"]) == {
        n for n, _ in teng.trained}
    for n, p in tm.named_parameters():
        if "lora_" in n:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(js["params"][n]),
                                       err_msg=n, **FACTOR_TOL)
        else:
            assert torch.equal(p, base0[n]), n
            np.testing.assert_array_equal(np.asarray(js["params"][n]),
                                          base0[n].numpy(), err_msg=n)
    assert any(not torch.equal(p, torch.zeros_like(p))
               for n, p in tm.named_parameters() if n.endswith("lora_B"))


def test_gpt_attach_and_merge_match_jax():
    kw = dict(GPT_TINY, lora_rank=2, lora_alpha=4.0)
    paddle.seed(2)
    jm = JGPT(JGPTConfig(**kw))
    _kick_b(jm, 2)
    jm.eval()
    cfg = GPTConfig(**kw)
    tm = GPTForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    assert any(k.endswith("c_attn.base.bias") for k in state)
    tm.load_state_dict(gpt_params_from_jax(state, cfg, device="cpu"))
    tm.eval()
    assert tm.transformer.h[0].c_attn.lora_A.dtype == torch.float32
    ids = _ids(GPT_TINY["vocab_size"], seed=4)
    jl, tl = _logits(jm, tm, ids)
    np.testing.assert_allclose(tl, jl, **TOL)
    jm.merge_lora()
    tm.merge_lora()
    jl2, tl2 = _logits(jm, tm, ids)
    np.testing.assert_allclose(tl2, jl2, **TOL)
    np.testing.assert_allclose(tl2, tl, **TOL)


def test_train_export_serve_roundtrip(tmp_path):
    """The port of ``tests/test_lora_serving.py::test_train_export_serve_
    roundtrip``: the train-side checkpoint through ``load_adapter``, the
    registry and the paged server gives the tokens of the same model
    with ``merge_lora`` folded in, served plain."""
    cfg = LlamaConfig(**dict(TINY, max_position_embeddings=160))
    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    tuned = copy.deepcopy(model)
    tlora.attach_lora(tuned, rank=4, alpha=8.0,
                      targets=("q_proj", "v_proj", "up_proj"))
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for layer in tuned.modules():
            if isinstance(layer, tlora.LoRALinear):
                layer.lora_B.copy_(torch.from_numpy(rng.normal(
                    0, 0.05, tuple(layer.lora_B.shape)).astype(np.float32)))
    path = str(tmp_path / "adapter.npz")
    tlora.export_adapter(tuned, path)
    reg = AdapterRegistry()
    reg.register("tuned", tlora.load_adapter(path))
    kw = dict(max_len=64, cache="paged", block_size=4, prefill_chunk=8,
              device="cpu")
    srv = GenerationServer(model, max_batch=2,
                           lora=LoRAConfig(reg, max_live_adapters=2,
                                           max_rank=4,
                                           targets=("q", "v", "up")), **kw)
    prompt = [3, 14, 15, 9, 2, 6, 5]
    rid = srv.submit(prompt, max_new_tokens=10, adapter="tuned")
    got = srv.run()[rid]
    merged = tlora.merge_lora(tuned, targets=("q_proj", "v_proj", "up_proj"))
    ref = GenerationServer(merged, max_batch=1, **kw)
    rr = ref.submit(prompt, max_new_tokens=10)
    assert got == ref.run()[rr]


def test_a_frozen_parameter_rides_the_step_unchanged():
    """The repaired fault: the port's engine called ``requires_grad_(True)``
    on every parameter and trained the ones the user froze. Freeze the
    embedding in both packages; after three steps JAX leaves it as it
    was, and so does the port (bit for bit, with no optimizer state),
    while the rest trains as in JAX; replacing the frozen weight after a
    capture still raises (the weight key covers it)."""
    jm, tm = _llama_pair(kick=False)
    jm.model.embed_tokens.weight.trainable = False
    jm.model.embed_tokens.weight.stop_gradient = True
    tm.model.embed_tokens.weight.trainable = False
    jeng = JEngine(jm, optimizer=JAdamW(learning_rate=1e-3,
                                        parameters=jm.parameters()))
    teng = ParallelEngine(tm, optimizer=AdamW(
        learning_rate=1e-3, parameters=tm.named_parameters()))
    emb0 = tm.model.embed_tokens.weight.detach().clone()
    ids = _ids(TINY["vocab_size"], seed=2)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)],
                            1).astype(np.int64)
    for _ in range(STEPS):
        jloss = float(jeng.train_batch(paddle.to_tensor(ids),
                                       paddle.to_tensor(labels)))
        tloss = teng.train_batch(torch.from_numpy(ids).long(),
                                 torch.from_numpy(labels)).item()
        np.testing.assert_allclose(tloss, jloss, **TOL)
    name = "model.embed_tokens.weight"
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    np.testing.assert_array_equal(np.asarray(js["params"][name]),
                                  emb0.numpy())
    assert torch.equal(tm.model.embed_tokens.weight, emb0)
    assert not tm.model.embed_tokens.weight.requires_grad
    assert name not in ts["opt_state"] and name not in js["opt_state"]
    assert set(ts["opt_state"]) == set(js["opt_state"])
    w = "model.layers.0.mlp.gate_proj.weight"
    np.testing.assert_allclose(ts["params"][w], np.asarray(js["params"][w]),
                               **FACTOR_TOL)
    teng._weights = teng._weights_key()
    teng.check_weights()
    tm.model.embed_tokens.weight = torch.nn.Parameter(emb0.clone(),
                                                      requires_grad=False)
    with pytest.raises(RuntimeError, match="replaced"):
        teng.check_weights()
