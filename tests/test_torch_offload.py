"""The port's offload paths on the CPU: ``offload_opt_state`` refuses what
the JAX engine refuses (a model without pinned host memory beside it, a
mesh, the flat ``PT_MT_ADAMW`` state, an optimizer without a per-parameter
rule); the windowed transfer chain's plan (``PT_OFFLOAD_WINDOW``,
``PT_OFFLOAD_ORDER``) and the offloaded update on CPU tensors, bit for bit
the resident one; and ``remat_policy="offload_attn"``'s step against the
JAX engine's ``"nothing"`` policy (the JAX CPU backend has no pinned host
memory to offload to) and, bit for bit, the port's own."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import SGD, AdamW, Optimizer
from paddle_tpu_torch.parallel import ParallelEngine
from paddle_tpu_torch.parallel.offload import (OffloadedState, schedule,
                                               window_and_order)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
B, S = 2, 16
# fp32: summation order only (a weight moves by a fraction of one step)
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=3):
    paddle.seed(seed)
    jm = JModel(JConfig(**TINY))
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)],
                            1).astype(np.int64)
    return ids, labels


def test_offload_opt_state_refuses_as_the_jax_engine(monkeypatch):
    jm, tm = _pair()
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters())
    one = Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))
    two = Mesh(np.array(jax.devices()[:2]).reshape(2), ("data",))
    # the JAX engine refuses a CPU backend: NotImplementedError where it
    # lists no pinned_host memory, the placement call's error where it
    # lists one it cannot place into
    with pytest.raises((NotImplementedError, jax.errors.JaxRuntimeError)):
        JEngine(jm, optimizer=jopt, mesh=one, offload_opt_state=True)
    with pytest.raises(NotImplementedError, match="single-device"):
        JEngine(jm, optimizer=jopt, mesh=two, offload_opt_state=True)
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    with pytest.raises(NotImplementedError, match="pinned host"):
        ParallelEngine(tm, optimizer=opt, offload_opt_state=True)
    with pytest.raises(NotImplementedError, match="single-device"):
        ParallelEngine(tm, optimizer=opt, offload_opt_state=True,
                       mesh=type("Mesh", (), {"size": 2}))
    monkeypatch.setenv("PT_MT_ADAMW", "1")
    with pytest.raises(ValueError, match="mutually exclusive"):
        JEngine(jm, optimizer=JAdamW(parameters=jm.parameters()), mesh=one,
                offload_opt_state=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ParallelEngine(tm, optimizer=AdamW(
            parameters=tm.named_parameters()), offload_opt_state=True)
    monkeypatch.delenv("PT_MT_ADAMW")
    # an optimizer without a per-parameter rule, past the device check

    class NoRule(Optimizer):
        pass

    eng = ParallelEngine(tm, optimizer=opt)
    eng.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="per-param update rule"):
        eng._build_offload(NoRule(parameters=tm.named_parameters()))


def test_the_windowed_chain_follows_the_jax_order(monkeypatch):
    names = ["b", "a", "d", "c", "e"]
    # backward (default): reversed sorted names; W = 2 staging sets, the
    # copy into a set waits for the copy back of its previous user
    assert schedule(names, 2, "backward") == [
        ("e", 0, None), ("d", 1, None), ("c", 0, 0), ("b", 1, 1),
        ("a", 0, 2)]
    assert schedule(names, 1, "forward") == [
        ("a", 0, None), ("b", 0, 0), ("c", 0, 1), ("d", 0, 2), ("e", 0, 3)]
    assert [k for _, k, _ in schedule(names, 3, "forward")] == [0, 1, 2, 0,
                                                                1]
    monkeypatch.delenv("PT_OFFLOAD_WINDOW", raising=False)
    monkeypatch.delenv("PT_OFFLOAD_ORDER", raising=False)
    assert window_and_order() == (2, "backward")
    monkeypatch.setenv("PT_OFFLOAD_WINDOW", "0")
    monkeypatch.setenv("PT_OFFLOAD_ORDER", "forward")
    assert window_and_order() == (1, "forward")
    monkeypatch.setenv("PT_OFFLOAD_ORDER", "sideways")
    with pytest.raises(ValueError, match="PT_OFFLOAD_ORDER"):
        window_and_order()


@pytest.mark.parametrize("make", [
    lambda named: AdamW(learning_rate=1e-2, parameters=named,
                        multi_precision=True),
    lambda named: SGD(learning_rate=1e-2, parameters=named,
                      weight_decay=0.01)], ids=["adamw_master", "sgd"])
def test_the_offloaded_update_is_the_resident_one_bit_for_bit(make):
    g = torch.Generator().manual_seed(0)
    shapes = {"a.weight": (6, 10), "b.bias": (10,), "c.weight": (3, 5, 4),
              "d": (7,)}
    vals = {n: torch.randn(s, generator=g).bfloat16() for n, s in
            shapes.items()}
    res = [(n, torch.nn.Parameter(v.clone())) for n, v in vals.items()]
    off = [(n, torch.nn.Parameter(v.clone())) for n, v in vals.items()]
    ropt, oopt = make(res), make(off)
    ropt.init_state(res)
    state = OffloadedState(oopt, off, window=2, order="backward")
    assert len(state.staging) == 2 and not state.pinned
    assert oopt._accumulators is state.host and oopt._runner == state.run
    assert set(state.host) == set(shapes)
    for step in range(1, 4):
        grads = {n: torch.randn(s, generator=g).bfloat16()
                 for n, s in shapes.items()}
        ropt.update([(n, p, grads[n]) for n, p in res], 1e-2, step)
        oopt.update([(n, p, grads[n]) for n, p in off], 1e-2, step)
    for (n, a), (_, b) in zip(res, off):
        assert torch.equal(a, b), n
        for k, v in ropt._accumulators[n].items():
            assert torch.equal(v, state.host[n][k]), (n, k)


def test_offload_attn_step_matches_jax_nothing_and_the_ports_nothing():
    jm, tm = _pair(seed=5)
    _, tm2 = _pair(seed=5)
    ids, labels = _batch(TINY["vocab_size"], seed=2)
    jeng = JEngine(jm, optimizer=JAdamW(learning_rate=1e-3,
                                        parameters=jm.parameters()),
                   remat=True, remat_policy="nothing")
    teng = ParallelEngine(tm, optimizer=AdamW(
        learning_rate=1e-3, parameters=tm.named_parameters()), remat=True,
        remat_policy="offload_attn")
    nothing = ParallelEngine(tm2, optimizer=AdamW(
        learning_rate=1e-3, parameters=tm2.named_parameters()), remat=True,
        remat_policy="nothing")
    for _ in range(2):
        jl = float(jeng.train_batch(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels)))
        tl = teng.train_batch(torch.from_numpy(ids).long(),
                              torch.from_numpy(labels))
        nl = nothing.train_batch(torch.from_numpy(ids).long(),
                                 torch.from_numpy(labels))
        np.testing.assert_allclose(tl.item(), jl, **TOL)
        assert torch.equal(tl, nl)
    # two anchors a layer kept in the step's host buffers
    assert len(teng.host_stash.bufs) == 2 * TINY["num_hidden_layers"]
    js = jeng.engine_state_dict()
    for (n, p), (_, q) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(p, q), n
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(js["params"][n]), err_msg=n,
                                   **PARAM_TOL)
