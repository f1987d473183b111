"""The optimizer and engine surface of the port against the JAX package on
the CPU, with the same float32 / int32 numpy inputs: ``state_dict`` keys
and values (AdamW under a scheduler with ``multi_precision``),
``set_state_dict`` resuming bit for bit, ``set_lr`` / ``set_lr_scheduler``
followed by the engine, ``minimize`` and ``clear_gradients``, the L1 / L2
regularizers, ``lazy_mode``, ``lr_ratio``, Lamb's and Lars's exclusions,
the engine's ``state_dict`` / ``sync_to_model`` and the module functions
``parallelize`` / ``make_train_step``, the flat multi-tensor AdamW
(``PT_MT_ADAMW=1``) against JAX's flat path, and ``PT_CE_CHUNK``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.core import Parameter as JParam
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import fused_ce as jce
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu import regularizer as jreg
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import fused_ce as tce
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import (ParallelEngine, make_train_step,
                                       parallelize)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
B, S = 2, 16
# fp32 on both sides: summation order only; Adam's slots are sums of the
# same gradients, a weight moves by a fraction of one step
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
SLOT_TOL = dict(rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed, bf16=False):
    rng = np.random.default_rng(seed)
    vals = {"w": rng.normal(0, 0.5, (4, 8)).astype(np.float32),
            "b": rng.normal(0, 0.5, (8,)).astype(np.float32)}
    if bf16:   # bf16-exact values, so both packages start equal
        vals = {k: torch.from_numpy(v).bfloat16().float().numpy()
                for k, v in vals.items()}
    return vals


def _grads(seed, step, bf16=False):
    return _values(1000 * seed + step, bf16)


def _jparams(vals, dtype=jnp.float32):
    return [JParam(jnp.asarray(v).astype(dtype), name=n)
            for n, v in vals.items()]


def _tparams(vals, dtype=torch.float32):
    return [(n, torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype)))
            for n, v in vals.items()]


def _eager_steps(jo, jps, to, tps, steps, seed=0, bf16=False,
                 plant=None):
    """``steps`` eager steps of both optimizers on the same gradients."""
    for k in range(steps):
        g = _grads(seed, k, bf16)
        for p in jps:
            p.grad = JTensor(jnp.asarray(g[p.name]).astype(p.dtype))
        for n, p in tps:
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        jo.step()
        to.step()


def _host(v):
    return np.asarray(v.float().numpy() if isinstance(v, torch.Tensor)
                      else v, np.float32)


def _jhost(v):
    v = v.value if hasattr(v, "value") else v
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def test_adamw_state_dict_keys_and_values_match_jax():
    vals = _values(0, bf16=True)
    jps = _jparams(vals, jnp.bfloat16)
    tps = _tparams(vals, torch.bfloat16)
    jo = jopt.AdamW(learning_rate=jlr.StepDecay(0.01, step_size=1,
                                                 gamma=0.5),
                    parameters=jps, multi_precision=True)
    to = topt.AdamW(learning_rate=tlr.StepDecay(0.01, step_size=1,
                                                gamma=0.5),
                    parameters=tps, multi_precision=True)
    for _ in range(2):
        _eager_steps(jo, jps, to, tps, 1, bf16=True)
        jo._learning_rate.step()
        to._learning_rate.step()
    js, ts = jo.state_dict(), to.state_dict()
    assert set(ts) == set(js) == {
        "w.moment1", "w.moment2", "w.master_weight", "b.moment1",
        "b.moment2", "b.master_weight", "global_step", "LR_Scheduler"}
    assert ts["global_step"] == js["global_step"] == 2
    assert ts["LR_Scheduler"] == js["LR_Scheduler"]
    for k in (k for k in js if "." in k):
        tol = TOL if k.endswith("master_weight") else SLOT_TOL
        np.testing.assert_allclose(_host(ts[k]), _jhost(js[k]), err_msg=k,
                                   **tol)


def _clone_state(sd):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in sd.items()}


def test_set_state_dict_resumes_bit_for_bit():
    vals = _values(1)
    a_params = _tparams(vals)
    a = topt.AdamW(learning_rate=tlr.StepDecay(0.01, step_size=1),
                   parameters=a_params)
    for k in range(2):
        for n, p in a_params:
            p.grad = torch.from_numpy(_grads(1, k)[n])
        a.step()
        a._learning_rate.step()
    saved = _clone_state(a.state_dict())
    b_params = [(n, torch.nn.Parameter(p.detach().clone()))
                for n, p in a_params]
    b = topt.AdamW(learning_rate=tlr.StepDecay(0.01, step_size=1),
                   parameters=b_params)
    b.set_dict(saved)
    assert b._global_step == 2 and b.get_lr() == a.get_lr()
    for opt, params in ((a, a_params), (b, b_params)):
        for n, p in params:
            p.grad = torch.from_numpy(_grads(1, 2)[n])
        opt.step()
    for (n, pa), (_, pb) in zip(a_params, b_params):
        assert torch.equal(pa, pb), n
    sa, sb = a.state_dict(), b.state_dict()
    for k in (k for k in sa if "." in k):
        assert torch.equal(sa[k], sb[k]), k


def _llama_pair(seed=3):
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


def test_set_lr_and_set_lr_scheduler_reach_the_engines_next_step():
    jm, tm = _llama_pair()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    jeng, teng = JEngine(jm, optimizer=jo), ParallelEngine(tm, optimizer=to)
    ids, labels = _batch(TINY["vocab_size"])
    losses = []
    for k in range(4):
        if k == 1:
            jo.set_lr(5e-3)
            to.set_lr(5e-3)
        if k == 2:
            jo.set_lr_scheduler(jlr.StepDecay(2e-3, step_size=1, gamma=0.5))
            to.set_lr_scheduler(tlr.StepDecay(2e-3, step_size=1, gamma=0.5))
            with pytest.raises(RuntimeError, match="LRScheduler"):
                jo.set_lr(1.0)
            with pytest.raises(RuntimeError, match="LRScheduler"):
                to.set_lr(1.0)
        losses.append((float(jeng.train_batch(paddle.to_tensor(ids),
                                              paddle.to_tensor(labels))),
                       teng.train_batch(torch.from_numpy(ids).long(),
                                        torch.from_numpy(labels)).item()))
        assert to.get_lr() == pytest.approx(jo.get_lr())
    np.testing.assert_allclose([t for _, t in losses],
                               [j for j, _ in losses], **TOL)
    assert float(teng._lr_dev) == pytest.approx(1e-3, rel=1e-6)
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)


def test_minimize_equals_backward_then_step_and_clear_gradients():
    _, tm = _llama_pair()
    twin = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    twin.load_state_dict(tm.state_dict())
    ids, labels = (torch.from_numpy(a).long()
                   for a in _batch(TINY["vocab_size"]))
    models = []
    for m, use_minimize in ((tm, True), (twin, False)):
        for p in m.parameters():
            p.requires_grad_(True)
        opt = topt.AdamW(learning_rate=1e-3,
                         parameters=m.named_parameters())
        loss = m(ids, labels)
        if use_minimize:
            assert opt.minimize(loss) == (None, None)
        else:
            loss.backward()
            opt.step()
        opt.clear_gradients()
        assert all(p.grad is None for p in m.parameters())
        models.append(m)
    for (n, a), b in zip(tm.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("kind", ["sgd_l1", "momentum_l2", "adam_l2"])
def test_regularizer_objects_match_jax(kind):
    vals = _values(2)
    jps, tps = _jparams(vals), _tparams(vals)
    if kind == "sgd_l1":
        jo = jopt.SGD(0.1, parameters=jps, weight_decay=jreg.L1Decay(0.05))
        to = topt.SGD(0.1, parameters=tps, weight_decay=treg.L1Decay(0.05))
    elif kind == "momentum_l2":
        jo = jopt.Momentum(0.1, parameters=jps,
                           weight_decay=jreg.L2Decay(0.05))
        to = topt.Momentum(0.1, parameters=tps,
                           weight_decay=treg.L2Decay(0.05))
    else:
        jo = jopt.Adam(0.01, parameters=jps, weight_decay=jreg.L2Decay(0.1))
        to = topt.Adam(0.01, parameters=tps, weight_decay=treg.L2Decay(0.1))
    _eager_steps(jo, jps, to, tps, 3, seed=2)
    for jp, (n, tp) in zip(jps, tps):
        np.testing.assert_allclose(_host(tp.detach()), _jhost(jp),
                                   err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("kind", ["lazy_mode", "lr_ratio", "lamb_exclude",
                                  "lars_exclude"])
def test_accepted_options_match_jax(kind):
    """``lazy_mode`` and the Lamb / Lars exclusions are accepted and
    ignored, as in JAX; ``lr_ratio`` scales the eager AdamW step's
    learning rate per parameter, as in JAX."""
    vals = _values(3)
    jps, tps = _jparams(vals), _tparams(vals)
    if kind == "lazy_mode":
        jo = jopt.Adam(0.01, parameters=jps, lazy_mode=True)
        to = topt.Adam(0.01, parameters=tps, lazy_mode=True)
    elif kind == "lr_ratio":
        jo = jopt.AdamW(0.01, parameters=jps,
                        lr_ratio=lambda p: 0.5 if p.ndim == 1 else 0.25)
        to = topt.AdamW(0.01, parameters=tps,
                        lr_ratio=lambda p: 0.5 if p.ndim == 1 else 0.25)
    elif kind == "lamb_exclude":
        jo = jopt.Lamb(0.01, parameters=jps,
                       exclude_from_weight_decay_fn=lambda n: True)
        to = topt.Lamb(0.01, parameters=tps,
                       exclude_from_weight_decay_fn=lambda n: True)
    else:
        jo = jopt.Lars(0.1, parameters=jps, exclude_from_weight_decay=["b"])
        to = topt.Lars(0.1, parameters=tps, exclude_from_weight_decay=["b"])
    _eager_steps(jo, jps, to, tps, 3, seed=3)
    for jp, (n, tp) in zip(jps, tps):
        np.testing.assert_allclose(_host(tp.detach()), _jhost(jp),
                                   err_msg=n, **PARAM_TOL)
    if kind == "lr_ratio":
        plain = _tparams(vals)
        po = topt.AdamW(0.01, parameters=plain)
        for k in range(3):
            for n, p in plain:
                p.grad = torch.from_numpy(_grads(3, k)[n])
            po.step()
        assert not torch.equal(plain[0][1], tps[0][1])


def test_engine_state_dict_sync_parallelize_and_make_train_step():
    jm, tm = _llama_pair()
    jeng = JEngine(jm, optimizer=jopt.AdamW(parameters=jm.parameters()))
    opt = topt.AdamW(parameters=tm.named_parameters())
    eng = parallelize(tm, opt)
    assert type(eng) is ParallelEngine and eng.optimizer is opt
    built = make_train_step(tm, None, topt.AdamW(
        parameters=tm.named_parameters()))
    assert built._train_step is not None
    ids, labels = _batch(TINY["vocab_size"])
    eng.train_batch(torch.from_numpy(ids).long(), torch.from_numpy(labels))
    jeng.train_batch(paddle.to_tensor(ids), paddle.to_tensor(labels))
    assert eng.sync_to_model() is None
    sd, jsd = eng.state_dict(), jeng.state_dict()
    assert set(sd) == set(jsd)
    for n, v in sd.items():
        assert v.data_ptr() == dict(tm.named_parameters())[n].data_ptr()
        np.testing.assert_allclose(v.numpy(), _jhost(jsd[n]), err_msg=n,
                                   **PARAM_TOL)


def _flat_engines(monkeypatch, flat):
    if flat:
        monkeypatch.setenv("PT_MT_ADAMW", "1")
    else:
        monkeypatch.delenv("PT_MT_ADAMW", raising=False)
    jm, tm = _llama_pair(seed=4)
    jeng = JEngine(jm, optimizer=jopt.AdamW(learning_rate=1e-3,
                                            parameters=jm.parameters()))
    teng = ParallelEngine(tm, optimizer=topt.AdamW(
        learning_rate=1e-3, parameters=tm.named_parameters()))
    return jeng, teng


def test_flat_adamw_matches_jax_flat_path_and_the_per_tensor_port(
        monkeypatch):
    jeng, teng = _flat_engines(monkeypatch, flat=True)
    assert set(jeng.opt_state) == set(teng.optimizer._accumulators) == {
        "__mt__"}
    ids, labels = _batch(TINY["vocab_size"], seed=5)
    for _ in range(3):
        jl = float(jeng.train_batch(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels)))
        tl = teng.train_batch(torch.from_numpy(ids).long(),
                              torch.from_numpy(labels)).item()
        np.testing.assert_allclose(tl, jl, **TOL)
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    for k in ("p", "moment1", "moment2"):
        tol = SLOT_TOL if k != "p" else PARAM_TOL
        np.testing.assert_allclose(ts["opt_state"]["__mt__"][k],
                                   np.asarray(js["opt_state"]["__mt__"][k]),
                                   err_msg=k, **tol)
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)
    # the parameters are views of the authoritative flat buffer
    flat = teng.optimizer._accumulators["__mt__"]["p"]
    base, end = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    assert all(base <= p.data_ptr() < end for _, p in teng.named)
    # and the flat update is the per-tensor one, bit for bit
    _, per = _flat_engines(monkeypatch, flat=False)
    for _ in range(3):
        per.train_batch(torch.from_numpy(ids).long(),
                        torch.from_numpy(labels))
    for (n, a), (_, b) in zip(teng.named, per.named):
        assert torch.equal(a, b), n


def test_pt_ce_chunk_overrides_the_chunk_and_warns_on_a_bad_value(
        monkeypatch):
    rng = np.random.default_rng(6)
    h = rng.normal(0, 1, (3, 20, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (16, 40)).astype(np.float32)
    lab = rng.integers(0, 40, (3, 20)).astype(np.int32)
    seen = []
    chunk = tce._chunk

    def spy(h2, labels, chunk_size, ignore_index):
        seen.append(chunk_size)
        return chunk(h2, labels, chunk_size, ignore_index)

    monkeypatch.setattr(tce, "_chunk", spy)
    for env, want in (("8", 8), ("0", 1024), ("x", 1024)):
        monkeypatch.setenv("PT_CE_CHUNK", env)
        seen.clear()
        with pytest.warns(UserWarning, match="PT_CE_CHUNK") if want == 1024 \
                else _no_warning():
            got = tce.fused_linear_cross_entropy(
                torch.from_numpy(h), torch.from_numpy(w),
                torch.from_numpy(lab))
        assert seen == [want]
        ref = jce.fused_linear_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                             jnp.asarray(lab))
        np.testing.assert_allclose(got.item(), float(ref), **TOL)


class _no_warning:
    def __enter__(self):
        import warnings

        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        return self._w.__exit__(*exc)
