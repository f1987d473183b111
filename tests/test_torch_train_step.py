"""The port's training path as a whole against the JAX package, on the CPU
in fp32: a JAX ``LlamaForCausalLM`` (GQA, tiny config) carried across with
``params_from_jax``, then three ``ParallelEngine`` + ``AdamW`` +
``ClipGradByGlobalNorm`` steps under a warm-up + cosine LR schedule on
both sides, tied and untied embeddings, with and without gradient
accumulation: the loss of every step and the final parameters and
moments (``engine_state_dict``) agree. Also the RMSNorm backward, the
unfused loss and the schedulers against their JAX originals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.ops import fused_norm as jfn
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_norm as tfn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import ParallelEngine

B, S, STEPS = 4, 32, 3
# fp32 on both sides. Losses differ only in summation order. Parameters
# after three Adam steps: each step moves a weight by about lr·m/sqrt(v),
# and where a gradient is tiny that ratio amplifies the fp32 noise of
# XLA's vs torch's sums — the bound is a small fraction of one step
# (lr = 1e-3 at most)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-7)


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], 1).astype(
        np.int64)
    labels[1, :5] = -100
    return ids, labels


def _run_both(cfg_kw, grad_accum):
    paddle.seed(3)
    jm = JModel(JConfig(**cfg_kw))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = llama_tiny_config(**cfg_kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))

    jopt = JAdamW(learning_rate=_schedule(jlr), parameters=jm.parameters(),
                  weight_decay=0.01, grad_clip=JClip(1.0))
    jeng = JEngine(jm, optimizer=jopt, loss_fn=None, grad_accum=grad_accum)
    topt = AdamW(learning_rate=_schedule(tlr),
                 parameters=tm.named_parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    teng = ParallelEngine(tm, optimizer=topt, grad_accum=grad_accum)
    jl, tl = [], []
    ids, labels = _batch(cfg.vocab_size)        # one batch: the loss falls
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids),
                                   torch.from_numpy(labels)).item())
    return jl, tl, jeng.engine_state_dict(), teng.engine_state_dict()


TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_three_adamw_steps_match_jax_engine(tied, grad_accum):
    # a CE chunk of 48 leaves a padded last chunk of B*S/grad_accum tokens
    kw = dict(TINY, tie_word_embeddings=tied, ce_chunk_size=48)
    jl, tl, js, ts = _run_both(kw, grad_accum)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tl[-1] < tl[0]
    assert ts["step"] == js["step"] == STEPS
    assert set(ts["params"]) == set(js["params"])
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)
    assert set(ts["opt_state"]) == set(js["opt_state"])
    for n, slots in js["opt_state"].items():
        assert set(ts["opt_state"][n]) == set(slots) == {"moment1",
                                                        "moment2"}
        for k, want in slots.items():
            np.testing.assert_allclose(ts["opt_state"][n][k],
                                       np.asarray(want), err_msg=f"{n}.{k}",
                                       **MOMENT_TOL)


def test_engine_state_round_trip_continues_identically():
    """set_engine_state(engine_state_dict()) on a fresh engine, then one
    more step on both: identical losses and parameters."""
    cfg = llama_tiny_config(**TINY)

    def engine():
        m = LlamaForCausalLM(cfg, device="cpu", seed=1)
        o = AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                  multi_precision=True)
        return ParallelEngine(m, optimizer=o)

    a = engine()
    ids, labels = _batch(cfg.vocab_size)
    a.train_batch(ids, labels)
    b = engine()
    b.set_engine_state(a.engine_state_dict())
    la, lb = a.train_batch(ids, labels), b.train_batch(ids, labels)
    assert la.item() == lb.item()
    sa, sb = a.engine_state_dict(), b.engine_state_dict()
    assert sa["step"] == sb["step"] == 2
    for n in sa["params"]:
        np.testing.assert_array_equal(sa["params"][n], sb["params"][n])


def test_unfused_loss_and_logits_match_jax():
    """fused_lm_head_ce off: the model's logits and its fp32-softmax mean
    CE over the non-ignored labels, as the JAX model's loss_fn."""
    paddle.seed(5)
    kw = dict(TINY, fused_lm_head_ce=False)
    jm = JModel(JConfig(**kw))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = llama_tiny_config(**kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    ids, labels = _batch(cfg.vocab_size, seed=7)
    jlogits = np.asarray(jm(paddle.to_tensor(ids)).value)
    jloss = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(ids))
        tloss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tloss.item(), jloss, **LOSS_TOL)


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_rms_norm_grads_match_jax_grad(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jfn.fused_rms_norm(a, b, 1e-5)
                                             * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tfn.fused_rms_norm(tx, tw, 1e-5) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


def test_lr_schedules_match_jax():
    for make in (_schedule,
                 lambda m: m.CosineAnnealingDecay(0.1, T_max=7,
                                                  eta_min=0.01),
                 lambda m: m.LinearWarmup(0.5, warmup_steps=3, start_lr=0.0,
                                          end_lr=0.5)):
        j, t = make(jlr), make(tlr)
        for _ in range(12):
            assert t() == pytest.approx(j(), rel=1e-12, abs=0)
            j.step()
            t.step()
