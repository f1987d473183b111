"""The port's optimizers and LR schedulers (``paddle_tpu_torch/optimizer``)
against the JAX package on the CPU, with the same float32 / int32 numpy
inputs: AdamW's device scalars ``[lr, 1/bc1, 1/bc2]`` bit for bit against
the scalar block JAX's ``fused_adamw_update`` hands its kernel (the port
once computed the bias corrections in float64, 1.3e-5 off at step 1);
each of the eight optimizers without a kernel over three ``ParallelEngine``
steps under a scheduler against the JAX engine; every scheduler's learning
rate over 30 steps; and the options that stay unported still raising."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.ops import fused_adamw as jfa
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelEngine as JEngine
import paddle_tpu_torch.optimizer as topt_mod
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_adamw as tfa
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import ParallelEngine

B, S, STEPS = 4, 32, 3
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
# fp32 on both sides, as tests/test_torch_train_step.py: losses differ in
# summation order only; after three updates a weight differs by a small
# fraction of one step (the largest lr here is 0.05 for SGD's 1e-3-sized
# gradients); slots are sums of the same gradients
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
SLOT_TOL = dict(rtol=1e-3, atol=1e-7)


def _jax_kernel_scalars(monkeypatch, lr, step, b1, b2):
    """The scalar block JAX's ``fused_adamw_update`` builds for its kernel
    (``paddle_tpu/ops/fused_adamw.py:245-251``), taken at the kernel's
    call; lr fp32 and step int32 as the JAX engine traces them."""
    seen = []

    def fused_call(param, grad, m, v, master, scalars, *args):
        seen.append(np.asarray(scalars, np.float32)[0, :3])
        return param, m, v, master

    monkeypatch.setattr(jfa, "usable", lambda shape: True)
    monkeypatch.setattr(jfa, "_fused_call", fused_call)
    z = jnp.zeros((8, 128), jnp.float32)
    jfa.fused_adamw_update(z, z, z, z, lr=jnp.float32(lr),
                           step=jnp.int32(step), b1=b1, b2=b2, eps=1e-8,
                           decay=0.01, master=z)
    return seen[0]


@pytest.mark.parametrize("step", [1, 2, 10])
@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.9, 0.95)])
def test_adamw_scalars_equal_jax_kernel_scalars(monkeypatch, step, betas):
    """The plain twin's and the kernel's scalars (``adamw_scalars``) equal
    JAX's bit for bit; float64 bias corrections, as the port once made
    them, do not (the regression this holds: 1000.0 against 1000.0129 for
    1/(1 - 0.999) at step 1)."""
    b1, b2 = betas
    want = _jax_kernel_scalars(monkeypatch, 3e-4, step, b1, b2)
    got = tfa.adamw_scalars(torch.tensor(3e-4),
                            torch.tensor(step, dtype=torch.int32),
                            torch.tensor([b1, b2], dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f64 = np.float32([3e-4, 1 / (1 - b1 ** step), 1 / (1 - b2 ** step)])
    if step == 1:
        assert not np.array_equal(f64, want)


def test_engine_adamw_scalars_equal_jax_at_steps_1_2_10(monkeypatch):
    """The scalars the port's engine builds on the device each step (the
    warm-up + cosine schedule's lr, the device step count + 1) equal the
    block JAX builds from the same lr and step, at steps 1, 2 and 10."""
    built = []
    orig = tfa.adamw_scalars

    def spy(lr, step, betas):
        out = orig(lr, step, betas)
        built.append(out.numpy().copy())
        return out

    monkeypatch.setattr(tfa, "adamw_scalars", spy)
    cfg = llama_tiny_config(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu", seed=2)
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10),
                             warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = topt_mod.AdamW(learning_rate=sched,
                         parameters=tm.named_parameters(), beta2=0.999)
    eng = ParallelEngine(tm, optimizer=opt)
    jsched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-3, T_max=10),
                              warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    lrs = []
    ids, labels = _batch(cfg.vocab_size)
    for _ in range(10):
        lrs.append(jsched())
        jsched.step()
        eng.train_batch(ids, labels)
    assert len(built) == 10 and eng.engine_state_dict()["step"] == 10
    for step in (1, 2, 10):
        want = _jax_kernel_scalars(monkeypatch, lrs[step - 1], step, 0.9,
                                   0.999)
        np.testing.assert_array_equal(built[step - 1], want,
                                      err_msg=f"step {step}")


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)],
                            1).astype(np.int64)
    labels[2, :7] = -100
    return ids, labels


# (name, the optimizer's keyword arguments in both packages, the
# scheduler factory or a float lr): each of the optimizers that has no
# kernel, under a scheduler (one under a float), with weight decay as L2
# where the optimizer takes it
OPTIMIZERS = [
    ("SGD", dict(weight_decay=0.01),
     lambda m: m.StepDecay(0.05, step_size=2, gamma=0.5)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True),
     lambda m: m.ExponentialDecay(0.02, gamma=0.9)),
    ("Adamax", dict(beta1=0.9, beta2=0.99),
     lambda m: m.LinearWarmup(m.CosineAnnealingDecay(1e-3, T_max=10),
                              warmup_steps=2, start_lr=1e-4, end_lr=1e-3)),
    ("Adagrad", dict(initial_accumulator_value=0.1),
     lambda m: m.PolynomialDecay(1e-2, decay_steps=5)),
    ("RMSProp", dict(rho=0.9, momentum=0.5, centered=True),
     lambda m: m.InverseTimeDecay(1e-3, gamma=0.5)),
    ("Adadelta", dict(rho=0.9, weight_decay=0.001), lambda m: 1.0),
    ("Lamb", dict(lamb_weight_decay=0.01),
     lambda m: m.MultiStepDecay(1e-3, milestones=[1, 2], gamma=0.5)),
    ("Lars", dict(lars_coeff=0.01, lars_weight_decay=0.0005),
     lambda m: m.NaturalExpDecay(0.05, gamma=0.1)),
]


@pytest.mark.parametrize("name,kw,sched", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_three_engine_steps_match_jax_engine(name, kw, sched):
    """Three ParallelEngine steps with the global-norm clip: every loss,
    then every parameter and every slot (the JAX slot names) against the
    JAX engine with the same optimizer, scheduler and weights."""
    paddle.seed(4)
    jm = JModel(JConfig(**TINY))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = llama_tiny_config(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    jopt = getattr(jopt_mod, name)(learning_rate=sched(jlr),
                                   parameters=jm.parameters(),
                                   grad_clip=JClip(1.0), **kw)
    jeng = JEngine(jm, optimizer=jopt, loss_fn=None)
    topt = getattr(topt_mod, name)(learning_rate=sched(tlr),
                                   parameters=tm.named_parameters(),
                                   grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    teng = ParallelEngine(tm, optimizer=topt)
    ids, labels = _batch(cfg.vocab_size, seed=1)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids),
                                   torch.from_numpy(labels)).item())
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tl[-1] < tl[0], tl
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    assert ts["step"] == js["step"] == STEPS
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)
    assert set(ts["opt_state"]) == set(js["opt_state"])
    for n, slots in js["opt_state"].items():
        assert set(ts["opt_state"][n]) == set(slots), n
        for k, want in slots.items():
            np.testing.assert_allclose(ts["opt_state"][n][k],
                                       np.asarray(want), err_msg=f"{n}.{k}",
                                       **SLOT_TOL)


# every scheduler of paddle_tpu/optimizer/lr.py, some in more than one
# mode; the same factory builds both packages' scheduler
SCHEDULERS = {
    "Noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=2.0),
    "Piecewise": lambda m: m.PiecewiseDecay([3, 8, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "NaturalExp": lambda m: m.NaturalExpDecay(0.1, gamma=0.2),
    "InverseTime": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "Polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                              end_lr=0.001, power=2.0),
    "Polynomial_cycle": lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                                    cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.5, warmup_steps=3,
                                             start_lr=0.0, end_lr=0.5),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-3, T_max=10), warmup_steps=2,
        start_lr=1e-4, end_lr=1e-3),
    "Exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStep": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 17]),
    "Step": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.5),
    "Lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "CosineAnnealing": lambda m: m.CosineAnnealingDecay(0.1, T_max=7,
                                                        eta_min=0.01),
    "Multiplicative": lambda m: m.MultiplicativeDecay(0.1,
                                                      lambda e: 0.9),
    "OneCycle": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "OneCycle_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=20, anneal_strategy="linear", phase_pct=0.4),
    "Cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4),
    "Cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, step_size_down=5, mode="triangular2"),
    "Cyclic_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, mode="exp_range", exp_gamma=0.97),
    "Cyclic_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, scale_fn=lambda x: 1 / x),
    "CosineWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "Linear": lambda m: m.LinearLR(0.1, total_steps=12),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_lr_sequence_matches_jax(name):
    """The learning rate before each of 30 steps, and the state a
    ``state_dict`` round trip carries into a fresh scheduler."""
    make = SCHEDULERS[name]
    j, t = make(jlr), make(tlr)
    for _ in range(30):
        assert t() == pytest.approx(j(), rel=1e-12, abs=0)
        j.step()
        t.step()
    fresh = make(tlr)
    fresh.set_state_dict(t.state_dict())
    for _ in range(3):
        assert fresh() == pytest.approx(t(), rel=1e-12, abs=0)
        fresh.step()
        t.step()


def test_reduce_on_plateau_matches_jax():
    """ReduceOnPlateau over a metric sequence (plateaus, a cooldown, the
    floor), the metric also as a 0-d tensor on the port's side."""
    metrics = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.92, 0.5, 0.5, 0.5, 0.5,
               0.5, 0.49999, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]

    def make(m):
        return m.ReduceOnPlateau(0.1, factor=0.5, patience=2, cooldown=1,
                                 min_lr=0.02)

    for mode_kw in ({}, dict(mode="max", threshold_mode="abs")):
        j = make(jlr) if not mode_kw else jlr.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, min_lr=0.02, **mode_kw)
        t = make(tlr) if not mode_kw else tlr.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, min_lr=0.02, **mode_kw)
        for i, x in enumerate(metrics):
            j.step(x)
            t.step(torch.tensor(x) if i % 2 else x)
            assert t() == pytest.approx(j(), rel=1e-12, abs=0)
        assert t.last_epoch == j.last_epoch


def test_every_jax_optimizer_and_scheduler_is_ported():
    """The port's optimizer package names every optimizer and scheduler
    class of the JAX package."""
    import inspect

    names = [n for n in jopt_mod.__all__ if n != "lr"] + [
        n for n, c in vars(jlr).items()
        if inspect.isclass(c) and c.__module__ == jlr.__name__]
    assert len(names) == 11 + 18       # the base classes included
    missing = sorted(n for n in names if not hasattr(topt_mod, n))
    assert not missing, missing


def _params():
    return [("w", torch.nn.Parameter(torch.ones(4, 8))),
            ("b", torch.nn.Parameter(torch.zeros(8)))]


@pytest.mark.parametrize("make", [
    lambda: topt_mod.AdamW(parameters=_params(), lr_ratio=lambda p: 0.5),
    lambda: topt_mod.Adam(parameters=_params(), lazy_mode=True),
    lambda: topt_mod.AdamW(parameters=_params(), lazy_mode=True),
    lambda: topt_mod.SGD(parameters=_params(),
                         weight_decay=paddle.regularizer.L2Decay(0.1)),
    lambda: topt_mod.Momentum(parameters=_params(),
                              weight_decay=paddle.regularizer.L1Decay(0.1)),
    lambda: topt_mod.Lamb(parameters=_params(),
                          exclude_from_weight_decay_fn=lambda p: True),
    lambda: topt_mod.Lars(parameters=_params(),
                          exclude_from_weight_decay=["bias"]),
], ids=["lr_ratio", "adam_lazy", "adamw_lazy", "l2_object", "l1_object",
        "lamb_exclude", "lars_exclude"])
def test_unported_options_raise(make):
    """These options raised NotImplementedError until they were ported;
    now each builds an optimizer whose eager step runs, as the JAX
    package accepts them (their numbers against JAX:
    tests/test_torch_optimizer_surface.py)."""
    opt = make()
    for _, p in opt._parameter_list:
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    assert opt._global_step == 1


def test_multi_tensor_adamw_state_raises(monkeypatch):
    """``PT_MT_ADAMW=1`` builds JAX's flat multi-tensor state (one
    ``"__mt__"`` entry, the parameters views into it), and an update that
    misses a parameter's gradient raises ValueError, as JAX's flat
    ``pure_update`` does; per-tensor options keep the per-tensor path."""
    monkeypatch.setenv("PT_MT_ADAMW", "1")
    params = _params()
    opt = topt_mod.AdamW(parameters=params)
    opt.init_state(params)
    assert set(opt._accumulators) == {"__mt__"}
    assert opt._accumulators["__mt__"]["p"].shape == (128, 512)
    with pytest.raises(ValueError, match="PT_MT_ADAMW"):
        opt.update([("w", params[0][1], torch.ones(4, 8))], 1e-3, 1)
    per = topt_mod.AdamW(parameters=_params(), multi_precision=True)
    per.init_state(_params())
    assert set(per._accumulators) == {"w", "b"}
