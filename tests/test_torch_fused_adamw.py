"""Fused AdamW update and gradient clipping in the PyTorch port
(paddle_tpu_torch/ops/fused_adamw.py, nn/clip.py) against the JAX package
on the CPU with the same numpy inputs: ``_reference_update`` and
``fused_adamw_update`` (with and without an fp32 master weight) against
the Pallas kernel ``_fused_call`` run in interpret mode, and the clip
classes against the JAX package's traced ``_pure_grad_clip``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_adamw as jfa
from paddle_tpu.optimizer.optimizer import _pure_grad_clip
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops import fused_adamw as tfa

HP = dict(lr=1e-3, step=7, b1=0.9, b2=0.999, eps=1e-8, decay=0.01)
# the kernel multiplies by host-computed 1/(1 - beta^step) where the
# reference divides, and XLA and torch may contract other products: a few
# fp32 ulps (the JAX package holds its kernel to the same 2e-5 / 2e-6)
TOL = dict(rtol=2e-5, atol=2e-6)


def _state(K=16, N=256, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((K, N)).astype(np.float32)
    g = rng.standard_normal((K, N)).astype(np.float32)
    m = rng.standard_normal((K, N)).astype(np.float32)
    v = np.abs(rng.standard_normal((K, N))).astype(np.float32)
    master = rng.standard_normal((K, N)).astype(np.float32)
    return p, g, m, v, master


def _jax_kernel(p, g, m, v, master, dtype):
    """The JAX package's Pallas kernel in interpret mode, called the way
    ``fused_adamw_update`` calls it."""
    step = np.float32(HP["step"])
    scalars = jnp.asarray(np.array(
        [[HP["lr"], 1 / (1 - np.float32(HP["b1"]) ** step),
          1 / (1 - np.float32(HP["b2"]) ** step), 0.0]], np.float32))
    out = jfa._fused_call(jnp.asarray(p).astype(dtype), jnp.asarray(g),
                          jnp.asarray(m), jnp.asarray(v),
                          None if master is None else jnp.asarray(master),
                          scalars, HP["b1"], HP["b2"], HP["eps"],
                          HP["decay"], master is not None)
    return [np.asarray(o, np.float32) for o in out]


def test_reference_update_matches_jax_reference():
    p, g, m, v, _ = _state()
    args = (HP["lr"], HP["b1"], HP["b2"], HP["eps"], HP["decay"], HP["step"])
    want = jfa._reference_update(jnp.asarray(p), jnp.asarray(g),
                                 jnp.asarray(m), jnp.asarray(v), *args)
    # the port's twin reads the device scalars [lr, 1/bc1, 1/bc2]
    scalars = tfa.adamw_scalars(HP["lr"], HP["step"], torch.tensor(
        [HP["b1"], HP["b2"]], dtype=torch.float32))
    got = tfa._reference_update(*(torch.from_numpy(a) for a in (p, g, m, v)),
                                scalars, HP["b1"], HP["b2"], HP["eps"],
                                HP["decay"])
    for name, a, b in zip(("master", "m", "v"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("with_master", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_update_matches_pallas_kernel(monkeypatch, dtype, with_master):
    """In place on the port's side; new arrays from the interpreted TPU
    kernel. A bf16 parameter is compared after the one rounding both sides
    make (they agree to the fp32 tolerance before it, so at most one bf16
    step apart after)."""
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")
    p, g, m, v, master = _state(seed=1)
    master = master if with_master else None
    want = _jax_kernel(p, g, m, v, master, dtype)
    tdt = getattr(torch, dtype)
    tp = torch.from_numpy(p).to(tdt)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    tmaster = None if master is None else torch.from_numpy(master.copy())
    out = tfa.fused_adamw_update(tp, torch.from_numpy(g), tm, tv,
                                 master=tmaster, **HP)
    assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    assert out[3] is tmaster
    ptol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(tp.float().numpy(), want[0], **ptol)
    np.testing.assert_allclose(tm.numpy(), want[1], **TOL)
    np.testing.assert_allclose(tv.numpy(), want[2], **TOL)
    if with_master:
        np.testing.assert_allclose(tmaster.numpy(), want[3], **TOL)


def test_cpu_update_never_launches_and_cuda_wrapper_refuses_cpu():
    p, g, m, v, _ = (torch.from_numpy(a) for a in _state(K=8, N=128))
    tops.reset_launch_counts()
    tfa.fused_adamw_update(p.bfloat16(), g, m, v, **HP)
    assert tops.launch_counts()["fused_adamw"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tfa.fused_adamw_cuda(p.bfloat16(), g, m, v,
                             scalars=torch.tensor([1e-3, 1.0, 1.0]), b1=0.9,
                             b2=0.999, eps=1e-8, decay=0.0)
    assert tops.launch_counts()["fused_adamw"] == 0


def _grads(seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 5, 7)}
    return {n: (3.0 * rng.standard_normal(s)).astype(np.float32)
            for n, s in shapes.items()}


CLIPS = [("global_norm", lambda m: m.ClipGradByGlobalNorm(1.0)),
         ("global_norm_inactive", lambda m: m.ClipGradByGlobalNorm(1e6)),
         ("norm", lambda m: m.ClipGradByNorm(2.0)),
         ("value", lambda m: m.ClipGradByValue(1.5)),
         ("value_min_max", lambda m: m.ClipGradByValue(2.0, -0.5))]


@pytest.mark.parametrize("name,make", CLIPS, ids=[c[0] for c in CLIPS])
def test_clip_matches_pure_grad_clip(name, make):
    grads = _grads()
    want = _pure_grad_clip(make(jclip),
                           {n: jnp.asarray(g) for n, g in grads.items()})
    tg = {n: torch.from_numpy(g.copy()) for n, g in grads.items()}
    pairs = [(None, t) for t in tg.values()]
    assert make(tclip)(pairs) is pairs
    for n in grads:
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


OPTS = [("adam_l2", lambda o, c, ps: o.Adam(
            learning_rate=1e-2, beta2=0.99, parameters=ps, weight_decay=0.1)),
        ("adamw_decay_fun_clip", lambda o, c, ps: o.AdamW(
            learning_rate=1e-2, parameters=ps, weight_decay=0.05,
            apply_decay_param_fun=lambda n: n != "b",
            grad_clip=c.ClipGradByGlobalNorm(1.0))),
        ("adamw_master", lambda o, c, ps: o.AdamW(
            learning_rate=1e-2, parameters=ps, multi_precision=True))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,make", OPTS, ids=[o[0] for o in OPTS])
def test_optimizer_step_matches_jax_pure_update(name, make, dtype):
    """Two eager ``step()`` calls of the port's Adam / AdamW over
    ``param.grad`` against two ``pure_update`` calls of the JAX optimizer
    (bias correction at steps 1 and 2): L2 decay folded into the grad,
    decoupled decay skipped where ``apply_decay_param_fun`` says so, the
    global-norm clip, and the fp32 master weight of a bf16 parameter."""
    import paddle_tpu.optimizer as jopt_mod
    import paddle_tpu_torch.optimizer as topt_mod

    params = _grads(seed=2)
    grads = [_grads(seed=3), _grads(seed=4)]
    jdt = getattr(jnp, dtype)
    jopt = make(jopt_mod, jclip, None)
    jp = {n: jnp.asarray(p).astype(jdt) for n, p in params.items()}
    jstate = jopt.init_state(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(p).to(getattr(torch, dtype)))
          for n, p in params.items()}
    topt = make(topt_mod, tclip, list(tp.items()))
    for step, g in enumerate(grads, 1):
        jp, jstate = jopt.pure_update(
            jp, {n: jnp.asarray(a).astype(jdt) for n, a in g.items()},
            jstate, jopt.get_lr(), step)
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        topt.step()
    assert topt._global_step == 2
    ptol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    for n, p in tp.items():
        assert p.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(jp[n], np.float32), err_msg=n,
                                   **ptol)
        slots = topt._accumulators[n]
        assert set(slots) == set(jstate[n])
        for k, want in jstate[n].items():
            np.testing.assert_allclose(slots[k].numpy(), np.asarray(want),
                                       err_msg=f"{n}.{k}", **TOL)


def test_global_norm_clip_of_bf16_grads_rounds_once():
    """A bf16 grad is scaled in fp32 and rounded back to bf16, as
    ``_pure_grad_clip`` does."""
    grads = _grads(seed=1)
    jg = {n: jnp.asarray(g).astype(jnp.bfloat16) for n, g in grads.items()}
    want = _pure_grad_clip(jclip.ClipGradByGlobalNorm(1.0), jg)
    tg = {n: torch.from_numpy(g).bfloat16() for n, g in grads.items()}
    tclip.ClipGradByGlobalNorm(1.0)([(None, t) for t in tg.values()])
    for n in grads:
        assert tg[n].dtype == torch.bfloat16
        np.testing.assert_allclose(tg[n].float().numpy(),
                                   np.asarray(want[n], np.float32),
                                   rtol=2 ** -7, atol=0, err_msg=n)
