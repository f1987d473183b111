"""AMP in the port (``paddle_tpu_torch/amp``) against the JAX package on
the CPU: the O1 / O2 rule for every listed op and the custom lists, the
dtypes the port's ops produce under ``auto_cast`` (the white-listed
``linear``, ``sdpa``, ``flash_attention``, ``einsum`` and the Llama
projections in bf16; the black-listed norms and losses untouched),
``decorate`` at O2 (parameters cast in place, ``multi_precision`` and fp32
master weights through the engine), and ``GradScaler`` step by step
against the JAX scaler on the same float32 inputs, a planted inf
included, with its ``state_dict``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.core import Parameter as JParam
from paddle_tpu.framework.core import Tensor as JTensor
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           masked_attention)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.parallel import ParallelEngine

# fp32 on both sides: the same products in another order
TOL = dict(rtol=1e-5, atol=1e-6)
OPS = sorted(tamp.WHITE_LIST | tamp.BLACK_LIST | {"relu", "add", "gelu"})
STATES = [dict(level="O0"), dict(level="O1"), dict(level="O2"),
          dict(level="O1", custom_white_list=["relu"],
               custom_black_list=["linear"]),
          dict(level="O2", custom_black_list=["add"]),
          dict(enable=False, level="O2")]


def test_lists_and_rules_match_jax():
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    for kw in STATES:
        with jamp.auto_cast(**kw), tamp.auto_cast(**kw):
            got = {op: tamp.should_cast_to_low_precision(op) for op in OPS}
            want = {op: jamp.should_cast_to_low_precision(op) for op in OPS}
        assert got == want, kw
    assert tamp.amp_guard is tamp.auto_cast
    assert tamp.amp_state().level == "O0"


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_the_ports_ops_take_the_rule(level):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 128, 4, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    ln_w, ln_b = torch.ones(64), torch.zeros(64)
    m = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                         device="cpu")
    with tamp.auto_cast(level=level):
        assert F.linear(x, w).dtype == torch.bfloat16
        assert F.scaled_dot_product_attention(
            x, x, x, is_causal=True).dtype == torch.bfloat16
        assert flash_attention(x.transpose(1, 2), x.transpose(1, 2),
                               x.transpose(1, 2), causal=True).dtype == \
            torch.bfloat16
        assert masked_attention(x, x, x).dtype == torch.bfloat16
        assert m.model.layers[0].mlp.gate_proj(
            torch.randn(2, 256)).dtype == torch.bfloat16
        # black-listed: the norms and losses keep their inputs' dtype
        assert F.layer_norm(x, [64], ln_w, ln_b).dtype == torch.float32
        assert F.cross_entropy(torch.randn(4, 10), torch.tensor(
            [1, 2, 3, 4])).dtype == torch.float32
        with tamp.auto_cast(custom_black_list=["linear"], level=level):
            assert F.linear(x, w).dtype == torch.float32
    assert F.linear(x, w).dtype == torch.float32
    # JAX casts its linear the same way
    jx = paddle.to_tensor(x.numpy())
    with jamp.auto_cast(level=level):
        out = paddle.nn.functional.linear(jx, paddle.to_tensor(w.numpy()))
    assert str(out.dtype).endswith("bfloat16")


def test_decorate_o2_casts_in_place_and_keeps_fp32_masters():
    m = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                         device="cpu")
    params = dict(m.named_parameters())
    opt = topt.AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    got_m, got_o = tamp.decorate(m, opt, level="O2")
    assert got_m is m and got_o is opt and opt._multi_precision
    assert all(p.dtype == torch.bfloat16 and p is params[n]
               for n, p in m.named_parameters())
    assert tamp.decorate(m, level="O1") is m
    eng = ParallelEngine(m, optimizer=opt)
    ids = torch.randint(0, 1024, (2, 16))
    eng.train_batch(ids[:, :-1], ids[:, 1:])
    slots = opt._accumulators["model.layers.0.mlp.up_proj.weight"]
    assert slots["master_weight"].dtype == torch.float32
    # the JAX decorate, for comparison
    paddle.seed(0)
    jlin = paddle.nn.Linear(4, 4)
    jo = jopt.AdamW(parameters=jlin.parameters())
    jamp.decorate(jlin, jo, level="O2")
    assert str(jlin.weight.dtype).endswith("bfloat16") and \
        jo._multi_precision


def _run_scaler(pkg, steps, plant_at):
    """Eager steps of a linear least-squares fit under each package's
    GradScaler; returns per step the weights, the scale and the scaler's
    state."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (8, 4)).astype(np.float32)
    y = rng.normal(0, 1, (8, 3)).astype(np.float32)
    w0 = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    out = []
    if pkg == "jax":
        w = JParam(jnp.asarray(w0), name="w")
        opt = jopt.Adam(0.05, parameters=[w])
        scaler = jamp.GradScaler(**kw)
        for k in range(steps):
            r = paddle.matmul(paddle.to_tensor(x), w) - paddle.to_tensor(y)
            loss = (r * r).mean()
            scaler.scale(loss).backward()
            if k == plant_at:
                w.grad = JTensor(jnp.full(w.shape, jnp.inf, jnp.float32))
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            out.append((np.asarray(w.numpy()), scaler.state_dict()))
        return out
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = topt.Adam(0.05, parameters=[("w", w)])
    scaler = tamp.GradScaler(**kw)
    for k in range(steps):
        r = torch.from_numpy(x) @ w - torch.from_numpy(y)
        loss = (r * r).mean()
        scaler.scale(loss).backward()
        if k == plant_at:
            w.grad.fill_(float("inf"))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        out.append((w.detach().numpy().copy(), scaler.state_dict()))
    return out


def test_grad_scaler_matches_jax_step_by_step():
    jax_run = _run_scaler("jax", 6, plant_at=2)
    port = _run_scaler("torch", 6, plant_at=2)
    for k, ((jw, js), (tw, ts)) in enumerate(zip(jax_run, port)):
        np.testing.assert_allclose(tw, jw, err_msg=str(k), **TOL)
        assert ts == js, k
    # the planted inf skipped its step and halved the scale
    np.testing.assert_array_equal(port[2][0], port[1][0])
    assert port[2][1]["scale"] == port[1][1]["scale"] / 2
    # state_dict round trip
    s = tamp.GradScaler()
    s.load_state_dict(port[-1][1])
    assert s.state_dict() == port[-1][1] and s.get_init_loss_scaling() == \
        port[-1][1]["scale"]
    assert tamp.AmpScaler is tamp.GradScaler
    off = tamp.GradScaler(enable=False)
    assert off.scale(3.0) == 3.0 and not off.is_enable()
