"""The ResNet family in the PyTorch port (``paddle_tpu_torch/vision/models/
resnet.py`` and the layers under it) against the JAX package on the CPU,
fp32, the JAX weights and BatchNorm statistics carried across by
``layer_params_from_jax``: names and counts, the train-mode logits, loss
and gradients, the eval logits on the running statistics, and one step of
the recipe's Momentum (``examples/resnet_cifar10.py``: momentum 0.9,
weight decay 5e-4, ``CosineAnnealingDecay(0.1)``) through each package's
``ParallelEngine`` — its parameters, velocities and BatchNorm statistics —
without and with ``grad_accum=2``.

Inputs are B = 2 (4 for ``grad_accum=2``: two microbatches of 2) at 64 x
64 (at 32 x 32 ResNet-50's last stage normalises 2 values a channel, and
its fp32 logits are 0.55 of the largest away from its fp64 ones). Even at
64 x 64 a randomly initialised ResNet-50's train-mode backward amplifies
fp32 rounding: the port's own fp32 gradients lie up to 6 % of a tensor's
largest element away from its fp64 ones. So the gradients, the steps'
updates and the velocities are held by that yardstick, tensor by tensor:
JAX's fp32 result must lie as close to the port's fp64 result as the
port's own fp32 result does, within a factor NOISE_FACTOR (JAX measured
at most 1.56x in Frobenius norm). A planted fault moves a result by far
more than that rounding. The forward's loss, the eval logits and the BatchNorm
statistics are well conditioned and held to fixed tolerances.

Each JAX model is built once (a module-scoped fixture); every JAX result
comes from its compiled engine (the eval forward through ``eval_batch``
with a loss that returns the logits, the gradients from the first step's
velocities, which hold ``g + 5e-4 w``), which compiles in a fraction of
JAX's eager backward. ResNet-50 holds the names and counts, the eval
logits and the ``grad_accum=2`` step, whose checks cover its loss, its
gradients (the velocities) and its BatchNorm statistics; the rest runs on
ResNet-18 only (the engine's path without ``grad_accum`` is the same code
for both models).

AMP O1 with bf16 (the card's mixed-precision cell): ResNet-18's
train-mode logits and loss under ``auto_cast`` against JAX's on the same
weights, held by the bf16 yardstick: JAX's bf16 logits lie as close to
the port's bf16 ones as the port's bf16 logits lie to its fp32 ones,
within AMP_FACTOR."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models as jvm
from paddle_tpu.jit import state_values
from paddle_tpu.parallel import ParallelEngine as JEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.models.convert import layer_params_from_jax
from paddle_tpu_torch.parallel import ParallelEngine

B, S, CLASSES = 2, 64, 10
LR, MOMENTUM, WD = 0.1, 0.9, 5e-4
# held relative to the largest magnitude of the compared tensor. The
# port's fp32 logits are within 1e-4 of its fp64 logits at these shapes
# (ResNet-50; ResNet-18 5e-6): 1e-3 leaves 10x that (the loss, and the
# BatchNorm statistics the forward leaves)
LOSS_TOL = 1e-3
BUF_TOL = 1e-3
# eval on the running statistics is well conditioned: 8e-7 measured
EVAL_TOL = 2e-5
# the yardstick's factor, and a floor for tensors the rounding leaves
# (nearly) untouched, relative to the fp64 tensor's norm
NOISE_FACTOR = 4.0
NOISE_FLOOR = 1e-5
# AMP: JAX's bf16 logits against the port's, relative to the largest
# fp32 logit: at most AMP_FACTOR x the port's own bf16-to-fp32 distance
# (0.19x measured on these weights, 1.25x on another draw); the two
# packages' losses on the same bf16 logits
# within AMP_LOSS_TOL (fp32 arithmetic on both sides)
AMP_FACTOR = 2.5
AMP_LOSS_TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _within_fp32_noise(got, fp32, fp64, label):
    """Raise unless every tensor of ``got`` (JAX, fp32) lies as close to
    ``fp64`` (the port in fp64) as ``fp32`` (the port in fp32) does, within
    NOISE_FACTOR, plus NOISE_FLOOR of the tensor's norm (Frobenius norms
    of the differences: a single element's rounding varies too much from
    one fp32 run to another)."""
    worst = (0.0, None)
    for n, ref in fp64.items():
        scale = max(np.linalg.norm(ref), 1e-30)
        noise = np.linalg.norm(np.asarray(fp32[n], np.float64) - ref)
        err = np.linalg.norm(np.asarray(got[n], np.float64) - ref)
        ratio = err / (NOISE_FACTOR * noise + NOISE_FLOOR * scale)
        worst = max(worst, (ratio, n))
    assert worst[0] <= 1.0, (label, worst)


def _jax_loss(logits, label):
    return paddle.nn.functional.cross_entropy(logits, label)


def _port_loss(logits, label):
    return pt.nn.functional.cross_entropy(logits, label)


def _jax_step(jm, x, y, accum):
    opt = paddle.optimizer.Momentum(
        learning_rate=paddle.optimizer.lr.CosineAnnealingDecay(LR, T_max=10),
        momentum=MOMENTUM, weight_decay=WD, parameters=jm.parameters())
    eng = JEngine(jm, optimizer=opt, loss_fn=_jax_loss, grad_accum=accum)
    loss = float(eng.train_batch(paddle.to_tensor(x), paddle.to_tensor(y)))
    return loss, eng.engine_state_dict()


def _fp64_loss(logits, label):
    # the yardstick's loss in fp64 too (the port's cross_entropy works in
    # fp32, whose rounding the backward would amplify)
    return torch.nn.functional.cross_entropy(logits, label)


def _port_model(name, state, dtype=torch.float32):
    m = getattr(pt.vision.models, name)(num_classes=CLASSES, device="cpu")
    return layer_params_from_jax(state, m).to(dtype=dtype)


def _port_grads(name, state, x, y, dtype):
    m = _port_model(name, state, dtype)
    loss_fn = _fp64_loss if dtype == torch.float64 else _port_loss
    loss_fn(m(torch.from_numpy(x).to(dtype)),
            torch.from_numpy(y)).backward()
    return {n: p.grad.double().numpy() for n, p in m.named_parameters()}


def _port_step(name, state, x, y, accum, dtype=torch.float32):
    """One engine step: (loss, {name: parameter update}, {name: buffer},
    {name: velocity}, step count)."""
    m = _port_model(name, state, dtype)
    opt = pt.optimizer.Momentum(
        learning_rate=pt.optimizer.lr.CosineAnnealingDecay(LR, T_max=10),
        momentum=MOMENTUM, weight_decay=WD, parameters=m.parameters())
    eng = ParallelEngine(
        m, optimizer=opt, grad_accum=accum,
        loss_fn=_fp64_loss if dtype == torch.float64 else _port_loss)
    loss = float(eng.train_batch(torch.from_numpy(x).to(dtype),
                                 torch.from_numpy(y)))
    es = eng.engine_state_dict()
    upd = {n: es["params"][n].astype(np.float64) - state[n]
           for n, _ in m.named_parameters()}
    bufs = {n: b.double().numpy() for n, b in m.named_buffers()}
    vel = {n: s["velocity"] for n, s in es["opt_state"].items()}
    return loss, upd, bufs, vel, es["step"]


def _jax_result(state, js, params_only):
    upd = {n: js["params"][n].astype(np.float64) - state[n]
           for n in params_only}
    vel = {n: s["velocity"] for n, s in js["opt_state"].items()}
    return upd, vel


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def run(request):
    name = request.param
    paddle.seed(0)
    jm = getattr(jvm, name)(num_classes=CLASSES)
    state = {n: np.asarray(v) for n, v in state_values(jm).items()}
    rng = np.random.RandomState(0)
    x = rng.randn(2 * B, 3, S, S).astype("float32")
    y = rng.randint(0, CLASSES, (2 * B,)).astype("int64")
    out = dict(name=name, jm=jm, state=state, x=x, y=y)
    if name == "resnet18":
        out["j_step"] = _jax_step(jm, x[:B], y[:B], 1)
    out["j_accum"] = _jax_step(jm, x, y, 2)
    # the eval forward on the running statistics, through the compiled
    # eval step with a loss that returns the logits
    jm.eval()
    fwd = JEngine(jm, loss_fn=lambda logits, label: logits)
    out["j_eval"] = np.asarray(fwd.eval_batch(
        paddle.to_tensor(x[:B]), paddle.to_tensor(y[:B])).value)
    jm.train()
    return out


# the checks that ResNet-50's grad_accum=2 step makes again
resnet18_only = pytest.mark.parametrize("run", ["resnet18"], indirect=True)


def test_names_counts_and_order_match_the_jax_model(run):
    """Parameters then buffers, name for name and in the JAX package's
    order (ResNet-50: 161 parameters and 106 BatchNorm statistics)."""
    tm = _port_model(run["name"], run["state"])
    names = [n for n, _ in tm.named_parameters()] + \
        [n for n, _ in tm.named_buffers()]
    assert names == list(run["state"])
    if run["name"] == "resnet50":
        assert len(list(tm.named_parameters())) == 161
        assert len(list(tm.named_buffers())) == 106
    assert set(tm.state_dict()) == set(run["state"])


@resnet18_only
def test_train_mode_loss(run):
    tm = _port_model(run["name"], run["state"])
    loss = _port_loss(tm(torch.from_numpy(run["x"][:B])),
                      torch.from_numpy(run["y"][:B])).item()
    jloss = run["j_step"][0]
    assert abs(loss - jloss) < LOSS_TOL * abs(jloss)


def test_eval_logits_on_the_running_statistics(run):
    tm = _port_model(run["name"], run["state"]).eval()
    with torch.no_grad():
        logits = tm(torch.from_numpy(run["x"][:B]))
    assert _rel(logits.numpy(), run["j_eval"]) < EVAL_TOL


@resnet18_only
def test_gradients(run):
    """The port's gradients against JAX's, read from the first step's
    velocities (``0.9 · 0 + g + 5e-4 · w``), by the fp32 yardstick."""
    name, state, x, y = run["name"], run["state"], run["x"][:B], \
        run["y"][:B]
    vel = run["j_step"][1]["opt_state"]
    jg = {n: vel[n]["velocity"].astype(np.float64) - WD * state[n]
          for n in vel}
    _within_fp32_noise(jg, _port_grads(name, state, x, y, torch.float32),
                       _port_grads(name, state, x, y, torch.float64),
                       "gradients")


@resnet18_only
def test_batch_norm_statistics_after_a_training_forward(run):
    """``running = 0.9 · running + 0.1 · batch``, the variance unbiased,
    as the JAX engine threads them out of its step."""
    tm = _port_model(run["name"], run["state"])
    tm(torch.from_numpy(run["x"][:B]))
    jp = run["j_step"][1]["params"]
    worst = max((_rel(b.numpy(), jp[n]), n) for n, b in tm.named_buffers())
    assert worst[0] < BUF_TOL, worst
    for n, b in tm.named_buffers():       # they moved from (0, 1)
        assert not np.array_equal(b.numpy(), run["state"][n]), n


def _hold_step(run, key, x, y, accum):
    name, state = run["name"], run["state"]
    jloss, js = run[key]
    loss32, upd32, bufs32, vel32, step = _port_step(name, state, x, y,
                                                    accum)
    _, upd64, _, vel64, _ = _port_step(name, state, x, y, accum,
                                       torch.float64)
    assert abs(loss32 - jloss) < LOSS_TOL * abs(jloss)
    jupd, jvel = _jax_result(state, js, upd32)
    _within_fp32_noise(jupd, upd32, upd64, f"updates (accum {accum})")
    _within_fp32_noise(jvel, vel32, vel64, f"velocities (accum {accum})")
    worst = max((_rel(b, js["params"][n]), n) for n, b in bufs32.items())
    assert worst[0] < BUF_TOL, worst
    assert step == js["step"] == 1
    return bufs32


@resnet18_only
def test_momentum_step_through_the_engine(run):
    _hold_step(run, "j_step", run["x"][:B], run["y"][:B], 1)


def test_momentum_step_with_grad_accum_2(run):
    """Two microbatches of 2: the BatchNorm statistics move once a
    microbatch, as the JAX engine threads them through its scan."""
    bufs = _hold_step(run, "j_accum", run["x"], run["y"], 2)
    # two updates of the statistics, not one: the first BatchNorm's mean
    # is 0.9 · (0.1 · m1) + 0.1 · m2, not 0.1 · m1
    tm = _port_model(run["name"], run["state"])
    tm(torch.from_numpy(run["x"][:B]))
    assert _rel(bufs["bn1._mean"], tm.bn1._mean.numpy()) > 0.1


def test_the_forward_on_the_card_by_default_raises_without_one(
        monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pt.vision.models, run["name"])(num_classes=CLASSES)


@resnet18_only
def test_amp_o1_bf16_logits_and_loss(run):
    """Train-mode forward under ``auto_cast(level="O1", dtype="bfloat16")``:
    the convolutions and the fc in bf16, BatchNorm computing in fp32 on
    bf16 activations; JAX's through its compiled eval step (the running
    statistics it would move are left as they are)."""
    x, y = run["x"][:B], run["y"][:B]
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        fwd = JEngine(run["jm"], loss_fn=lambda logits, label: logits)
        jl = fwd.eval_batch(paddle.to_tensor(x), paddle.to_tensor(y))
    assert str(jl.dtype) == "bfloat16"
    jl = np.array(jl.astype("float32").numpy())
    tm = _port_model(run["name"], run["state"])
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = tm(torch.from_numpy(x))
    assert tl.dtype == torch.bfloat16
    with torch.no_grad():
        fl = _port_model(run["name"], run["state"])(torch.from_numpy(x))
    tl = tl.detach().float().numpy()
    scale = np.abs(fl.numpy()).max()
    own = np.abs(tl - fl.numpy()).max() / scale
    assert np.abs(jl - tl).max() / scale <= AMP_FACTOR * own, own
    # the loss: each package's cross_entropy under auto_cast on JAX's bf16
    # logits (fp32 inside both)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jloss = float(_jax_loss(paddle.to_tensor(jl).astype("bfloat16"),
                                paddle.to_tensor(y)))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = _port_loss(torch.from_numpy(jl).bfloat16(),
                          torch.from_numpy(y)).item()
    assert abs(loss - jloss) < AMP_LOSS_TOL * abs(jloss)
