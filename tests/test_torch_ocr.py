"""The OCR pair of BASELINE config 5 in the PyTorch port
(``paddle_tpu_torch/vision/models/ocr.py``: ``CRNN`` with
``crnn_ctc_loss``, ``DBNet`` with ``db_loss``) against the JAX package on
the CPU, fp32, the port's seeded weights carried to the JAX models and
back through ``layer_params_from_jax`` (no renaming):

- the train-mode outputs and the eval outputs;
- one step of each package's ``ParallelEngine`` with ``Adam(1e-3)``
  (``tools/model_benchmark.py``'s recipe: the model computes its own loss,
  ``loss_fn=None``): the loss, the parameters and both moments after the
  step (the first moment is (1 - β1) · the gradient: every parameter's
  gradient, from JAX's compiled step, at a fraction of its eager
  backward's time), the BatchNorm statistics the step's forward left;
- the port's step body reads no device value on the host (the card's
  engine captures it in a CUDA graph, CTC loop and LSTM included).

Sizes: CRNN at B = 2 x 1 x 32 x 48 (T = 11 steps, labels of 5 digits in
1..10: every label sequence fits, repeats and their blanks included; the
JAX step unrolls the LSTM over T and its compile grows by ~0.7 s a step,
24 s at the recipe's width of 96, which the card runs), DBNet at B = 1 x
3 x 64 x 64. Tolerances, relative to the largest
magnitude of the compared tensor (``TOL``): CRNN 1e-5 for outputs,
losses and statistics, 1e-4 for gradients and moments (fp32 sums of
another order through the LSTM steps and the CTC loop; measured: 1.8e-6
and 8.7e-6). DBNet at B = 1 normalises 4 values a channel in its last
stage, which amplifies fp32 rounding: the port's fp32 maps lie 8.7e-6
of the largest off its fp64 ones, JAX's 2.3e-5, its second moments
1.2e-4 off the port's; so 1e-4 and 5e-4. The parameters after Adam's
first step move by lr · g / (|g| + eps), about ±lr wherever the gradient
is not rounding noise: there they agree within 1e-6; where the JAX
gradient is below 1e-4 of its tensor's largest (noise of either
package's fp32 sums can flip its sign) within 2 lr."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models as jvm
from paddle_tpu.jit import state_values
from paddle_tpu.nn import Layer as JLayer
from paddle_tpu.parallel import ParallelEngine as JEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.models.convert import layer_params_from_jax
from paddle_tpu_torch.parallel import ParallelEngine
from torch_tensor_parity import jax_forward, jax_host_init, jax_jit_at_o0

# (outputs, losses and statistics; gradients and moments) by model
TOL = {"crnn": (1e-5, 1e-4), "dbnet": (1e-4, 5e-4)}
PARAM_ATOL = 1e-6
LR = 1e-3
NOISE = 1e-4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


class _JCRNNWithLoss(JLayer):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def forward(self, imgs, labels, lengths):
        return jvm.crnn_ctc_loss(self.rec(imgs), labels, lengths)


class _TCRNNWithLoss(pt.nn.Layer):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def forward(self, imgs, labels, lengths):
        return pt.vision.models.crnn_ctc_loss(self.rec(imgs), labels,
                                              lengths)


class _JDBWithLoss(JLayer):
    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, x, sm, smask, tm, tmask):
        return jvm.db_loss(self.det(x)["maps"], sm, smask, tm, tmask)


class _TDBWithLoss(pt.nn.Layer):
    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, x, sm, smask, tm, tmask):
        return pt.vision.models.db_loss(self.det(x)["maps"], sm, smask, tm,
                                        tmask)


def _crnn_batch():
    rng = np.random.RandomState(0)
    return (rng.rand(2, 1, 32, 48).astype("float32"),
            rng.randint(1, 11, (2, 5)).astype("int32"),
            np.full((2,), 5, np.int32))


def _db_batch():
    rng = np.random.RandomState(1)
    S = 64
    return (rng.rand(1, 3, S, S).astype("float32"),
            (rng.rand(1, S, S) > 0.7).astype("float32"),
            (rng.rand(1, S, S) > 0.1).astype("float32"),
            rng.uniform(0.3, 0.7, (1, S, S)).astype("float32"),
            (rng.rand(1, S, S) > 0.5).astype("float32"))


MODELS = {
    "crnn": (lambda pkg, **kw: pkg.CRNN(10, in_channels=1, **kw),
             _crnn_batch, _JCRNNWithLoss, _TCRNNWithLoss),
    "dbnet": (lambda pkg, **kw: pkg.DBNet(**kw), _db_batch, _JDBWithLoss,
              _TDBWithLoss),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """The port's seeded model, the JAX model holding its state, and a
    second port model loaded from the JAX state by the converter."""
    make, batch, _, _ = MODELS[request.param]
    torch.manual_seed(22)
    tm = make(pt.vision.models, device="cpu")
    state = {n: t.detach().numpy().copy() for n, t in
             list(tm.named_parameters()) + list(tm.named_buffers())}
    with jax_host_init():
        jm = make(jvm)
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected, (missing[:3], unexpected[:3])
    jstate = {n: np.asarray(v) for n, v in state_values(jm).items()}
    back = layer_params_from_jax(jstate, make(pt.vision.models,
                                              device="cpu"))
    return request.param, jm, back, state, batch()


def test_state_moves_over_name_for_name(pair):
    name, jm, tm, state, _ = pair
    assert len(state) == len(state_values(jm))
    for n, t in list(tm.named_parameters()) + list(tm.named_buffers()):
        np.testing.assert_array_equal(t.detach().numpy(), state[n])
    if name == "crnn":
        assert "encoder.rnns.1.rnn_bw.cell.weight_hh" in state
        assert len(list(tm.named_parameters())) == 36


def _jax_forward(jm, x, training):
    """The JAX model's outputs on x, train or eval mode, compiled
    (``jax_forward``: a fraction of its eager forward's time)."""
    jm.train() if training else jm.eval()
    out = jax_forward(jm, x)
    jm.train()
    return out["maps"] if isinstance(out, dict) else out


def test_train_and_eval_outputs(pair):
    """The eval outputs (the running statistics), then the train-mode ones
    (batch statistics; the port's forward moves its running ones, JAX's
    compiled forward leaves them)."""
    name, jm, tm, _, batch = pair
    out_tol = TOL[name][0]
    x = torch.from_numpy(batch[0])
    for training in (False, True):
        tm.train(training)
        with torch.no_grad():
            tout = tm(x)
        tout = tout["maps"] if name == "dbnet" else tout
        if name == "dbnet":
            assert tout.shape[1] == (3 if training else 1)
        else:
            assert tuple(tout.shape) == (2, 11, 11)
        assert _rel(tout.numpy(), _jax_forward(jm, batch[0], training)) < \
            out_tol, training
    tm.train()


def _steps(pair):
    name, jm, _, state, batch = pair
    _, _, jwrap, twrap = MODELS[name]
    make = MODELS[name][0]
    with jax_host_init():
        jfresh = make(jvm)
    jfresh.set_state_dict(state)
    jw = jwrap(jfresh)
    with jax_jit_at_o0():
        jeng = JEngine(jw, optimizer=paddle.optimizer.Adam(
            learning_rate=LR, parameters=jw.parameters()), loss_fn=None,
            remat=False)
        jloss = float(jeng.train_batch(*map(paddle.to_tensor, batch)))
    tfresh = make(pt.vision.models, device="cpu")
    tfresh.set_state_dict(state)
    tw = twrap(tfresh)
    teng = ParallelEngine(tw, optimizer=pt.optimizer.Adam(
        learning_rate=LR, parameters=tw.parameters()), loss_fn=None,
        remat=False)
    return jeng, jloss, teng, tw, batch


def test_one_engine_step_matches_jax(pair):
    """The loss, every parameter after the Adam step, both moments and the
    statistics; the step body reads no device value on the host."""
    from test_torch_train_graph import NoHostRead

    jeng, jloss, teng, tw, batch = _steps(pair)
    orig = teng._train_body

    def guarded(b):
        with NoHostRead():
            return orig(b)

    teng._train_body = guarded
    tloss = float(teng.train_batch(*map(torch.from_numpy, batch)))
    out_tol, grad_tol = TOL[pair[0]]
    assert abs(tloss - jloss) <= out_tol * abs(jloss)
    js = jeng.engine_state_dict()
    ts = teng.engine_state_dict()
    prefix = "rec." if pair[0] == "crnn" else "det."
    for n, p in tw.named_parameters():
        m1 = js["opt_state"][n]["moment1"]
        noise = np.abs(m1) <= NOISE * np.abs(m1).max()
        gap = np.abs(p.detach().numpy() - js["params"][n])
        assert gap[~noise].max(initial=0) <= PARAM_ATOL, n
        assert gap[noise].max(initial=0) <= 2 * LR + PARAM_ATOL, n
        for slot in ("moment1", "moment2"):
            assert _rel(ts["opt_state"][n][slot],
                        js["opt_state"][n][slot]) < grad_tol, (n, slot)
    for n, b in tw.named_buffers():
        assert _rel(b.numpy(), js["params"][n]) < out_tol, n
    assert any(n.startswith(prefix) for n, _ in tw.named_buffers())
