"""The high-level API and the metrics of the PyTorch port
(``paddle_tpu_torch/hapi``: ``Model`` with ``fit`` / ``evaluate`` /
``predict`` / ``save`` / ``load``, the callbacks, ``summary``;
``paddle_tpu_torch/metric``) against the JAX package on the CPU.

``Model.fit`` runs LeNet on 64 synthetic MNIST images (``ToTensor`` +
``Normalize``) with Adam, ``CrossEntropyLoss`` and ``Accuracy(topk=(1,
2))``, the JAX package's weights carried into the port
(``models/convert.layer_params_from_jax``), ``shuffle=False``: every
step's loss within 1e-5 of the JAX package's (relative), the trained
parameters within 1e-5 of their largest value (plus 1e-2 of the learning
rate, ``_close_params``), eval metrics and predict outputs likewise;
under ``accumulate_grad_batches=2`` the same; under ``amp_configs="O1"``
(bf16 products in both packages; an MLP, see ``_mlps``) the losses
within 2e-2 and the parameters within 5e-3 of their largest value. The metrics
are numpy on the host in both packages and are held exactly."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.jit import state_values
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.models.convert import layer_params_from_jax
from torch_tensor_parity import host

RNG = np.random.RandomState(0)


# ------------------------------------------------------------- metrics

PRED = RNG.rand(12, 5).astype(np.float32)
PRED[0, [1, 3]] = PRED[0].max() + 1              # a tie at the top
LABEL = RNG.randint(0, 5, (12, 1)).astype(np.int64)
PROB = RNG.rand(40, 2).astype(np.float32)
BIN = RNG.randint(0, 2, (40, 1)).astype(np.int64)


def _wrap(pkg, v):
    if isinstance(v, np.ndarray):
        return (pkg.to_tensor(v) if pkg is jpaddle
                else torch.from_numpy(v.copy()))
    return v


def _metric_run(pkg, make, batches):
    m = make(pkg)
    out = []
    for args in batches:
        args = [_wrap(pkg, a) for a in args]
        if isinstance(m, pkg.metric.Accuracy):
            out.append(m.update(m.compute(*args)))
        else:
            out.append(m.update(*args))
    out.append(m.accumulate())
    out.append(m.name())
    m.reset()
    out.append(m.accumulate())
    return out


METRICS = {
    "accuracy": (lambda pkg: pkg.metric.Accuracy(),
                 [(PRED, LABEL), (PRED[:5], LABEL[:5])]),
    "accuracy_topk": (lambda pkg: pkg.metric.Accuracy(topk=(1, 3),
                                                      name="a"),
                      [(PRED, LABEL)]),
    "accuracy_one_hot": (lambda pkg: pkg.metric.Accuracy(topk=2),
                         [(PRED, np.eye(5, dtype=np.float32)[
                             LABEL[:, 0]])]),
    "precision": (lambda pkg: pkg.metric.Precision(),
                  [(PROB[:, 1], BIN), (PROB[:10, 0], BIN[:10])]),
    "recall": (lambda pkg: pkg.metric.Recall(name="r"),
               [(PROB[:, 1], BIN)]),
    "auc": (lambda pkg: pkg.metric.Auc(), [(PROB, BIN)]),
    "auc_one_column": (lambda pkg: pkg.metric.Auc(num_thresholds=200),
                       [(PROB[:, 0], BIN), (PROB[:, 1], 1 - BIN)]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(name):
    make, batches = METRICS[name]
    j = _metric_run(jpaddle, make, batches)
    t = _metric_run(tpaddle, make, batches)
    assert t == j, (name, t, j)


def test_accuracy_compute_and_function_match_jax():
    jm, tm = jpaddle.metric.Accuracy((1, 2)), tpaddle.metric.Accuracy((1, 2))
    j = jm.compute(jpaddle.to_tensor(PRED), jpaddle.to_tensor(LABEL))
    t = tm.compute(torch.from_numpy(PRED), torch.from_numpy(LABEL))
    np.testing.assert_array_equal(host(t), host(j))
    # bf16 predictions read back widened: the same ranks
    tb = tm.compute(torch.from_numpy(PRED).bfloat16(),
                    torch.from_numpy(LABEL))
    assert tb.dtype == torch.float32 and tb.shape == (12, 2)
    for k in (1, 2):
        j = jpaddle.metric.accuracy(jpaddle.to_tensor(PRED),
                                    jpaddle.to_tensor(LABEL), k=k)
        t = tpaddle.metric.accuracy(torch.from_numpy(PRED),
                                    torch.from_numpy(LABEL), k=k)
        assert t.dtype == torch.float32 and t.dim() == 0
        assert float(t) == float(host(j))


# ------------------------------------------------------------- Model.fit

N_IMAGES, B = 64, 16


def _data(pkg, n=N_IMAGES):
    T = pkg.vision.transforms
    tfm = T.Compose([T.ToTensor(), T.Normalize([0.5], [0.5])])
    return pkg.io.Subset(pkg.vision.datasets.MNIST(transform=tfm),
                         list(range(n)))


@pytest.fixture(scope="module")
def lenet_state():
    """The JAX package's seeded LeNet weights, as numpy."""
    jpaddle.seed(0)
    return {n: np.asarray(v) for n, v in
            state_values(jpaddle.vision.models.LeNet()).items()}


def _nets(state):
    jm = jpaddle.vision.models.LeNet()
    jm.set_state_dict(state)
    tm = tpaddle.vision.models.LeNet(device="cpu")
    layer_params_from_jax(state, tm)
    return jm, tm


def _mlp(pkg, **kw):
    return pkg.nn.Sequential(pkg.nn.Flatten(), pkg.nn.Linear(784, 32, **kw),
                             pkg.nn.ReLU(), pkg.nn.Linear(32, 10, **kw))


def _mlps():
    """An MLP of the same seeded weights in both packages (the AMP case:
    the JAX package's O1 refuses LeNet's convolutions, "lax.conv_general_
    dilated requires arguments to have the same dtypes", casting the
    input and not the weight)."""
    torch.manual_seed(0)
    tm = _mlp(tpaddle, device="cpu")
    jm = _mlp(jpaddle)
    jm.set_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    return jm, tm


def _model(pkg, net, metrics=True, amp=None, lr=1e-3):
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.Adam(learning_rate=lr,
                                 parameters=net.parameters()),
              pkg.nn.CrossEntropyLoss(),
              pkg.metric.Accuracy(topk=(1, 2)) if metrics else None,
              amp_configs=amp)
    return m


def _recorder(pkg):
    class Rec(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.epochs, self.evals = [], 0, []

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs += 1

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs or {}))

    return Rec()


def _params(net):
    return {n: host(p) for n, p in net.named_parameters()}


def _close_params(j, t, rel, lr=1e-3):
    """Within ``rel`` of each parameter's largest value, plus 1e-2 of the
    learning rate: Adam moves a weight whose gradient is near zero by
    about ±lr whatever the gradient's size, so a rounding in such a
    gradient moves the weight by a fraction of lr."""
    assert j.keys() == t.keys()
    for n in j:
        scale = max(np.abs(j[n]).max(), 1e-6)
        np.testing.assert_allclose(t[n], j[n], rtol=0,
                                   atol=rel * scale + 1e-2 * lr, err_msg=n)


def _fit(pkg, net, **kw):
    amp = kw.pop("amp", None)
    m = _model(pkg, net, amp=amp)
    rec = _recorder(pkg)
    m.fit(_data(pkg), _data(pkg, 32), batch_size=B, epochs=1,
          shuffle=False, verbose=0, callbacks=[rec], **kw)
    ev = m.evaluate(_data(pkg, 32), batch_size=B)
    pred = m.predict(_data(pkg, 32), batch_size=B, stack_outputs=True)
    return m, rec, ev, pred


@pytest.mark.parametrize("case", ["plain", "accumulate", "amp_o1"])
def test_fit_evaluate_predict_match_jax(lenet_state, case):
    kw = {"accumulate": dict(accumulate_grad_batches=2),
          "amp_o1": dict(amp="O1")}.get(case, {})
    loss_tol, param_tol = (2e-2, 5e-3) if case == "amp_o1" else (1e-5, 1e-5)
    jm, tm = _mlps() if case == "amp_o1" else _nets(lenet_state)
    jmodel, jrec, jev, jpred = _fit(jpaddle, jm, **dict(kw))
    tmodel, trec, tev, tpred = _fit(tpaddle, tm, **dict(kw))
    assert len(trec.losses) == len(jrec.losses) == N_IMAGES // B
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=loss_tol)
    _close_params(_params(jm), _params(tm), param_tol)
    assert tev.keys() == jev.keys() == {"loss", "acc_top1"}
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=loss_tol)
    assert len(tpred) == len(jpred) == 1 and tpred[0].shape == (32, 10)
    assert isinstance(tpred[0], np.ndarray)
    scale = np.abs(jpred[0]).max()
    np.testing.assert_allclose(tpred[0], jpred[0], rtol=0,
                               atol=max(param_tol, loss_tol) * scale)
    assert trec.evals[-1].keys() == jrec.evals[-1].keys()
    assert {p.device.type for p in tm.parameters()} == {"cpu"}


def test_fit_through_two_worker_processes_equals_one_process(lenet_state):
    """``fit(num_workers=2)``: the batches come from the worker pool and
    the run equals the single-process one step for step, bit for bit."""
    runs = []
    for workers in (0, 2):
        _, tm = _nets(lenet_state)
        m = _model(tpaddle, tm)
        rec = _recorder(tpaddle)
        m.fit(_data(tpaddle), batch_size=B, shuffle=False, verbose=0,
              callbacks=[rec], num_workers=workers)
        runs.append((rec.losses, _params(tm)))
    assert runs[0][0] == runs[1][0]
    for n in runs[0][1]:
        np.testing.assert_array_equal(runs[1][1][n], runs[0][1][n])


def test_train_and_eval_batch_move_numpy_and_cpu_inputs(lenet_state):
    _, tm = _nets(lenet_state)
    m = _model(tpaddle, tm, metrics=False)
    x = np.random.RandomState(1).randn(4, 1, 28, 28).astype(np.float32)
    y = np.arange(4, dtype=np.int64)[:, None]
    loss = m.train_batch([x], y)
    assert isinstance(loss, list) and np.isfinite(loss[0])
    assert len(m.eval_batch(torch.from_numpy(x), torch.from_numpy(y))) == 1
    out = m.predict_batch(torch.from_numpy(x))
    assert out[0].shape == (4, 10) and out[0].dtype == np.float32
    assert len(m.parameters()) == 10


# ------------------------------------------------------------- save / load

def _eval_logits(pkg, net, x):
    net.eval()
    if pkg is jpaddle:
        return host(net(jpaddle.to_tensor(x)))
    with torch.no_grad():
        return host(net(torch.from_numpy(x)))


def test_save_load_round_trips_and_crosses_packages(lenet_state, tmp_path):
    x = np.random.RandomState(2).randn(3, 1, 28, 28).astype(np.float32)
    jm, tm = _nets(lenet_state)
    tmodel = _model(tpaddle, tm)
    tmodel.fit(_data(tpaddle, 32), batch_size=B, shuffle=False, verbose=0)
    tmodel.save(str(tmp_path / "port" / "ckpt"))
    assert (tmp_path / "port" / "ckpt.pdparams").exists()
    assert (tmp_path / "port" / "ckpt.pdopt").exists()
    want = _eval_logits(tpaddle, tm, x)

    # the port's file in a fresh port model: logits bit for bit, the
    # optimizer's moments and step too
    _, tm2 = _nets(lenet_state)
    m2 = _model(tpaddle, tm2)
    m2.load(str(tmp_path / "port" / "ckpt"))
    np.testing.assert_array_equal(_eval_logits(tpaddle, tm2, x), want)
    sd, sd2 = tmodel._optimizer.state_dict(), m2._optimizer.state_dict()
    assert sd.keys() == sd2.keys() and sd2["global_step"] == 2
    for k in sd:
        if isinstance(sd[k], torch.Tensor):
            assert torch.equal(sd[k], sd2[k]), k

    # the port's file in the JAX package's Model
    jmodel = _model(jpaddle, jm)
    jmodel.load(str(tmp_path / "port" / "ckpt"), reset_optimizer=True)
    np.testing.assert_allclose(_eval_logits(jpaddle, jm, x), want,
                               rtol=1e-5, atol=1e-5)

    # the JAX package's file in the port's Model
    jmodel.fit(_data(jpaddle, 16), batch_size=B, shuffle=False, verbose=0)
    jmodel.save(str(tmp_path / "jax" / "ckpt"), training=False)
    _, tm3 = _nets(lenet_state)
    _model(tpaddle, tm3).load(str(tmp_path / "jax" / "ckpt"))
    np.testing.assert_allclose(_eval_logits(tpaddle, tm3, x),
                               _eval_logits(jpaddle, jm, x),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- callbacks

def _counting_fit(pkg, net, callbacks, epochs=4, eval_data=True, **kw):
    m = _model(pkg, net, metrics=False, **kw)
    rec = _recorder(pkg)
    m.fit(_data(pkg, 32), _data(pkg, 16) if eval_data else None,
          batch_size=B, epochs=epochs, shuffle=False, verbose=0,
          callbacks=[rec, *callbacks])
    return m, rec


def test_early_stopping_stops_as_in_jax(lenet_state):
    """Monitoring the falling eval loss in ``max`` mode: no epoch after the
    first improves, so training stops after the second."""
    out = []
    for pkg, net in zip((jpaddle, tpaddle), _nets(lenet_state)):
        es = pkg.callbacks.EarlyStopping("loss", mode="max", patience=0,
                                         verbose=0)
        m, rec = _counting_fit(pkg, net, [es])
        out.append((rec.epochs, m.stop_training, es.wait))
    assert out[1] == out[0] == (2, True, 1)


def test_model_checkpoint_writes_as_in_jax(lenet_state, tmp_path):
    for pkg, net in zip((jpaddle, tpaddle), _nets(lenet_state)):
        d = tmp_path / pkg.__name__
        cb = pkg.callbacks.ModelCheckpoint(save_freq=2, save_dir=str(d))
        _counting_fit(pkg, net, [cb], epochs=3, eval_data=False)
        assert sorted(os.listdir(d)) == ["1.pdopt", "1.pdparams",
                                         "final.pdopt", "final.pdparams"]
    # the port's checkpoint holds its trained weights
    x = np.zeros((1, 1, 28, 28), np.float32)
    _, tm = _nets(_zeroed(lenet_state))
    _model(tpaddle, tm).load(str(tmp_path / "paddle_tpu_torch" / "final"))
    assert np.abs(_eval_logits(tpaddle, tm, x)).max() > 0


def _zeroed(state):
    return {k: np.zeros_like(v) for k, v in state.items()}


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_steps_as_in_jax(lenet_state, by):
    out = []
    for pkg, net in zip((jpaddle, tpaddle), _nets(lenet_state)):
        sched = pkg.optimizer.lr.StepDecay(0.01, step_size=2, gamma=0.5)
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(learning_rate=sched,
                                    parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss())
        cb = pkg.callbacks.LRScheduler(by_step=by == "step",
                                       by_epoch=by == "epoch")
        m.fit(_data(pkg, 32), batch_size=B, epochs=3, shuffle=False,
              verbose=0, callbacks=[cb])
        out.append((sched.last_epoch, sched(), m._optimizer.get_lr()))
    assert out[1] == out[0]
    assert out[0][0] == (6 if by == "step" else 3)


def test_reduce_lr_on_plateau_cuts_as_in_jax(lenet_state):
    out = []
    for pkg, net in zip((jpaddle, tpaddle), _nets(lenet_state)):
        m = _model(pkg, net, metrics=False, lr=0.1)
        cb = pkg.callbacks.ReduceLROnPlateau(factor=0.5, patience=1)
        cb.set_model(m)
        lrs = []
        for loss in (1.0, 0.9, 0.95, 0.97, 0.8, [0.85]):
            cb.on_eval_end({"loss": loss})
            lrs.append(m._optimizer.get_lr())
        out.append(lrs)
    assert out[1] == out[0] == [0.1, 0.1, 0.05, 0.025, 0.025, 0.0125]


def test_visualdl_and_progbar_log_as_in_jax(lenet_state, tmp_path, capsys):
    rows = []
    for pkg, net in zip((jpaddle, tpaddle), _nets(lenet_state)):
        d = tmp_path / pkg.__name__
        cbs = [pkg.callbacks.VisualDL(str(d)),
               pkg.callbacks.ProgBarLogger(log_freq=2, verbose=1)]
        _counting_fit(pkg, net, cbs, epochs=1, eval_data=False)
        lines = (d / "scalars.tsv").read_text().splitlines()
        rows.append([ln.split("\t")[:2] for ln in lines])
        printed = capsys.readouterr().out.splitlines()
        rows.append([ln.split(" - ")[0] for ln in printed])
    assert rows[2] == rows[0] and rows[3] == rows[1]
    assert rows[1] == ["Epoch 0: step 0/2", "Epoch 0 done"]


def test_config_callbacks_matches_jax():
    from paddle_tpu.hapi.callbacks import config_callbacks as jcfg
    from paddle_tpu_torch.hapi.callbacks import config_callbacks as tcfg

    for kw in (dict(verbose=2), dict(verbose=0, callbacks=[None])):
        cbs = kw.pop("callbacks", None)
        j = jcfg([jpaddle.callbacks.VisualDL()] if cbs else None, epochs=2,
                 steps=3, **kw)
        t = tcfg([tpaddle.callbacks.VisualDL()] if cbs else None, epochs=2,
                 steps=3, **kw)
        assert [type(c).__name__ for c in t.callbacks] == \
            [type(c).__name__ for c in j.callbacks]
        assert t.callbacks[0].params == j.callbacks[0].params


# ------------------------------------------------------------- summary

def test_summary_counts_match_jax(lenet_state, capsys):
    jm, tm = _nets(lenet_state)
    for pkg, net in ((jpaddle, jm), (tpaddle, tm)):
        net.fc[1].weight.trainable = False
    j = jpaddle.summary(jm, (1, 1, 28, 28))
    jout = capsys.readouterr().out
    t = tpaddle.summary(tm, (1, 1, 28, 28))
    tout = capsys.readouterr().out
    assert t == j == {"total_params": 61610,
                      "trainable_params": 61610 - 400 * 120}
    assert tout == jout
    assert tpaddle.Model(tm).summary() == t

    # a layer shared twice counts once
    def shared(pkg, **kw):
        lin = pkg.nn.Linear(3, 3, **kw)
        return pkg.nn.Sequential(lin, pkg.nn.ReLU(), lin)

    assert tpaddle.summary(shared(tpaddle, device="cpu")) == \
        jpaddle.summary(shared(jpaddle)) == {"total_params": 12,
                                             "trainable_params": 12}
