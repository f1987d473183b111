"""The train engine's compiled step (``paddle_tpu_torch/parallel/engine.py``)
on the CPU, where its body runs eagerly: no host read of a device value in
the train body (Llama with the global-norm clip, ``grad_accum=2`` and each
remat policy; ERNIE with dropout) or the eval body, shown by a dispatch
mode that raises on the ops that read one; and, on a CPU stand-in for the
CUDA graph calls (a capture records the body and runs nothing, a replay
runs it), the warm-up rule (the first call of a key is a real step,
counted once; the second captures; N calls make N steps, equal bit for bit
to the eager engine's), ``set_engine_state`` in the middle of a graphed
run continuing as the JAX engine does, and the refusals: a replaced
weight, a failed capture (no eager rerun). The graphs themselves run on
the card (``chip_smoke.py`` phase 27)."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch import graphs, ops
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.ernie import (ErnieForSequenceClassification,
                                           ernie_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import ParallelEngine

B, S = 4, 32
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
# as tests/test_torch_train_step.py: fp32, summation order only
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-7)

_aten = torch.ops.aten
# the ops that make the host wait for a device value (a CUDA graph
# capture refuses each)
HOST_READS = {_aten._local_scalar_dense, _aten.item, _aten.nonzero,
              _aten.masked_select, _aten.is_nonzero, _aten.equal}


# indexing with a boolean mask counts its True entries on the host (its
# nonzero runs inside the op, below the dispatcher)
MASK_INDEXING = {_aten.index, _aten.index_put, _aten.index_put_}


class NoHostRead(TorchDispatchMode):
    """Raises on any op of ``HOST_READS`` and on boolean-mask indexing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in HOST_READS or op in MASK_INDEXING and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            raise AssertionError(f"host read of a device value: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    ops.set_kernel_mode("auto")


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)],
                            1).astype(np.int64)
    labels[1, :5] = -100
    return ids, labels


def _llama_engine(seed=1, **kw):
    cfg = llama_tiny_config(**TINY)
    m = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    opt = AdamW(learning_rate=_schedule(tlr),
                parameters=m.named_parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    return ParallelEngine(m, optimizer=opt, **kw)


def _guard(eng, name):
    """Run the engine's ``name`` body (``_train_body`` / ``_eval_body``)
    under :class:`NoHostRead`; returns the count of guarded runs."""
    orig = getattr(eng, name)
    runs = []

    def guarded(batch):
        with NoHostRead():
            out = orig(batch)
        runs.append(1)
        return out

    setattr(eng, name, guarded)
    return runs


def test_detector_catches_a_host_read():
    """The dispatch mode is live: ``.item()``, ``bool()`` and a boolean
    mask each raise under it."""
    x = torch.ones(3)
    for read in (lambda: x.sum().item(), lambda: bool(x[0] > 0),
                 lambda: x[x > 0], lambda: torch.nonzero(x)):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostRead():
                read()


@pytest.mark.parametrize("remat,policy", [
    (False, None), (True, "dots"), (True, "nothing"), (True, "save_attn"),
    (True, "save_attn_mlp"), (True, "save_qkv_attn"), (True, None)],
    ids=["no_remat", "dots", "nothing", "save_attn", "save_attn_mlp",
         "save_qkv_attn", "full"])
def test_llama_step_body_reads_no_device_value(remat, policy):
    """Llama, global-norm clip, ``grad_accum=2``, under each remat policy:
    two train steps and an eval pass with no host read in their bodies."""
    eng = _llama_engine(grad_accum=2, remat=remat, remat_policy=policy)
    runs = _guard(eng, "_train_body")
    eval_runs = _guard(eng, "_eval_body")
    ids, labels = _batch(256)
    losses = [eng.train_batch(ids, labels).item() for _ in range(2)]
    assert len(runs) == 2 and losses[1] < losses[0]
    assert np.isfinite(eng.eval_batch(ids, labels).item())
    assert len(eval_runs) == 1


def test_ernie_dropout_step_body_reads_no_device_value():
    """ERNIE's sequence-classification head with hidden and attention
    dropout 0.1 (attention on SDPA's reference path): train and eval
    bodies read no device value on the host."""
    cfg = ernie_tiny_config(hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1)
    m = ErnieForSequenceClassification(cfg, num_classes=2, device="cpu",
                                       seed=3)
    eng = ParallelEngine(m, optimizer=AdamW(
        learning_rate=1e-3, parameters=m.named_parameters()),
        loss_fn=m.loss_fn)
    runs = _guard(eng, "_train_body")
    eval_runs = _guard(eng, "_eval_body")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    labels = rng.integers(0, 2, (B,)).astype(np.int64)
    for _ in range(2):
        assert np.isfinite(eng.train_batch(ids, labels).item())
    m.eval()
    assert np.isfinite(eng.eval_batch(ids, labels).item())
    assert len(runs) == 2 and len(eval_runs) == 1


class _CpuGraph:
    """Stands in for a captured graph: the capture ran nothing, each
    replay runs the recorded body (a real replay re-runs its kernels)."""

    def __init__(self, body, generators):
        self.body = body
        self.generators = tuple(generators)
        self.replays = 0

    def replay(self):
        self.replays += 1
        return self.body()


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The engine's graph calls on the CPU: a warm-up runs the body on the
    caller's stream; a capture records it (:class:`_CpuGraph`)."""
    made = []

    def capture(body, generators=(), pool=None):
        made.append(_CpuGraph(body, generators))
        return made[-1]

    monkeypatch.setattr(graphs, "warm_up", lambda body, device: body())
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    return made


def _graphed(eng):
    eng.graphs = True
    return eng


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_n_calls_make_n_steps_equal_to_the_eager_engine(cpu_graphs,
                                                        grad_accum):
    """The first call of a key is the warm-up and a real step, the second
    captures (running nothing) and replays, later calls replay: after N
    calls the device step count, the host mirror and the schedule stand at
    N, and the losses, parameters and moments equal the eager engine's bit
    for bit (the lr of every replay comes through the device scalar)."""
    N = 5
    ids, labels = _batch(256, seed=2)
    eager = _llama_engine(grad_accum=grad_accum)
    graphed = _graphed(_llama_engine(grad_accum=grad_accum))
    le = [eager.train_batch(ids, labels).item() for _ in range(N)]
    lg = [graphed.train_batch(ids, labels).item() for _ in range(N)]
    assert lg == le
    assert graphed.captures == 1 and len(cpu_graphs) == 1
    assert cpu_graphs[0].replays == N - 1 == graphed.replays["train"]
    assert int(graphed._step_dev) == graphed._step_count == N
    assert int(eager._step_dev) == N and eager.captures == 0
    assert graphed.optimizer._learning_rate.last_epoch == N
    se, sg = eager.engine_state_dict(), graphed.engine_state_dict()
    assert sg["step"] == N
    for n in se["params"]:
        np.testing.assert_array_equal(sg["params"][n], se["params"][n])
        for k in se["opt_state"][n]:
            np.testing.assert_array_equal(sg["opt_state"][n][k],
                                          se["opt_state"][n][k])
    # a new shape is a new key: its own warm-up, then its own graph
    graphed.train_batch(ids[:2], labels[:2])
    graphed.train_batch(ids[:2], labels[:2])
    assert graphed.captures == 2 and graphed._step_count == N + 2
    # the eval graph: a warm-up, then a capture on the second call
    for _ in range(3):
        graphed.eval_batch(ids, labels)
    assert graphed.captures == 3 and graphed.replays["eval"] == 2


def test_eager_by_rule(cpu_graphs):
    """On the CPU (graphs off), under the "reference" kernel mode and with
    ``graphs = False`` every call runs eagerly: nothing is captured."""
    ids, labels = _batch(256)
    plain = _llama_engine()
    for _ in range(3):
        plain.train_batch(ids, labels)
    assert not plain.graphs and plain.captures == 0
    ref = _graphed(_llama_engine())
    ops.set_kernel_mode("reference")
    for _ in range(3):
        ref.train_batch(ids, labels)
    assert ref.captures == 0 and not cpu_graphs


def test_set_engine_state_mid_run_continues_like_jax(cpu_graphs):
    """Two steps on the graphed port engine and on the JAX engine, then
    the JAX engine's state copied into the port's (in place: its graph
    stays valid), two more steps each: the later losses, the parameters,
    the moments and the step count (4, on the device too) agree."""
    paddle.seed(6)
    jm = JModel(JConfig(**TINY))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = llama_tiny_config(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    jeng = JEngine(jm, optimizer=JAdamW(
        learning_rate=_schedule(jlr), parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=JClip(1.0)), loss_fn=None)
    teng = _graphed(ParallelEngine(tm, optimizer=AdamW(
        learning_rate=_schedule(tlr), parameters=tm.named_parameters(),
        weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))))
    ids, labels = _batch(cfg.vocab_size, seed=3)
    jl, tl = [], []

    def step():
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids),
                                   torch.from_numpy(labels)).item())

    step()
    step()
    assert teng.captures == 1
    teng.set_engine_state(jeng.engine_state_dict())
    assert int(teng._step_dev) == teng._step_count == 2
    step()
    step()
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert teng.captures == 1 and teng.replays["train"] == 3
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    assert ts["step"] == js["step"] == 4 and int(teng._step_dev) == 4
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)
        for k, w in js["opt_state"][n].items():
            np.testing.assert_allclose(ts["opt_state"][n][k], np.asarray(w),
                                       err_msg=f"{n}.{k}", **MOMENT_TOL)


def test_replaced_weight_raises_at_the_next_call(cpu_graphs):
    """A parameter replaced after the capture (a new tensor, not a copy
    into the old one) raises at the next ``train_batch``."""
    eng = _graphed(_llama_engine())
    ids, labels = _batch(256)
    for _ in range(3):
        eng.train_batch(ids, labels)
    w = eng.model.lm_head.weight
    eng.model.lm_head.weight = torch.nn.Parameter(w.detach().clone())
    with pytest.raises(RuntimeError, match="replaced"):
        eng.train_batch(ids, labels)
    assert eng._step_count == 3 and int(eng._step_dev) == 3


def test_failed_capture_raises_without_an_eager_rerun(cpu_graphs,
                                                      monkeypatch):
    """A capture that fails raises out of ``train_batch``; the step is not
    run eagerly instead (the step count stays at the warm-up's 1)."""
    eng = _graphed(_llama_engine())
    ids, labels = _batch(256)
    eng.train_batch(ids, labels)

    def refuse(body, generators=(), pool=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "capture", refuse)
    with pytest.raises(RuntimeError, match="capturing"):
        eng.train_batch(ids, labels)
    assert eng._step_count == 1 and int(eng._step_dev) == 1
    assert eng.captures == 0
