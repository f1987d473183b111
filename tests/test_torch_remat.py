"""Remat in the PyTorch port: ``ParallelEngine(remat=True, remat_policy=)``
under each of the JAX engine's policies and None, and ``cfg.recompute``,
on the CPU in fp32. One step of each gives the loss and the gradients of
the step without remat (recompute replays the same operations on the
same inputs), and the loss and parameters of the JAX engine under the
same policy; the activation bytes a forward leaves for its backward
order as the policies say; the checkpoint names sit where the JAX model
sets them and are anchored (copied) only where a policy saves them; the
policies the port does not take, and a model with no layer to
checkpoint, raise."""
import gc

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.distributed.fleet.recompute import (REMAT_POLICIES,
                                                         anchored,
                                                         checkpoint_name)
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
B, S = 4, 32
# the same operations on the same inputs: 1e-6 relative leaves room for a
# library that picks another kernel on a replay (none does on the CPU)
SAME = dict(rtol=1e-6, atol=0)
# against the JAX engine, as tests/test_torch_train_step.py
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# every way the port recomputes: (remat, remat_policy, cfg.recompute)
MODES = {**{p: (True, p, False) for p in REMAT_POLICIES},
         "None": (True, None, False), "recompute": (False, "dots", True)}


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], 1).astype(
        np.int64)
    return ids, labels


class _Whole(torch.nn.Module):
    """The model behind a wrapper module: the engine's scope still reaches
    the decoder layers inside."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, labels):
        return self.m(ids, labels)


def _port_step(mode=None, grad_accum=1, whole=False, state=None):
    """(loss, {name: grad}, params after the step) of one port step."""
    remat, policy, rec = MODES[mode] if mode else (False, "dots", False)
    cfg = llama_tiny_config(**TINY, recompute=rec)
    m = LlamaForCausalLM(cfg, device="cpu", seed=1)
    if state is not None:
        m.load_state_dict(params_from_jax(state, cfg))
    opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    eng = ParallelEngine(_Whole(m) if whole else m, optimizer=opt,
                         remat=remat, remat_policy=policy,
                         grad_accum=grad_accum)
    grads = {}
    update = opt.update

    def spy(items, lr, step):
        grads.update({n.removeprefix("m."): g.clone() for n, _, g in items})
        return update(items, lr, step)

    opt.update = spy
    ids, labels = _batch(cfg.vocab_size)
    loss = eng.train_batch(ids, labels).item()
    params = {n.removeprefix("m."): v
              for n, v in eng.engine_state_dict()["params"].items()}
    return loss, grads, params


@pytest.fixture(scope="module")
def plain_step():
    return {accum: _port_step(grad_accum=accum) for accum in (1, 2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_step_equals_the_step_without_remat(mode, plain_step):
    loss, grads, _ = _port_step(mode)
    want_loss, want_grads, _ = plain_step[1]
    np.testing.assert_allclose(loss, want_loss, **SAME)
    assert set(grads) == set(want_grads)
    for n, g in want_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), err_msg=n,
                                   **SAME)


@pytest.mark.parametrize("whole,accum,mode", [(True, 1, "dots"),
                                              (True, 1, "nothing"),
                                              (False, 2, "save_attn")],
                         ids=["wrapped-dots", "wrapped-nothing",
                              "per_layer-accum2"])
def test_wrapped_and_microbatch_remat_equal_the_plain_step(
        whole, accum, mode, plain_step):
    """A model behind a wrapper module is checkpointed per layer all the
    same; with ``grad_accum`` each microbatch is checkpointed on its own.
    Both give the plain step's loss and gradients."""
    loss, grads, _ = _port_step(mode, grad_accum=accum, whole=whole)
    want_loss, want_grads, _ = plain_step[accum]
    np.testing.assert_allclose(loss, want_loss, **SAME)
    for n, g in want_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), err_msg=n,
                                   **SAME)


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_step_matches_jax_engine_under_the_same_policy(mode):
    remat, policy, rec = MODES[mode]
    paddle.seed(3)
    jm = JModel(JConfig(**TINY, recompute=rec))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  weight_decay=0.01, grad_clip=JClip(1.0))
    jeng = JEngine(jm, optimizer=jopt, remat=remat, remat_policy=policy,
                   donate=False)
    ids, labels = _batch(TINY["vocab_size"])
    jloss = float(jeng.train_batch(paddle.to_tensor(ids),
                                   paddle.to_tensor(labels)))
    jparams = jeng.engine_state_dict()["params"]
    loss, _, params = _port_step(mode, state=state)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    assert set(params) == set(jparams)
    for n, want in jparams.items():
        np.testing.assert_allclose(params[n], np.asarray(want), err_msg=n,
                                   **PARAM_TOL)


class _Live(TorchDispatchMode):
    """Records the storage of every tensor an op makes, to count after a
    forward the bytes still held for the backward: what autograd saved,
    what a selective checkpoint cached and the checkpoints' inputs."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.setdefault(st._cdata, (StorageWeakRef(st),
                                                 st.nbytes()))
        return out

    def live_bytes(self):
        return sum(n for ref, n in self.made.values() if not ref.expired())


def _saved_bytes(mode):
    remat, policy, rec = MODES.get(mode, (False, "dots", False))
    m = LlamaForCausalLM(llama_tiny_config(**TINY, recompute=rec),
                         device="cpu", seed=1)
    eng = ParallelEngine(m, optimizer=AdamW(
        parameters=m.named_parameters()), remat=remat, remat_policy=policy)
    ids, labels = (torch.from_numpy(a) for a in _batch(TINY["vocab_size"]))
    live = _Live()
    with live:
        loss = eng._step_loss((ids, labels))
    gc.collect()
    held = live.live_bytes()
    loss.backward()
    return held


def test_saved_activation_bytes_order_as_the_policies_say():
    """nothing = None < save_attn < save_attn_mlp, save_qkv_attn < dots <
    no remat, and cfg.recompute (full recompute per layer) = nothing."""
    got = {mode: _saved_bytes(mode) for mode in ("no_remat", *MODES)}
    assert got["None"] == got["nothing"] == got["recompute"], got
    assert got["nothing"] < got["save_attn"] < got["save_attn_mlp"], got
    assert got["save_attn"] < got["save_qkv_attn"], got
    assert max(got["save_attn_mlp"], got["save_qkv_attn"]) < got["dots"], got
    assert got["dots"] < got["no_remat"], got


class _Names(TorchDispatchMode):
    """Records (name, shape) of every anchor op run."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.paddle_tpu_torch.checkpoint_name.default:
            self.seen.append((args[1], tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def test_checkpoint_names_sit_where_the_jax_model_sets_them():
    """Per layer: q, k and v named ``qkv`` after the projections, the
    attention output ``attn_out`` and the MLP output ``mlp_out`` (the
    names the engine's policies save; a rename would silently save
    nothing)."""
    cfg = llama_tiny_config(**TINY)
    m = LlamaForCausalLM(cfg, device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    with anchored(("qkv", "attn_out", "mlp_out")), _Names() as names:
        m(ids, labels)
    hd = cfg.head_dim
    layer = [("qkv", (B, S, 4, hd)), ("qkv", (B, S, 2, hd)),
             ("qkv", (B, S, 2, hd)), ("attn_out", (B, S, 4, hd)),
             ("mlp_out", (B, S, cfg.hidden_size))]
    assert names.seen == layer * cfg.num_hidden_layers


@pytest.mark.parametrize("mode", ["no_remat", *MODES])
def test_anchors_are_copied_only_where_the_policy_saves_them(mode):
    """The anchor is a copy: a forward makes one for each name its policy
    saves, and none without remat, under ``cfg.recompute``, ``dots``,
    ``nothing`` or None."""
    remat, policy, rec = MODES.get(mode, (False, "dots", False))
    cfg = llama_tiny_config(**TINY, recompute=rec)
    m = LlamaForCausalLM(cfg, device="cpu", seed=1)
    eng = ParallelEngine(m, optimizer=AdamW(
        parameters=m.named_parameters()), remat=remat, remat_policy=policy)
    ids, labels = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    with _Names() as names:
        loss = eng._step_loss((ids, labels))
    saved = {"save_attn": ["attn_out"],
             "save_attn_mlp": ["attn_out", "mlp_out"],
             "save_qkv_attn": ["qkv"] * 3 + ["attn_out"]}.get(mode, [])
    assert [n for n, _ in names.seen] == saved * cfg.num_hidden_layers
    loss.backward()


def test_remat_of_a_model_without_layer_checkpoints_raises():
    """remat=True checkpoints decoder layers: a model that runs none
    through the engine's scope is refused, not trained without remat."""
    lin = torch.nn.Linear(8, 4)

    def loss_fn(out, label):
        return torch.nn.functional.cross_entropy(out, label)

    eng = ParallelEngine(lin, optimizer=AdamW(
        parameters=lin.named_parameters()), loss_fn=loss_fn, remat=True,
        remat_policy="nothing")
    with pytest.raises(NotImplementedError, match="ran none"):
        eng.train_batch(torch.randn(2, 8), torch.tensor([0, 3]))


def test_checkpoint_name_is_an_identity_with_an_identity_gradient():
    x = torch.randn(2, 3, 5).transpose(1, 2).requires_grad_()
    assert checkpoint_name(x, "attn_out") is x
    with anchored(("attn_out",)):
        y = checkpoint_name(x, "attn_out")
    assert y.is_contiguous() and torch.equal(y, x)
    g = torch.randn(2, 5, 3)
    y.backward(g)
    assert torch.equal(x.grad, g)


def test_unported_and_unknown_policies_raise():
    """``offload_attn`` is ported now (it builds; its gradients are held
    to JAX in tests/test_torch_offload.py); an unknown name still raises
    ValueError."""
    m = LlamaForCausalLM(llama_tiny_config(**TINY), device="cpu")
    opt = AdamW(parameters=m.named_parameters())
    eng = ParallelEngine(m, optimizer=opt, remat=True,
                         remat_policy="offload_attn")
    assert eng.remat_policy == "offload_attn"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ParallelEngine(m, optimizer=opt, remat=True, remat_policy="bogus")


def test_recompute_matches_a_direct_call_and_rejects_unknown_kwargs():
    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4, requires_grad=True)

    def f(a):
        return torch.tanh(a @ w).sum()

    f(x).backward()
    want = (x.grad.clone(), w.grad.clone())
    x.grad = w.grad = None
    recompute(f, x, preserve_rng_state=False, use_reentrant=True).backward()
    assert torch.equal(x.grad, want[0]) and torch.equal(w.grad, want[1])
    with pytest.raises(ValueError, match="unsupported kwargs"):
        recompute(f, x, offload=True)
