"""ERNIE in the PyTorch port (``paddle_tpu_torch/models/ernie.py`` and the
layers under it) against the JAX package on the CPU, fp32, with the same
numpy inputs and the JAX weights carried across by
``ernie_params_from_jax``: ``scaled_dot_product_attention`` on both of its
routes, each head's outputs and ``loss_fn``, three ``ParallelEngine`` +
``AdamW`` steps, eval logits, and the reference's quirks (the encoder's
LayerNorm eps, the deep-copied layers, attention dropout)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import ernie as je
from paddle_tpu.nn import functional as jF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.models import ernie as te
from paddle_tpu_torch.models.convert import ernie_params_from_jax
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

B, S, STEPS = 2, 128, 3
# fp32 on both sides; outputs differ only in summation order
TOL = dict(rtol=1e-5, atol=1e-6)
# the masked-LM decoder sums hidden x N(0, 1) embedding products: its
# fp32 error scales with the largest logit, not with each one
MLM_ATOL_OF_MAX = 1e-5
# three AdamW steps at lr 1e-3, held per tensor by the change they made:
# |dW_port - dW_jax| / |dW_jax| (Frobenius). Where an element's gradient
# is at the level of fp32 noise, m / sqrt(v) turns XLA's and torch's
# summation-order differences into a move of up to one step (lr) either
# way; the few such elements weigh well under 1% of a tensor's change
UPDATE_GAP = 1e-2
# the moments after three steps, per tensor as the updates: the gradients
# of the later steps differ by what the noise-level elements moved
MOMENT_GAP = 1e-2
LR = 1e-3
# parameters whose true gradient is 0: a key bias adds the same q.b to
# every logit of a softmax row, and the span head's bias the same constant
# to all S logits of its softmax. Each side's gradient is fp32 noise, which
# Adam turns into steps of up to lr in either direction, so these are held
# to that bound (three steps of at most lr, plus the weight decay) instead
# of to each other
# (the last layer's norm2.bias shifts every position's span logit by the
# same amount too)
ZERO_GRAD = {"seq_cls": ("self_attn.k_proj.bias",),
             "token_cls": ("self_attn.k_proj.bias",),
             "qa": ("self_attn.k_proj.bias", "classifier.bias",
                    "layers.1.norm2.bias"),
             "mlm": ("self_attn.k_proj.bias",)}
HEADS = ("seq_cls", "token_cls", "qa", "mlm")
# the default tiny config (4 heads of 32: SDPA takes its reference) and 2
# heads of 64 (S = 128: SDPA takes flash attention)
CONFIGS = {"D32": {}, "D64": dict(num_attention_heads=2)}


def _heads(mod):
    return {"seq_cls": mod.ErnieForSequenceClassification,
            "token_cls": mod.ErnieForTokenClassification,
            "qa": mod.ErnieForQuestionAnswering,
            "mlm": mod.ErnieForMaskedLM}


def _pair(head, cfg_kw, seed=3):
    paddle.seed(seed)
    jm = _heads(je)[head](je.ernie_tiny_config(**cfg_kw))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = te.ernie_tiny_config(**cfg_kw)
    tm = _heads(te)[head](cfg, device="cpu")
    tm.load_state_dict(ernie_params_from_jax(state, cfg, device="cpu"))
    return jm, tm


def _data(head, vocab, seed=0):
    """(ids (B, S), token types (B, S), labels) of one head, from numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    types = rng.integers(0, 4, (B, S)).astype(np.int32)
    if head == "seq_cls":
        labels = rng.integers(0, 2, (B,)).astype(np.int64)
    elif head == "token_cls":
        labels = rng.integers(0, 2, (B, S)).astype(np.int64)
    elif head == "qa":                  # start and end positions, stacked
        labels = rng.integers(0, S, (B, 2)).astype(np.int64)
    else:
        labels = np.where(rng.random((B, S)) < 0.15,
                          rng.integers(0, vocab, (B, S)), -100).astype(
                              np.int64)
    return ids, types, labels


def _loss_fn(head, model):
    """``model.loss_fn`` as the engines call it: ``loss_fn(*outputs,
    label)``; the span head's two position vectors travel as one (B, 2)
    label."""
    if head == "qa":
        return lambda s, e, lab: model.loss_fn(s, e, lab[:, 0], lab[:, 1])
    return model.loss_fn


def _np(out):
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return [np.asarray(o.value) if hasattr(o, "value") else
            o.detach().numpy() for o in outs]


# ------------------------------------------------------------------ SDPA
@pytest.mark.parametrize("D,route", [(64, "flash"), (32, "ref")])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_matches_jax_on_both_routes(monkeypatch, D, route, causal):
    """S = 128: D = 64 takes flash attention (the port's plain twins here,
    JAX's flash path on the CPU), D = 32 the reference; forward and the
    gradients of q, k and v."""
    rng = np.random.default_rng(D)
    q, k, v, g = (rng.standard_normal((2, 128, 3, D)).astype(np.float32)
                  for _ in range(4))
    routes = []
    for name in ("flash_attention_bshd", "_sdpa_ref"):
        orig = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _o=orig, _n=name, **kw:
                            routes.append(_n) or _o(*a, **kw))
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    jo = jF.scaled_dot_product_attention(jq, jk, jv, is_causal=causal)
    (jo * paddle.to_tensor(g)).sum().backward()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = tF.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    (to * torch.from_numpy(g)).sum().backward()
    assert routes == [{"flash": "flash_attention_bshd",
                       "ref": "_sdpa_ref"}[route]]
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.value),
                               **TOL)
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.value),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["short", "bool_mask", "add_mask",
                                  "dropout"])
def test_sdpa_reference_route_matches_jax(case):
    """S < 128 (the SDPA check comes before the flash path's own), masks
    and a nonzero dropout rate all take the reference, which applies the
    mask and, as in the JAX package, no dropout."""
    rng = np.random.default_rng(1)
    Sq = 64 if case == "short" else 128
    q, k, v = (rng.standard_normal((2, Sq, 2, 64)).astype(np.float32)
               for _ in range(3))
    mask = None
    if case == "bool_mask":
        mask = rng.random((2, 1, Sq, Sq)) < 0.8
    elif case == "add_mask":
        mask = (-3.0 * rng.random((2, 1, Sq, Sq))).astype(np.float32)
    p = 0.1 if case == "dropout" else 0.0
    assert not tattn._takes_flash(torch.from_numpy(q), torch.from_numpy(k),
                                  mask, p)
    jo = jF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        dropout_p=p)
    to = tF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        dropout_p=p)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.value), **TOL)


# ----------------------------------------------------------------- heads
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("head", HEADS)
def test_head_outputs_and_loss_match_jax(head, config):
    jm, tm = _pair(head, CONFIGS[config])
    ids, types, labels = _data(head, 1024)
    jout = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    tout = tm(torch.from_numpy(ids), torch.from_numpy(types))
    for t, j in zip(_np(tout), _np(jout)):
        assert t.shape == j.shape
        tol = dict(TOL, atol=MLM_ATOL_OF_MAX * np.abs(j).max()) \
            if head == "mlm" else TOL
        np.testing.assert_allclose(t, j, **tol)
    jl = _loss_fn(head, jm)(*(jout if isinstance(jout, tuple) else (jout,)),
                            paddle.to_tensor(labels))
    tl = _loss_fn(head, tm)(*(tout if isinstance(tout, tuple) else (tout,)),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)


def _adamw_kernel_arithmetic(monkeypatch):
    """The JAX engine's AdamW update with its TPU kernel's arithmetic, the
    one the port keeps (``paddle_tpu/ops/fused_adamw.py``: the scalar block
    ``[lr, 1/(1 - b1**step), 1/(1 - b2**step)]`` built in fp32, ``:245-251``,
    and multiplied in by ``_make_kernel``). The XLA fallback the engine
    takes on the CPU computes the bias corrections in float64 (the package
    enables x64), 1.3e-5 apart from fp32's at step 1."""
    import jax.numpy as jnp

    from paddle_tpu.ops import fused_adamw as jfa

    def update(param_f32, grad_f32, m, v, lr, b1, b2, eps, decay, step):
        step_f = jnp.asarray(step, jnp.float32)
        lr = jnp.asarray(lr, jnp.float32)
        inv_bc1 = 1.0 / (1.0 - jnp.asarray(b1, jnp.float32) ** step_f)
        inv_bc2 = 1.0 / (1.0 - jnp.asarray(b2, jnp.float32) ** step_f)
        master = param_f32 * (1.0 - lr * decay)
        m2 = b1 * m + (1.0 - b1) * grad_f32
        v2 = b2 * v + (1.0 - b2) * grad_f32 * grad_f32
        new_master = master - lr * (m2 * inv_bc1) / (
            jnp.sqrt(v2 * inv_bc2) + eps)
        return new_master, m2, v2

    monkeypatch.setattr(jfa, "_reference_update", update)


def _engines(head, cfg_kw):
    jm, tm = _pair(head, cfg_kw)
    jeng = JEngine(jm, optimizer=JAdamW(learning_rate=LR,
                                        parameters=jm.parameters(),
                                        weight_decay=0.01),
                   loss_fn=_loss_fn(head, jm), donate=False)
    teng = ParallelEngine(tm, optimizer=AdamW(
        learning_rate=LR, parameters=tm.named_parameters(),
        weight_decay=0.01), loss_fn=_loss_fn(head, tm))
    return jm, tm, jeng, teng


@pytest.mark.parametrize("head,config", [("seq_cls", "D64"),
                                         ("seq_cls", "D32"),
                                         ("token_cls", "D64"),
                                         ("qa", "D64"), ("mlm", "D64")])
def test_three_adamw_steps_match_jax_engine(head, config, monkeypatch):
    """Losses of every step, then the parameters and moments; the masked-LM
    head leaves the pooler out of its loss, and both engines still decay
    it and step its (zero) moments. The JAX engine updates with its AdamW
    kernel's fp32 arithmetic, as the port does."""
    _adamw_kernel_arithmetic(monkeypatch)
    _, tm, jeng, teng = _engines(head, CONFIGS[config])
    start = {n: p.detach().clone().numpy() for n, p in tm.named_parameters()}
    ids, _, labels = _data(head, 1024, seed=4)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids),
                                   torch.from_numpy(labels)).item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    assert ts["step"] == js["step"] == STEPS
    assert set(ts["params"]) == set(js["params"])
    for n, want in js["params"].items():
        got, want = ts["params"][n], np.asarray(want)
        if n.endswith(ZERO_GRAD[head]):
            for w in (got, want):
                assert np.abs(w - start[n]).max() <= \
                    STEPS * LR * (1 + 1e-3) + 1e-6, n
            continue
        moved = np.linalg.norm(want - start[n])
        if moved == 0:                  # unused and zero: decay keeps 0
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        gap = np.linalg.norm(got - want) / moved
        assert gap <= UPDATE_GAP, (n, gap)
    for n, slots in js["opt_state"].items():
        if n.endswith(ZERO_GRAD[head]):
            continue                    # moments of noise
        for key, want in slots.items():
            got, want = ts["opt_state"][n][key], np.asarray(want)
            size = np.linalg.norm(want)
            if size == 0:
                np.testing.assert_array_equal(got, want, err_msg=n)
                continue
            gap = np.linalg.norm(got - want) / size
            assert gap <= MOMENT_GAP, (n, key, gap)
    jev = float(jeng.eval_batch(paddle.to_tensor(ids),
                                paddle.to_tensor(labels)))
    tev = teng.eval_batch(torch.from_numpy(ids),
                          torch.from_numpy(labels)).item()
    np.testing.assert_allclose(tev, jev, rtol=1e-4)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_eval_logits_match_jax_with_dropout_configured(config):
    """Dropout 0.1 / 0.1 as the recipe configures it, then ``eval()``:
    neither side drops anything, and attention takes the flash path at
    D = 64 (dropout_p is 0 outside training)."""
    kw = dict(CONFIGS[config], hidden_dropout_prob=0.1,
              attention_probs_dropout_prob=0.1)
    jm, tm = _pair("seq_cls", kw)
    jm.eval()
    tm.eval()
    ids, types, _ = _data("seq_cls", 1024, seed=6)
    want = _np(jm(paddle.to_tensor(ids), paddle.to_tensor(types)))[0]
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_dropout_is_not_applied_as_in_jax():
    """Training mode with hidden dropout 0 and attention dropout 0.5: the
    JAX reference drops nothing from the attention probabilities, so the
    port's logits equal JAX's and its own eval logits (which take the
    flash route at D = 64: the same function, summed in another order)."""
    kw = dict(CONFIGS["D64"], attention_probs_dropout_prob=0.5)
    jm, tm = _pair("seq_cls", kw)
    ids, types, _ = _data("seq_cls", 1024, seed=7)
    want = _np(jm(paddle.to_tensor(ids), paddle.to_tensor(types)))[0]
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(types)).numpy()
        tm.eval()
        ev = tm(torch.from_numpy(ids), torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ev, **TOL)


# ---------------------------------------------------------------- quirks
def test_layer_norm_eps_quirk_follows_the_reference():
    """The encoder layers are built without ``layer_norm_eps``: their norms
    use 1e-5, and only the embeddings' norm (and the masked-LM head's)
    uses cfg.layer_norm_eps = 1e-12, on both sides."""
    for head in ("seq_cls", "mlm"):
        jm, tm = _pair(head, {})
        assert tm.ernie.embeddings.layer_norm._epsilon == 1e-12 == \
            jm.ernie.embeddings.layer_norm._epsilon
        for tl, jl in zip(tm.ernie.encoder.layers, jm.ernie.encoder.layers):
            for n in ("norm1", "norm2"):
                assert getattr(tl, n)._epsilon == 1e-5 == \
                    getattr(jl, n)._epsilon
        if head == "mlm":
            assert tm.lm_head.norm._epsilon == 1e-12 == \
                jm.lm_head.norm._epsilon


def test_encoder_layers_start_as_copies_of_the_first():
    """A model built from a seed starts as JAX's does: every encoder layer
    holds the first layer's weights (``TransformerEncoder`` deep-copies
    it), on both sides; the seed fixes the port's draws."""
    paddle.seed(0)
    jm = je.ErnieForSequenceClassification(je.ernie_tiny_config(
        num_hidden_layers=3))
    cfg = te.ernie_tiny_config(num_hidden_layers=3)
    a = te.ErnieForSequenceClassification(cfg, device="cpu", seed=5)
    b = te.ErnieForSequenceClassification(cfg, device="cpu", seed=5)
    for m in (a, jm):
        layers = m.ernie.encoder.layers
        for lay in layers[1:]:
            for (n, p), (_, p0) in zip(lay.named_parameters(),
                                       layers[0].named_parameters()):
                v, v0 = (np.asarray(getattr(t, "value", t).detach()
                                    if isinstance(t, torch.Tensor)
                                    else t.value) for t in (p, p0))
                np.testing.assert_array_equal(v, v0, err_msg=n)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


def test_dropout_draws_from_the_model_generator():
    """Training-mode dropout keeps about 1 - p of the elements, scales them
    by 1 / (1 - p), repeats under the same seed and differs from layer to
    layer (the deep-copied layers share the model's generator, not copies
    of it)."""
    cfg = te.ernie_tiny_config(hidden_dropout_prob=0.25)
    ids = torch.from_numpy(_data("seq_cls", 1024)[0])

    def run(seed):
        m = te.ErnieForSequenceClassification(cfg, device="cpu", seed=seed)
        m.train()
        return m(ids)

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    x = torch.ones(64, 1024)
    m = te.ErnieForSequenceClassification(cfg, device="cpu", seed=1)
    m.train()
    d1 = m.ernie.encoder.layers[0].dropout1
    d2 = m.ernie.encoder.layers[1].dropout1
    assert d1.generator is d2.generator is m.generator
    y1, y2 = d1(x), d2(x)
    kept = (y1 != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert set(y1.unique().tolist()) == {0.0, (x[0, 0] / 0.75).item()}
    assert not torch.equal(y1, y2)
    m.eval()
    assert torch.equal(d1(x), x)


@pytest.mark.parametrize("call", ["mha_cache", "encoder_cache",
                                  "gen_cache", "decoder"])
def test_unported_transformer_forms_raise(call):
    from paddle_tpu_torch.nn import layer as L

    m = te.ErnieForSequenceClassification(te.ernie_tiny_config(),
                                          device="cpu")
    x = torch.zeros(1, 8, 128)
    with pytest.raises(NotImplementedError):
        if call == "mha_cache":
            m.ernie.encoder.layers[0].self_attn(x, cache=object())
        elif call == "encoder_cache":
            m.ernie.encoder(x, cache=[object()])
        elif call == "gen_cache":
            m.ernie.encoder.gen_cache(x)
        else:
            L.TransformerDecoderLayer(128, 4, 512)


def test_conversion_refuses_missing_extra_and_misshaped_keys():
    jm, _ = _pair("seq_cls", {})
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = te.ernie_tiny_config()
    bad = dict(state)
    del bad["ernie.pooler.bias"]
    with pytest.raises(KeyError, match="missing"):
        ernie_params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        ernie_params_from_jax({**state, "extra.weight": np.zeros(1)}, cfg,
                              device="cpu")
    bad = {**state, "ernie.pooler.bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        ernie_params_from_jax(bad, cfg, device="cpu")
