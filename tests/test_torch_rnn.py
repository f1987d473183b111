"""The recurrent layers of the PyTorch port (``paddle_tpu_torch/nn/layer/
rnn.py``, ``dynamic_decode`` in ``nn/layer/extras.py``) against the JAX
package on the CPU, fp32, the port's weights carried to the JAX layers
name for name: the three cells, ``RNN`` / ``BiRNN`` and ``SimpleRNN`` /
``LSTM`` / ``GRU`` in one and two directions, batch-major and
``time_major``, with and without initial states, two layers (inter-layer
dropout off). Each compares the outputs, the final states and the
gradients of the inputs and every weight.

The JAX package's quirks show here too: ``SimpleRNN(activation="relu")``
builds tanh cells, and ``sequence_length`` is taken and ignored.

Tolerance: fp32 in another summation order through T = 5 steps, rtol
1e-5 / atol 1e-6 on outputs and states, rtol 1e-4 / atol 1e-5 on the
gradients (summed over the steps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from torch_tensor_parity import (F32, assert_same, jax_compiled,
                                 jax_host_init, jax_values)

GRAD = dict(rtol=1e-4, atol=1e-5)
B, T, IN, H = 2, 5, 4, 3
R = np.random.RandomState(3)
X = R.randn(B, T, IN).astype("float32")


def _pair(name, *args, **kw):
    """The port's layer on the CPU and the JAX one holding its weights."""
    torch.manual_seed(7)
    tl = getattr(tnn, name)(*args, device="cpu", **kw)
    with jax_host_init():
        jl = getattr(jnn, name)(*args, **kw)
    state = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
    missing, unexpected = jl.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return jl, tl


def _state_arg(states, wrap):
    if states is None:
        return None
    states = [wrap(s) for s in states]
    return states[0] if len(states) == 1 else tuple(states)


def _jax_run(jl, x, states):
    """The JAX layer's outputs on x (and the initial states), and the
    gradients of every parameter, x and the states for the sum of every
    output's square, compiled (``jax_compiled``: eagerly each op of the
    unrolled steps compiles per shape)."""
    from paddle_tpu.jit import functional_call

    def total(params, x, states):
        out = jax_values(functional_call(
            jl, params, paddle.Tensor(x), _state_arg(states, paddle.Tensor)))
        return sum(jnp.sum(o * o) for o in jax.tree_util.tree_leaves(out)), \
            out

    def run(params, x, states):
        (_, out), grads = jax.value_and_grad(
            total, argnums=(0, 1, 2), has_aux=True)(params, x, states)
        return out, grads

    params = {n: p.value for n, p in jl.named_parameters()}
    return jax_compiled(run, params, x, states)


def _run(jl, tl, x, states=None):
    """Both layers on x (and the initial states); the outputs, and the
    gradients of x, the states and every parameter for the sum of every
    output's square."""
    tx = torch.tensor(x, requires_grad=True)
    ts = None if states is None else [torch.tensor(s, requires_grad=True)
                                      for s in states]
    jo, (jp, jxg, jsg) = _jax_run(jl, x, states)
    to = tl(tx, _state_arg(ts, lambda t: t))
    assert_same(jo, to, F32, None, type(tl).__name__)

    def total(out):
        if isinstance(out, (list, tuple)):
            return sum((total(o) for o in out), 0)
        return torch.sum(out * out)

    total(to).backward()
    np.testing.assert_allclose(tx.grad.numpy(), jxg, **GRAD)
    for a, b in zip(jsg or [], ts or []):
        np.testing.assert_allclose(b.grad.numpy(), a, **GRAD)
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n], **GRAD,
                                   err_msg=n)


@pytest.mark.parametrize("name,kw,states", [
    ("SimpleRNNCell", {}, None),
    ("SimpleRNNCell", dict(activation="relu"), [(B, H)]),
    ("LSTMCell", {}, [(B, H), (B, H)]),
    ("GRUCell", {}, None),
], ids=["rnn", "rnn_relu_state", "lstm_state", "gru"])
def test_cells_match_jax(name, kw, states):
    jl, tl = _pair(name, IN, H, **kw)
    x = X[:, 0]
    st = None if states is None else [R.randn(*s).astype("float32")
                                      for s in states]
    _run(jl, tl, x, st)


@pytest.mark.parametrize("name,direction,time_major,states", [
    ("LSTM", "forward", False, None),
    ("LSTM", "bidirect", False, "init"),
    ("LSTM", "bidirectional", True, None),
    ("GRU", "forward", True, "init"),
    ("GRU", "bidirect", False, None),
    ("SimpleRNN", "forward", False, "init"),
    ("SimpleRNN", "bidirect", True, None),
], ids=lambda v: str(v))
def test_layers_match_jax(name, direction, time_major, states):
    """Two layers: outputs, final states (h, and c for the LSTM) and
    every gradient."""
    jl, tl = _pair(name, IN, H, num_layers=2, direction=direction,
                   time_major=time_major)
    d = 2 if direction != "forward" else 1
    x = np.ascontiguousarray(X.transpose(1, 0, 2)) if time_major else X
    st = None
    if states:
        n = 2 if name == "LSTM" else 1
        st = [R.randn(2 * d, B, H).astype("float32") for _ in range(n)]
    _run(jl, tl, x, st)
    assert tuple(tl.state_dict()["rnns.0." + (
        "rnn_fw.cell.weight_ih" if d == 2 else "cell.weight_ih")].shape) \
        == ({"LSTM": 4, "GRU": 3, "SimpleRNN": 1}[name] * H, IN)


def test_rnn_and_birnn_over_cells_match_jax():
    jc, tc = _pair("GRUCell", IN, H)
    _run(jnn.RNN(jc, is_reverse=True), tnn.RNN(tc, is_reverse=True), X)
    jf, tf = _pair("LSTMCell", IN, H)
    jb, tb = _pair("LSTMCell", IN, H)
    _run(jnn.BiRNN(jf, jb), tnn.BiRNN(tf, tb), X)


def test_quirks_kept_from_jax():
    """``SimpleRNN(activation="relu")`` runs tanh cells (its outputs lie
    in (-1, 1) and equal the tanh layer's); ``sequence_length`` changes
    nothing (every row runs all the steps), in both packages."""
    jl, tl = _pair("SimpleRNN", IN, H, activation="relu")
    assert all(c.activation == "tanh" for c in tl.sublayers()
               if isinstance(c, tnn.SimpleRNNCell))
    x = 5 * X
    out, _ = tl(torch.from_numpy(x))
    assert out.abs().max() < 1
    lens = np.array([2, 5], "int64")
    jo = jl(paddle.to_tensor(x), None, paddle.to_tensor(lens))
    to = tl(torch.from_numpy(x), None, torch.from_numpy(lens))
    assert_same(jo, to, F32, None, "sequence_length")
    np.testing.assert_array_equal(to[0].detach().numpy(),
                                  out.detach().numpy())


def test_dynamic_decode_matches_jax():
    """Greedy decoding through a GRU cell, an embedding and an output
    layer, carried across: the same tokens and lengths (host-driven, the
    argmax read each step), whatever ``beam_size`` says."""
    V, E = 7, 4
    torch.manual_seed(1)
    temb = tnn.Embedding(V, E, device="cpu")
    tcell = tnn.GRUCell(E, H, device="cpu")
    tout = tnn.Linear(H, V, device="cpu")
    with jax_host_init():
        jemb, jcell, jout = jnn.Embedding(V, E), jnn.GRUCell(E, H), \
            jnn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jout, tout)):
        j.set_state_dict({k: v.detach().numpy()
                          for k, v in t.state_dict().items()})
    h0 = R.randn(3, H).astype("float32")
    out = {}
    for pkg, nn_, emb, cell, lin, h in (
            ("jax", jnn, jemb, jcell, jout, paddle.to_tensor(h0)),
            ("torch", tnn, temb, tcell, tout, torch.from_numpy(h0))):
        dec = nn_.BeamSearchDecoder(cell, start_token=0, end_token=V - 1,
                                    beam_size=4, embedding_fn=emb,
                                    output_fn=lin)
        out[pkg] = nn_.dynamic_decode(dec, inits=h, max_step_num=6)
    assert_same(out["jax"], out["torch"], F32, None, "dynamic_decode")
