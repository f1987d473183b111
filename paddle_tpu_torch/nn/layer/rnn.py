"""Recurrent layers — port of ``paddle_tpu/nn/layer/rnn.py``: the cells
(``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``), ``RNN`` and ``BiRNN``
over a cell, and ``SimpleRNN`` / ``LSTM`` / ``GRU``.

The recurrence is the JAX package's Python loop over the time steps, one
cell step each: a few device ops with no host read, so the train engine
captures the whole loop in its CUDA graph. The weights keep the JAX
package's layout (``weight_ih`` (gates · hidden, in), ``weight_hh``
(gates · hidden, hidden), biases (gates · hidden), gate order i, f, g, o
for the LSTM and r, z, n for the GRU, which applies r to ``W_hh h +
b_hh`` as ``torch.nn.GRU`` does) and its submodule names (``rnns.<i>.
rnn_fw.cell.weight_ih`` / ``rnn_bw``, ``rnns.<i>.cell.*`` in one
direction), so its state dict loads name for name
(``models/convert.layer_params_from_jax``), and its initial draw:
``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))`` for weights and biases.

Kept from the JAX package, and visible: ``RNN``, ``BiRNN`` and the
layers take ``sequence_length`` and ignore it (every row runs all the
steps); ``SimpleRNN(activation=...)`` builds tanh cells whatever it says
(a ``SimpleRNNCell`` honours its own ``activation``); the inter-layer
dropout is ``F.dropout`` in training. Each constructor takes ``device``
(``place`` its alias; None: the CUDA card), ``dtype`` and ``generator``
(the ``torch.Generator`` the weights draw from)."""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from ..layer_base import Layer
from .container import LayerList


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Zeros (or ``init_value``) of (B, *state) for each state, B from
        ``batch_ref``'s axis ``batch_dim_idx``, on its device, in
        ``dtype`` (None: batch_ref's floating dtype, else fp32; the JAX
        package's fp32 promotes against a bf16 input, torch's products
        refuse the mix)."""
        B = batch_ref.shape[batch_dim_idx]
        if dtype is None:
            dtype = batch_ref.dtype if batch_ref.is_floating_point() \
                else torch.float32
        from ...framework.dtype import convert_dtype

        dtype = convert_dtype(dtype)

        def full(s):
            return torch.full([B] + list(s), init_value, dtype=dtype,
                              device=batch_ref.device)

        shape = self.state_shape if shape is None else shape
        if isinstance(shape[0], (list, tuple)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def _params(self, gates, input_size, hidden_size, weight_ih_attr,
                weight_hh_attr, bias_ih_attr, bias_hh_attr):
        k = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-k, k)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=init)
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter([gates * hidden_size], bias_ih_attr,
                                  is_bias=True, default_initializer=init)
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter([gates * hidden_size], bias_hh_attr,
                                  is_bias=True, default_initializer=init)

    def _gates(self, x, h):
        """(x W_ih^T + b_ih, h W_hh^T + b_hh)."""
        gi = x @ self.weight_ih.T
        gh = h @ self.weight_hh.T
        if self.bias_ih is not None:
            gi = gi + self.bias_ih
        if self.bias_hh is not None:
            gh = gh + self.bias_hh
        return gi, gh


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._params(1, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, states)
        z = gi + gh
        h = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return h, h


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o of ``x W_ih^T + b_ih + h W_hh^T + b_hh``:
    ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' = σ(o)·tanh(c')``; states
    (h, c)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._params(4, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gi, gh = self._gates(inputs, h)
        i, f, g, o = (gi + gh).chunk(4, -1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    """Gates r, z, n: ``r = σ(x_r + h_r)``, ``z = σ(x_z + h_z)``, ``n =
    tanh(x_n + r·h_n)`` (h_n includes b_hh), ``h' = (1 - z)·n + z·h``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._params(3, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, states)
        ir, iz, ig = gi.chunk(3, -1)
        hr, hz, hg = gh.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        g = torch.tanh(ig + r * hg)
        h = (1 - z) * g + z * states
        return h, h


class RNN(Layer):
    """A cell run over the time axis (1, or 0 with ``time_major``),
    backwards with ``is_reverse`` (the outputs in time order); returns
    (outputs stacked on the time axis, the final states).
    ``sequence_length`` is ignored, as in the JAX package."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        states = initial_states
        outs = []
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, states = self.cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, time_axis), states


class BiRNN(Layer):
    """``rnn_fw`` and ``rnn_bw`` (reversed) over the same inputs, outputs
    concatenated on the last axis; states (fw, bw)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            fw_states = bw_states = None
        else:
            fw_states, bw_states = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, fw_states, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw_states, sequence_length)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, **kw):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        self.num_directions = bidirect
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def make_cell(isize):
            if mode == "LSTM":
                return LSTMCell(isize, hidden_size, *attrs, **kw)
            if mode == "GRU":
                return GRUCell(isize, hidden_size, *attrs, **kw)
            return SimpleRNNCell(isize, hidden_size, "tanh", *attrs, **kw)

        self.rnns = LayerList()
        for i in range(num_layers):
            isize = input_size if i == 0 else hidden_size * bidirect
            if bidirect == 2:
                self.rnns.append(BiRNN(make_cell(isize), make_cell(isize),
                                       time_major))
            else:
                self.rnns.append(RNN(make_cell(isize), False, time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """(outputs, final states): h (layers · directions, B, H), and c
        beside it for the LSTM."""
        out = inputs
        final_states = []
        for i, rnn in enumerate(self.rnns):
            init = None if initial_states is None else \
                self._slice_states(initial_states, i)
            out, st = rnn(out, init, sequence_length)
            final_states.append(st)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        return out, self._merge_states(final_states)

    def _slice_states(self, initial_states, i):
        d = self.num_directions
        if self.mode == "LSTM":
            h, c = initial_states
            if d == 1:
                return h[i], c[i]
            return (h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1])
        h = initial_states
        if d == 1:
            return h[i]
        return h[2 * i], h[2 * i + 1]

    def _merge_states(self, final_states):
        d = self.num_directions
        if self.mode == "LSTM":
            hs, cs = [], []
            for st in final_states:
                if d == 1:
                    hs.append(st[0])
                    cs.append(st[1])
                else:
                    (h_f, c_f), (h_b, c_b) = st
                    hs += [h_f, h_b]
                    cs += [c_f, c_b]
            return torch.stack(hs), torch.stack(cs)
        hs = []
        for st in final_states:
            hs += [st] if d == 1 else [st[0], st[1]]
        return torch.stack(hs)


class SimpleRNN(_RNNBase):
    """Tanh cells whatever ``activation`` says (the JAX package's)."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
