"""The recurrent layers (port of ``paddle_tpu/nn/layers/rnn.py``): the
cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the wrappers ``RNN``
and ``BiRNN``, and the stacks ``SimpleRNN``, ``LSTM`` and ``GRU``
(``num_layers``, ``direction`` ``forward``/``backward``/``bidirect``,
``time_major``, dropout between layers).

The reference scans a cell with ``lax.scan``; the port loops over time in
Python with the cell's own math, so every step is the cell's matmuls and
gates and nothing else. The gates and layouts are the reference's, so that
weights carry 1:1: ``weight_ih`` (G * H, in) and ``weight_hh`` (G * H, H),
used as ``x @ W.T``, with two biases; LSTM gates in the order i, f, g, o
(``c = f * c + i * g``, ``h = o * tanh(c)``); GRU gates r, z, c with the
reset applied to the hidden half (``c = tanh(x_c + r * h_c)``, ``h = (1 -
z) * c + z * h``). Not ``torch.nn.LSTM``/cuDNN, whose gate order and bias
layout differ. ``sequence_length`` is accepted and unused, as in the
reference: padded steps run like the others.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from ..layer import Layer
from .container import LayerList

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Zeros (or ``init_value``) of ``(batch,) + shape`` for each state,
        in the cell's parameter dtype, on ``batch_ref``'s device."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        kw = dict(dtype=dtype or self.weight_ih.dtype,
                  device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(torch.full((batch,) + tuple(s), init_value, **kw)
                         for s in shape)
        return torch.full((batch,) + tuple(shape), init_value, **kw)

    def _params(self, gates, input_size, hidden_size, weight_ih_attr,
                weight_hh_attr, bias_ih_attr, bias_hh_attr):
        std = 1.0 / math.sqrt(hidden_size)
        u = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            (gates * hidden_size, input_size), attr=weight_ih_attr,
            initializer=u)
        self.weight_hh = self.create_parameter(
            (gates * hidden_size, hidden_size), attr=weight_hh_attr,
            initializer=u)
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter((gates * hidden_size,), attr=bias_ih_attr,
                                  is_bias=True, initializer=u)
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter((gates * hidden_size,), attr=bias_hh_attr,
                                  is_bias=True, initializer=u)

    def _proj(self, x, weight, bias):
        y = x @ weight.T
        return y if bias is None else y + bias


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._params(1, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        h = self.get_initial_states(inputs) if states is None else states
        z = inputs @ self.weight_ih.T + h @ self.weight_hh.T
        if self.bias_ih is not None:
            z = z + self.bias_ih
        if self.bias_hh is not None:
            z = z + self.bias_hh
        act = torch.tanh if self.activation == "tanh" else \
            getattr(F, self.activation)
        h = act(z)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._params(4, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gates = inputs @ self.weight_ih.T + h @ self.weight_hh.T
        if self.bias_ih is not None:
            gates = gates + self.bias_ih
        if self.bias_hh is not None:
            gates = gates + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._params(3, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        h = self.get_initial_states(inputs) if states is None else states
        x_r, x_z, x_c = self._proj(inputs, self.weight_ih,
                                   self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_c = self._proj(h, self.weight_hh,
                                   self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h = (1.0 - z) * c + z * h
        return h, h


def _run_cell(cell, inputs, states, time_major, reverse=False):
    """The cell over the time axis -> (outputs, final states)."""
    xs = inputs if time_major else inputs.transpose(0, 1)
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else \
        range(xs.shape[0])
    outs = [None] * xs.shape[0]
    for t in steps:
        outs[t], states = cell(xs[t], states)
    out = torch.stack(outs)
    return (out if time_major else out.transpose(0, 1)), states


class RNN(Layer):
    """A cell run over a sequence (``is_reverse``: last step first)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        return _run_cell(self.cell, inputs, initial_states, self.time_major,
                         self.is_reverse)


class BiRNN(Layer):
    """A forward and a reversed cell; outputs concatenated on the last
    axis, final states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            idx = 1 if self.time_major else 0
            initial_states = (
                self.cell_fw.get_initial_states(inputs, batch_dim_idx=idx),
                self.cell_bw.get_initial_states(inputs, batch_dim_idx=idx))
        out_fw, fin_fw = _run_cell(self.cell_fw, inputs, initial_states[0],
                                   self.time_major)
        out_bw, fin_bw = _run_cell(self.cell_bw, inputs, initial_states[1],
                                   self.time_major, reverse=True)
        return torch.cat([out_fw, out_bw], dim=-1), (fin_fw, fin_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, **cell_kw):
        super().__init__()
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.direction = direction
        cell_cls = {"LSTM": LSTMCell, "GRU": GRUCell}.get(mode,
                                                          SimpleRNNCell)

        def make_cell(isz):
            return cell_cls(isz, hidden_size, weight_ih_attr=weight_ih_attr,
                            weight_hh_attr=weight_hh_attr,
                            bias_ih_attr=bias_ih_attr,
                            bias_hh_attr=bias_hh_attr, **cell_kw)

        rnns = []
        for i in range(num_layers):
            isz = input_size if i == 0 else hidden_size * self.num_directions
            if bidirect:
                rnns.append(BiRNN(make_cell(isz), make_cell(isz), time_major))
            else:
                rnns.append(RNN(make_cell(isz),
                                is_reverse=(direction == "backward"),
                                time_major=time_major))
        self.rnns = LayerList(rnns)

    @property
    def state_components(self):
        return 2 if self.mode == "LSTM" else 1

    def _layer_init(self, initial_states, i):
        if initial_states is None:
            return None
        lstm = self.mode == "LSTM"
        parts = initial_states if lstm else (initial_states,)
        if self.num_directions == 2:
            fw = tuple(p[2 * i] for p in parts)
            bw = tuple(p[2 * i + 1] for p in parts)
            return (fw, bw) if lstm else (fw[0], bw[0])
        own = tuple(p[i] for p in parts)
        return own if lstm else own[0]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """-> (outputs, finals): finals stacked (num_layers *
        num_directions, B, H), an ``(h, c)`` pair for the LSTM."""
        out = inputs
        finals = []
        for i, layer in enumerate(self.rnns):
            out, fin = layer(out, self._layer_init(initial_states, i))
            finals.extend(fin if self.num_directions == 2 else [fin])
            if self.dropout > 0.0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        if self.mode == "LSTM":
            return out, (torch.stack([f[0] for f in finals]),
                         torch.stack([f[1] for f in finals]))
        return out, torch.stack(finals)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout,
                         activation=activation, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
