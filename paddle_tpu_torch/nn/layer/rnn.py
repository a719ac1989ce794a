"""Recurrent cells and layers (``paddle_tpu/nn/layer/rnn.py``):
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, the ``RNN`` / ``BiRNN``
wrappers and ``SimpleRNN`` / ``LSTM`` / ``GRU``, with Paddle's parameter
names (``weight_ih_l0``, ``bias_hh_l1_reverse``, ...), so a JAX layer's
``state_dict`` carries across by ``set_state_dict``.

Each step is composed as the JAX package composes it: the LSTM's gates
``x·W_ihᵀ + b_ih + h·W_hhᵀ + b_hh`` split in the order i, f, g, o; the
GRU's ``(h − c)·z + c``; the simple cell's tanh or relu. Where the JAX
package runs ``lax.scan``, the layers run a Python loop over time with no
host read in it (a captured training step replays it), the input
projection of every step made first in one product.

``sequence_length`` is honoured, as the reference's cuDNN ``rnn`` op
honours it (the JAX package builds the mask and drops it): a row's state
stops moving after its own last valid step, so the final state is the
one at that step and the reverse direction starts at the row's own end;
the outputs at padded steps are 0.
"""
from __future__ import annotations

import math

import torch

from ...framework.core import Tensor, _unwrap, apply_op
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _uniform_std(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-std, std)


def _zeros_like_batch(ref, hidden_size):
    """A [batch, hidden] zero state on ``ref``'s device, in its float
    dtype."""
    d = _unwrap(ref)
    return Tensor(torch.zeros((d.shape[0], hidden_size), dtype=d.dtype,
                              device=d.device))


def _simple_rnn_step(x, h, wih, whh, bih, bhh, act="tanh", xg=None):
    z = (x @ wih.T + bih if xg is None else xg) + h @ whh.T + bhh
    return torch.tanh(z) if act == "tanh" else torch.relu(z)


def _lstm_step(x, h, c, wih, whh, bih, bhh, xg=None):
    gates = (x @ wih.T + bih if xg is None else xg) + h @ whh.T + bhh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    nc = f * c + i * torch.tanh(g)
    nh = o * torch.tanh(nc)
    return nh, nc


def _gru_step(x, h, wih, whh, bih, bhh, xg=None):
    xg = x @ wih.T + bih if xg is None else xg
    hg = h @ whh.T + bhh
    x_r, x_z, x_c = xg.chunk(3, dim=-1)
    h_r, h_z, h_c = hg.chunk(3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    c = torch.tanh(x_c + r * h_c)
    return (h - c) * z + c


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """A [batch, hidden] tensor of ``init_value`` on ``batch_ref``'s
        device (the JAX package's: one tensor whatever the cell's state
        structure)."""
        from ...framework import dtype as dtypes

        d = _unwrap(batch_ref)
        if shape is None:
            shape = (self.hidden_size,)
        dt = dtypes.convert_dtype(dtype) or dtypes.default_float_dtype()
        return Tensor(torch.full(
            (d.shape[batch_dim_idx],) + tuple(shape)[-1:], init_value,
            dtype=dt, device=d.device))


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh or relu, got "
                             f"{activation!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, 1, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_like_batch(inputs, self.hidden_size)
        h = apply_op(_simple_rnn_step, inputs, states, self.weight_ih,
                     self.weight_hh, self.bias_ih, self.bias_hh,
                     act=self.activation)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _cell_params(cell, k, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
    init = _uniform_std(hidden_size)
    cell.weight_ih = cell.create_parameter(
        [k * hidden_size, input_size], weight_ih_attr,
        default_initializer=init)
    cell.weight_hh = cell.create_parameter(
        [k * hidden_size, hidden_size], weight_hh_attr,
        default_initializer=init)
    cell.bias_ih = cell.create_parameter(
        [k * hidden_size], bias_ih_attr, is_bias=True,
        default_initializer=init)
    cell.bias_hh = cell.create_parameter(
        [k * hidden_size], bias_hh_attr, is_bias=True,
        default_initializer=init)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _cell_params(self, 4, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = (_zeros_like_batch(inputs, self.hidden_size),
                      _zeros_like_batch(inputs, self.hidden_size))
        h, c = states
        nh, nc = apply_op(_lstm_step, inputs, h, c, self.weight_ih,
                          self.weight_hh, self.bias_ih, self.bias_hh)
        return nh, (nh, nc)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _cell_params(self, 3, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_like_batch(inputs, self.hidden_size)
        h = apply_op(_gru_step, inputs, states, self.weight_ih,
                     self.weight_hh, self.bias_ih, self.bias_hh)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


# --------------------------------------------------------------------------
# one direction of one layer over the whole sequence
# --------------------------------------------------------------------------

def _run_layer(x, state, wih, whh, bih, bhh, mode, time_major, reverse,
               mask=None):
    """x [T, B, I] (or [B, T, I]); state a tensor, or (h, c) for the
    LSTM. Returns (outputs like x with H features, final state). ``mask``
    [T, B] bool (time-major) freezes a row's state at padded steps and
    zeroes its outputs there."""
    if not time_major:
        x = x.transpose(0, 1)
    T = x.shape[0]
    # every step's input projection in one product (the step adds the
    # recurrent term to it, in the JAX step's order)
    xg = (x.reshape(-1, x.shape[-1]) @ wih.T + bih).reshape(
        T, x.shape[1], -1)
    keep = None if mask is None else mask.unsqueeze(-1)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "LSTM":
            new = _lstm_step(None, state[0], state[1], wih, whh, bih, bhh,
                             xg=xg[t])
        elif mode == "GRU":
            new = _gru_step(None, state, wih, whh, bih, bhh, xg=xg[t])
        else:
            new = _simple_rnn_step(None, state, wih, whh, bih, bhh,
                                   act="tanh" if mode == "RNN_TANH"
                                   else "relu", xg=xg[t])
        if keep is not None:
            m = keep[t]
            if mode == "LSTM":
                new = (torch.where(m, new[0], state[0]),
                       torch.where(m, new[1], state[1]))
            else:
                new = torch.where(m, new, state)
        state = new
        out = state[0] if mode == "LSTM" else state
        outs[t] = out if keep is None else out * keep[t].to(out.dtype)
    outs = torch.stack(outs, 0)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, state


def _layer_lstm(x, h0, c0, wih, whh, bih, bhh, mask=None, time_major=False,
                reverse=False):
    outs, (h, c) = _run_layer(x, (h0, c0), wih, whh, bih, bhh, "LSTM",
                              time_major, reverse, mask)
    return outs, h, c


def _layer_single(x, h0, wih, whh, bih, bhh, mask=None, mode="GRU",
                  time_major=False, reverse=False):
    return _run_layer(x, h0, wih, whh, bih, bhh, mode, time_major, reverse,
                      mask)


def _step_mask(sequence_length, T, device):
    """[T, B] bool: step t of row b is valid (time-major)."""
    sl = _unwrap(sequence_length)
    if not isinstance(sl, torch.Tensor):
        sl = torch.as_tensor(sl)
    sl = sl.to(device)
    return torch.arange(T, device=device)[:, None] < sl.reshape(1, -1)


def _cell_mode(cell):
    if isinstance(cell, LSTMCell):
        return "LSTM"
    if isinstance(cell, GRUCell):
        return "GRU"
    if isinstance(cell, SimpleRNNCell):
        return "RNN_TANH" if cell.activation == "tanh" else "RNN_RELU"
    return None


class RNN(Layer):
    """Runs a cell over a sequence (the reference's ``RNN``). The three
    built-in cells run as one layer of their ``LSTM`` / ``GRU`` /
    ``SimpleRNN``; any other cell (``cell(x_t, states, **kwargs)`` →
    (output, new states)) is stepped in a Python loop, its states any
    nesting of tuples, lists and dicts of Tensors."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        mode = _cell_mode(self.cell)
        if mode is None:
            return self._custom(inputs, initial_states, sequence_length,
                                **kwargs)
        if kwargs:
            raise TypeError(f"RNN over a {type(self.cell).__name__} takes "
                            f"no extra arguments, got {sorted(kwargs)}")
        xd = _unwrap(inputs)
        T = xd.shape[0 if self.time_major else 1]
        batch = xd.shape[1 if self.time_major else 0]
        hidden = self.cell.hidden_size
        if initial_states is None:
            z = Tensor(torch.zeros((batch, hidden), dtype=xd.dtype,
                                   device=xd.device))
            initial_states = (z, z) if mode == "LSTM" else z
        mask = (None if sequence_length is None
                else _step_mask(sequence_length, T, xd.device))
        c = self.cell
        weights = (c.weight_ih, c.weight_hh, c.bias_ih, c.bias_hh)
        if mode == "LSTM":
            outs, h, cc = apply_op(
                _layer_lstm, inputs, initial_states[0], initial_states[1],
                *weights, mask=mask, time_major=self.time_major,
                reverse=self.is_reverse)
            return outs, (h, cc)
        outs, h = apply_op(_layer_single, inputs, initial_states, *weights,
                           mask=mask, mode=mode, time_major=self.time_major,
                           reverse=self.is_reverse)
        return outs, h

    def _custom(self, inputs, states, sequence_length, **kwargs):
        from ...tensor import stack

        xd = _unwrap(inputs)
        T = xd.shape[0 if self.time_major else 1]
        if states is None:
            states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        mask = (None if sequence_length is None
                else _step_mask(sequence_length, T, xd.device))
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, new = self.cell(x_t, states, **kwargs)
            if mask is not None:
                m = mask[t].unsqueeze(-1)
                new = _tree_map2(lambda n, s: Tensor._wrap(torch.where(
                    m, n._data, s._data)), new, states)
                out = Tensor._wrap(out._data * m.to(out.dtype))
            states = new
            outs[t] = out
        return stack(outs, 0 if self.time_major else 1), states


def _tree_map2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        from ...tensor import concat

        s_fw, s_bw = (None, None) if initial_states is None \
            else initial_states
        o_fw, f_fw = self.rnn_fw(inputs, s_fw, sequence_length, **kwargs)
        o_bw, f_bw = self.rnn_bw(inputs, s_bw, sequence_length, **kwargs)
        return concat([o_fw, o_bw], axis=-1), (f_fw, f_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        if direction == "forward":
            self.num_directions = 1
        elif direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            raise ValueError(f"unknown direction {direction}")
        k = {"LSTM": 4, "GRU": 3}.get(mode, 1)
        init = _uniform_std(hidden_size)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                sfx = f"{layer}" + ("_reverse" if d else "")
                ws = (
                    self.create_parameter([k * hidden_size, in_size],
                                          weight_ih_attr,
                                          default_initializer=init),
                    self.create_parameter([k * hidden_size, hidden_size],
                                          weight_hh_attr,
                                          default_initializer=init),
                    self.create_parameter([k * hidden_size], bias_ih_attr,
                                          is_bias=True,
                                          default_initializer=init),
                    self.create_parameter([k * hidden_size], bias_hh_attr,
                                          is_bias=True,
                                          default_initializer=init))
                for nm, w in zip(("weight_ih", "weight_hh", "bias_ih",
                                  "bias_hh"), ws):
                    self.add_parameter(f"{nm}_l{sfx}", w)
                self._all_weights.append(ws)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor import concat, stack

        D, L = self.num_directions, self.num_layers
        xd = _unwrap(inputs)
        T = xd.shape[0 if self.time_major else 1]
        batch = xd.shape[1 if self.time_major else 0]
        is_lstm = self.mode == "LSTM"
        if initial_states is None:
            z = Tensor(torch.zeros((L * D, batch, self.hidden_size),
                                   dtype=xd.dtype, device=xd.device))
            initial_states = (z, z) if is_lstm else z
        mask = (None if sequence_length is None
                else _step_mask(sequence_length, T, xd.device))
        x = inputs
        final_h, final_c = [], []
        for layer in range(L):
            outs_dir = []
            for d in range(D):
                idx = layer * D + d
                ws = self._all_weights[idx]
                if is_lstm:
                    outs, h, c = apply_op(
                        _layer_lstm, x, initial_states[0][idx],
                        initial_states[1][idx], *ws, mask=mask,
                        time_major=self.time_major, reverse=bool(d))
                    final_c.append(c)
                else:
                    outs, h = apply_op(
                        _layer_single, x, initial_states[idx], *ws,
                        mask=mask, mode=self.mode,
                        time_major=self.time_major, reverse=bool(d))
                final_h.append(h)
                outs_dir.append(outs)
            x = outs_dir[0] if D == 1 else concat(outs_dir, axis=-1)
            if self.dropout and layer < L - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if is_lstm:
            return x, (stack(final_h, 0), stack(final_c, 0))
        return x, stack(final_h, 0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh or relu, got "
                             f"{activation!r}")
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
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
