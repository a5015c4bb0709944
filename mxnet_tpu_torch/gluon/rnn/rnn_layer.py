"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU`` (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): multi-layer, optionally
bidirectional, the whole sequence in one call of the fused ``RNN`` op
(``ops.nn.fused_rnn``) through ``ndarray.apply_fn``, its parameters
packed into the op's flat vector in the call, so each Parameter gets its
gradient.

The parameters are the reference's, in its order: per layer and
direction (``l``, then ``r``) ``i2h_weight`` (gates * hidden, input),
``h2h_weight`` (gates * hidden, hidden), ``i2h_bias`` and ``h2h_bias``,
gates in the order i, f, g, o (LSTM) and r, z, n (GRU).  Dropout
``dropout`` applies between layers in train mode, drawn from the port's
generator of the device (the reference draws from its own keys: a seed
fixes the masks of each package, not the same masks in both).
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray.ndarray import apply_fn
from ...ops.nn import fused_rnn
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, gates,
                 activation=None, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = gates
        self._activation = activation
        ng, ni, nh = gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                for name, shape, init in (
                        ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                        ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                    setattr(self, f"{j}{i}_{name}", self.params.get(
                        f"{j}{i}_{name}", shape=shape, init=init,
                        allow_deferred_init=True))
            ni = nh * self._dir

    @property
    def _num_states(self):
        return 2 if self._mode == "lstm" else 1

    @property
    def _op_mode(self):
        if self._mode == "rnn":
            return "rnn_relu" if self._activation == "relu" else "rnn_tanh"
        return self._mode

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * self._num_states

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states, (layers * directions, batch, hidden) each, on the
        current context unless given ``ctx=``."""
        from ... import ndarray as F

        return [F.zeros(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def infer_shape(self, x, *args):
        ni = x.shape[-1]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, f"{j}{i}_i2h_weight").shape = \
                    (self._gates * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def _flat_names(self):
        """Parameter names in the fused op's flat order: every layer's and
        direction's weights (i2h, h2h), then their biases."""
        keys = [f"{j}{i}" for i in range(self._num_layers)
                for j in ["l", "r"][:self._dir]]
        return [f"{k}_{n}" for k in keys for n in ("i2h_weight",
                                                   "h2h_weight")] + \
            [f"{k}_{n}" for k in keys for n in ("i2h_bias", "h2h_bias")]

    def forward(self, x, states=None):
        """``x`` (T, N, C) or (N, T, C) by the layout; with ``states``
        (``begin_state``'s list) returns (output, new states), else the
        output alone."""
        params = self._resolve_params(x)
        names = self._flat_names()
        state_args = list(states) if states is not None else []
        training = autograd.is_training()
        n_params = len(names)

        def fn(xv, *rest):
            flat = torch.cat([t.reshape(-1) for t in rest[:n_params]])
            if self._layout == "NTC":
                xv = xv.transpose(0, 1)
            outs = fused_rnn(xv, flat, *rest[n_params:],
                             state_size=self._hidden_size,
                             num_layers=self._num_layers,
                             mode=self._op_mode,
                             bidirectional=self._dir == 2,
                             p=self._dropout, state_outputs=True,
                             training=training)
            out = outs[0].transpose(0, 1) if self._layout == "NTC" \
                else outs[0]
            return (out,) + tuple(outs[1:])

        outs = apply_fn(fn, [x] + [params[n] for n in names] + state_args,
                        name=f"rnn:{self._mode}")
        if states is None:
            return outs[0]
        return outs[0], list(outs[1:])

    def hybrid_forward(self, F, x, states=None, **params):
        return self.forward(x, states)

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn", 1,
                         activation=activation, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", 4, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", 3, **kwargs)
