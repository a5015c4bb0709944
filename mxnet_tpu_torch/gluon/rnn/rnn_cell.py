"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``):
``RNNCell``, ``LSTMCell`` and ``GRUCell``, ``SequentialRNNCell``, the
``DropoutCell``, ``ZoneoutCell`` and ``ResidualCell`` modifiers, and
``unroll`` over a sequence in the NTC or TNC layout.  A cell's call is one
step, ``cell(x, states) -> (output, new states)``; a cell computes eagerly
inside whatever calls it (a hybridized block captures it with its own
forward).  ``begin_state`` makes zeros on the current context unless given
``ctx=``; ``unroll`` makes them beside its inputs."""
from __future__ import annotations

from ... import autograd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F

        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(F.zeros(info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        axis = layout.find("T")
        batch_size = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs.context)
        states = begin_state
        outputs = []
        for i in range(length):
            step_in = F.squeeze(F.slice_axis(inputs, axis=axis, begin=i, end=i + 1),
                                axis=axis)
            out, states = self(step_in, states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, x, states):
        self._counter += 1
        return self._forward_cell(x, states)

    def _forward_cell(self, x, states):
        params = self._resolve_params(x)
        from ... import ndarray as F

        return self.hybrid_forward(F, x, states, **params)


class RNNCell(RecurrentCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        prev_h, prev_c = states
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * prev_c + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, **kwargs):
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(batch_size, **kwargs))
        return states

    def _forward_cell(self, x, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, s = cell(x, states[pos:pos + n])
            pos += n
            next_states.extend(s)
        return x, next_states

    def __len__(self):
        return len(self._children)


class ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class DropoutCell(ModifierCell):
    def __init__(self, rate, axes=(), **kwargs):
        cell = kwargs.pop("base_cell", None)
        if cell is None:
            raise MXNetError("DropoutCell here wraps a base_cell; pass "
                             "base_cell=...")
        super().__init__(cell)
        self._rate = rate
        self._axes = axes

    def _forward_cell(self, x, states):
        from ... import ndarray as F

        out, states = self.base_cell(x, states)
        if self._rate > 0:
            out = F.Dropout(out, p=self._rate, axes=self._axes or None,
                            training=autograd.is_training())
        return out, states


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def _forward_cell(self, x, states):
        from ... import ndarray as F

        out, next_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zo > 0:
                mask = F.random.bernoulli(prob=1 - self._zo, shape=out.shape,
                                          ctx=out.context)
                prev = self._prev_output if self._prev_output is not None else \
                    F.zeros_like(out)
                out = mask * out + (1 - mask) * prev
            if self._zs > 0:
                mixed = []
                for new, old in zip(next_states, states):
                    mask = F.random.bernoulli(prob=1 - self._zs,
                                              shape=new.shape,
                                              ctx=new.context)
                    mixed.append(mask * new + (1 - mask) * old)
                next_states = mixed
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    def _forward_cell(self, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states
