"""Unfused RNN cells (PyTorch counterpart of ``mxnet_tpu/rnn/rnn_cell.py``).

``cell(inputs, states)`` adds one step to a symbol graph;
``cell.unroll(...)`` adds ``length`` steps, so the unrolled graph runs
through the executor and trains through ``Module.fit`` like any other
symbol. Parameter names match the JAX package's (``<prefix>i2h_weight``,
``<prefix>h2h_bias``, ...), so parameters cross between the packages by
name. Gate order is cuDNN's: LSTM [i, f, g, o], GRU [r, z, n].

``DropoutCell`` applies ``Dropout`` to a step's input. The fused cell
(``FusedRNNCell``, which needs the ``RNN`` operator), the bidirectional,
zoneout and residual cells and ``rnn/io.py`` come with a later slice of
the port.
"""
from __future__ import annotations

from .. import symbol
from ..initializer import LSTMBias

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell"]


class RNNParams(object):
    """The variables of a cell, created once per name under ``prefix``."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract RNN cell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states: zero-initialized, non-learned variables
        (``lr_mult=0``) by default; ``func=symbol.zeros`` (with
        ``shape=``) makes them constants of the graph instead."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be " \
            "called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is None:
                state = symbol.Variable(name, lr_mult=0.0)
            else:
                # state_info gives the defaults (shape (0, H): batch
                # unknown); the caller's kwargs override them
                merged = {k: v for k, v in (info or {}).items()
                          if not k.startswith("__")}
                merged.update(kwargs)
                state = func(name=name, **merged)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split each fused i2h/h2h weight and bias into per-gate arrays."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Join per-gate arrays back into the fused i2h/h2h weight and
        bias (the inverse of :meth:`unpack_weights`)."""
        from .. import ndarray as nd
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight, bias = [], []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Unroll ``length`` steps over ``inputs`` (one symbol split along
        the layout's T axis, or a list of per-step symbols); returns
        (outputs, last states), the outputs joined on T when
        ``merge_outputs``."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input."
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()

        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: h' = act(W x + R h + b)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order [i, f, g, o]; the i2h bias starts with the
    forget gate at ``forget_bias``."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = symbol._plus(forget_gate * states[1],
                              in_gate * in_transform,
                              name="%sstate" % name)
        next_h = symbol._mul(out_gate,
                             symbol.Activation(next_c, act_type="tanh"),
                             name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order [r, z, n]."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3,
                                                name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3,
                                                name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = symbol._plus((1.0 - update_gate) * next_h_tmp,
                              update_gate * prev_state_h,
                              name="%sout" % name)
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """A stack of cells, each feeding the next."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states,
                input_prefix=input_prefix, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Apply dropout on the input (no state)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states
