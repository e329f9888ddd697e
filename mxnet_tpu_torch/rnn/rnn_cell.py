"""RNN cells (PyTorch counterpart of ``mxnet_tpu/rnn/rnn_cell.py``).

``cell(inputs, states)`` adds one step to a symbol graph;
``cell.unroll(...)`` adds ``length`` steps, so the unrolled graph runs
through the executor and trains through ``Module.fit`` like any other
symbol. Parameter names match the JAX package's (``<prefix>i2h_weight``,
``<prefix>h2h_bias``, ...), so parameters cross between the packages by
name. Gate order is cuDNN's: LSTM [i, f, g, o], GRU [r, z, n].

``FusedRNNCell`` unrolls into one ``RNN`` node over a flat parameter
vector (``ops/rnn_op.py``: cuDNN on the card); ``unfuse()`` gives the
equivalent stack of unfused cells, and ``unpack_weights``/
``pack_weights`` convert between the flat vector and their per-gate
arrays (``<prefix>l0_i2h_i_weight``, ...; ``r`` for the backward
direction), the reference's names. ``BidirectionalCell`` runs two cells
over the sequence in both directions; ``DropoutCell``, ``ZoneoutCell``
and ``ResidualCell`` modify a step.
"""
from __future__ import annotations

from .. import symbol
from ..initializer import LSTMBias

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


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
            assert not isinstance(cell, BidirectionalCell)
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


class FusedRNNCell(BaseRNNCell):
    """A multi-layer RNN as one ``RNN`` node: its flat parameter vector
    ``<prefix>parameters`` starts from ``initializer.FusedRNN`` (Xavier
    per matrix, the LSTM forget-gate biases at ``forget_bias``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        from ..initializer import FusedRNN, Xavier
        initializer = FusedRNN(Xavier(factor_type="in", magnitude=2.34),
                               num_hidden, num_layers, mode, bidirectional,
                               forget_bias)
        self._parameter = self.params.get("parameters", init=initializer)

    @property
    def state_info(self):
        b = self._num_layers * len(self._directions)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}] * n

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Views of the flat ``arr`` by per-gate name: every (layer,
        direction)'s i2h then h2h gate matrices, then their biases."""
        args, p = {}, 0
        b = len(self._directions)
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group in ("i2h", "h2h"):
                    cols = (li if layer == 0 else b * lh) \
                        if group == "i2h" else lh
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, group, gate)
                        args[name] = arr[p:p + lh * cols].reshape(
                            (lh, cols))
                        p += lh * cols
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group in ("i2h", "h2h"):
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, group, gate)
                        args[name] = arr[p:p + lh]
                        p += lh
        assert p == arr.size, "Invalid parameters size for FusedRNNCell"
        return args

    def unpack_weights(self, args):
        """The flat vector split into per-gate arrays (copies)."""
        args = args.copy()
        arr = args.pop(self._parameter.name)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        num_input = arr.size // b // h // m - \
            (self._num_layers - 1) * (h + b * h + 2) - h - 2
        for name, view in self._slice_weights(arr, num_input, h).items():
            args[name] = view.copy()
        return args

    def pack_weights(self, args):
        """Per-gate arrays joined back into the flat vector."""
        from .. import ndarray as nd
        args = args.copy()
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        num_input = w0.shape[1]
        total = (num_input + h + 2) * h * m * b + \
            (self._num_layers - 1) * m * h * (h + b * h + 2) * b
        arr = nd.zeros((total,), ctx=w0.context, dtype=w0.dtype)
        for name, view in self._slice_weights(arr, num_input, h).items():
            view[:] = args.pop(name)
        args[self._parameter.name] = arr
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please "
                                  "use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """One ``RNN`` node over the whole sequence (swapped to time-major
        for NTC); with ``get_next_state`` the last states come back."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1
            if axis == 1:
                inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        else:
            assert len(inputs) == length
            inputs = symbol.Concat(*[symbol.expand_dims(i, axis=0)
                                     for i in inputs], dim=0)
        if begin_state is None:
            begin_state = self.begin_state()
        kwargs = dict(state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=self._get_next_state, mode=self._mode,
                      name="%srnn" % self._prefix)
        if self._mode == "lstm":
            kwargs["state_cell"] = begin_state[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state=begin_state[0], **kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, axis=axis, num_outputs=length, squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """The equivalent stack of unfused cells (``<prefix>l0_``,
        ``<prefix>r0_``, ...), with ``DropoutCell``s between layers."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pre),
            "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pre),
            "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
            "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


class BidirectionalCell(BaseRNNCell):
    """Two cells over the sequence, ``l_cell`` forward and ``r_cell``
    backward; each step's output is the two joined on axis 1."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in
                   enumerate(zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = symbol.Concat(*[symbol.expand_dims(o, axis=axis)
                                      for o in outputs], dim=axis)
        return outputs, [l_states, r_states]


class ModifierCell(BaseRNNCell):
    """Base of the cells that wrap another cell and modify its step."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout: in training each output and state element keeps its
    previous value with probability ``zoneout_outputs``/``_states``
    (masks from ``Dropout`` of ones, so eval keeps the new values)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros(shape=(0, 0))
        output = next_output if self.zoneout_outputs == 0.0 else \
            symbol.where(mask(self.zoneout_outputs, next_output),
                         next_output, prev_output)
        if self.zoneout_states != 0.0:
            next_states = [symbol.where(mask(self.zoneout_states, new_s),
                                        new_s, old_s)
                           for new_s, old_s in zip(next_states, states)]
        self.prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return symbol._plus(output, inputs), states
