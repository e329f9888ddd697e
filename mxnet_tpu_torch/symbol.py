"""Symbol — declarative graph IR.

PyTorch counterpart of ``mxnet_tpu/symbol.py`` for the first slice: a
Symbol is a list of (node, out_index) heads over a DAG of ``_Node``s, with
op-symbol creation, bidirectional shape inference, and JSON save/load in
the JAX package's format, so each package loads the other's symbols.
``bind``/``simple_bind`` hand the graph to the eager evaluator of
``executor.py``.
"""
from __future__ import annotations

import ast as _ast
import json
import sys

import numpy as onp

from .base import MXNetError
from .attribute import AttrScope
from .name import NameManager
from . import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson"]


class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "_attr_dict",
                 "auto_named")

    def __init__(self, op, name, attrs=None, inputs=None, is_aux=False,
                 attr_dict=None, auto_named=False):
        self.op = op            # OpDef or None for variables
        self.name = name
        self.attrs = attrs or {}          # op parameters (typed)
        self.inputs = inputs or []        # list of (node, out_idx)
        self.is_aux = is_aux
        self._attr_dict = attr_dict or {}  # user attrs (ctx_group, ...)
        self.auto_named = auto_named

    def num_outputs(self):
        return 1 if self.op is None else self.op.num_outputs(self.attrs)


class Symbol:
    """Symbolic multi-output handle."""

    def __init__(self, heads):
        self._heads = list(heads)  # list of (node, out_idx)

    def _topo(self):
        """Topological order of nodes reachable from the heads
        (input-first DFS, which fixes the list_arguments order)."""
        visited = set()
        order = []

        def visit(node):
            if id(node) in visited:
                return
            visited.add(id(node))
            for (src, _) in node.inputs:
                visit(src)
            order.append(node)

        for (n, _) in self._heads:
            visit(n)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo() if n.op is None and not n.is_aux]

    def list_outputs(self):
        outs = []
        for (n, idx) in self._heads:
            if n.op is None:
                outs.append(n.name)
            else:
                outs.append("%s_%s" % (n.name,
                                       n.op.list_outputs(n.attrs)[idx]))
        return outs

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.op is None and n.is_aux]

    @property
    def name(self):
        """The name of a single-output symbol's node, else None."""
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def attr(self, key):
        """A user attribute of a single-output symbol's node, or None."""
        if len(self._heads) == 1:
            return self._heads[0][0]._attr_dict.get(key)
        return None

    def _set_attr(self, **kwargs):
        for (n, _) in self._heads:
            n._attr_dict.update(kwargs)

    # ------------------------------------------------------ composition
    def __call__(self, *args, **kwargs):
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        """Substitute free variables with symbols (nnvm Symbol::Compose):
        kwargs match variable *names* anywhere in the graph; positional args
        match free variables in list_arguments order."""
        name = kwargs.pop("name", None)
        # "one head node" includes multi-output atomics (SliceChannel, RNN)
        # whose heads are N outputs of the SAME node
        single = len({id(n) for (n, _) in self._heads}) == 1
        head = self._heads[0][0] if single else None
        if kwargs and single and head.op is not None:
            # nnvm Compose on an ATOMIC head matches kwargs against the
            # op's argument names (data/weight/...). Our placeholders are
            # eager, so "atomic" = every input is still the placeholder
            # variable _create generated (named <head>_<arg>); once any
            # input was bound, the symbol is composite and kwargs match
            # variable names like everywhere else.
            argnames = head.op.list_arguments(head.attrs)
            pairs = list(zip(head.inputs, argnames))
            if all(src.op is None and src.auto_named
                   and src.name == head.name + "_" + nm
                   for (src, _), nm in pairs) and pairs:
                trans = {nm: src.name for (src, _), nm in pairs}
                kwargs = {trans.get(k, k): v for k, v in kwargs.items()}
        order = self._topo()
        free_vars = [n for n in order if n.op is None]
        repl = {}  # id(var node) -> (node, out_idx) replacement head
        # positional args bind in list_arguments order, which excludes aux
        # states (reference symbol.py __call__ / nnvm Symbol::Compose)
        pos_vars = [n for n in free_vars if not n.is_aux]
        if len(args) > len(pos_vars):
            raise MXNetError(
                "too many positional arguments: %d given, %d free variables"
                % (len(args), len(pos_vars)))
        for var, s in zip(pos_vars, args):
            repl[id(var)] = s._heads[0]
        by_name = {n.name: n for n in free_vars}
        for k, v in kwargs.items():
            if k not in by_name:
                raise MXNetError("cannot compose: no variable named %s" % k)
            repl[id(by_name[k])] = v._heads[0]
        for n in order:
            n.inputs = [repl.get(id(src), (src, oi))
                        for (src, oi) in n.inputs]
        self._heads = [repl.get(id(n), (n, oi)) for (n, oi) in self._heads]
        if name and single and head.op is not None:
            # nnvm Symbol::Compose assigns the node name BEFORE argument
            # names are synthesized (nnvm/src/core/symbolic.cc), so a
            # compose-time name flows into auto param names (fc1_weight).
            # Our placeholders are eager: rename the head's still-free
            # direct-input PLACEHOLDERS (auto_named vars _create made)
            # that carry its auto-generated prefix. User-chosen names —
            # even ones sharing the prefix — are never touched.
            old = head.name
            head.name = name
            if old != name and head.auto_named:
                for (src, _) in head.inputs:
                    if src.op is None and src.auto_named \
                            and src.name.startswith(old + "_"):
                        src.name = name + src.name[len(old):]
            head.auto_named = False

    def __copy__(self):
        # deep copy of reachable graph
        mapping = {}

        def copy_node(n):
            if id(n) in mapping:
                return mapping[id(n)]
            c = _Node(n.op, n.name, dict(n.attrs), [], n.is_aux,
                      dict(n._attr_dict), auto_named=n.auto_named)
            mapping[id(n)] = c
            c.inputs = [(copy_node(s), i) for (s, i) in n.inputs]
            return c

        return Symbol([(copy_node(n), i) for (n, i) in self._heads])

    def attr_dict(self):
        ret = {}
        for n in self._topo():
            d = dict(n._attr_dict)
            if n.op is not None:
                d.update({k: str(v) for k, v in n.attrs.items()})
            if d:
                ret[n.name] = d
        return ret

    def get_internals(self):
        """Symbol whose outputs are every node's outputs."""
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs())])

    def get_children(self):
        """The inputs of a single-output symbol's node as one Symbol, or
        None for a variable or a multi-output symbol."""
        if len(self._heads) != 1:
            return None
        node = self._heads[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index):
        """One output, by position or by name (``name`` or
        ``name_output``, as ``get_internals()`` lists them)."""
        if isinstance(index, str):
            for i, nm in enumerate(self.list_outputs()):
                if nm == index or nm == index + "_output":
                    return Symbol([self._heads[i]])
            raise ValueError("cannot find output %s" % index)
        return Symbol([self._heads[index]])

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    def __len__(self):
        return len(self._heads)

    # arithmetic, with a symbol or a number (the JAX package's rules)
    def __add__(self, other):
        return _sym_binary(self, other, "_plus", "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _sym_binary(self, other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_binary(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _sym_binary(self, other, "_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __div__(self, other):
        return _sym_binary(self, other, "_div", "_div_scalar")

    __truediv__ = __div__

    def __rdiv__(self, other):
        return _sym_binary(self, other, None, "_rdiv_scalar")

    __rtruediv__ = __rdiv__

    def __neg__(self):
        return _sym_binary(self, -1.0, None, "_mul_scalar")

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(self.list_outputs())

    # ------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self.infer_shape_partial(
            *args, **kwargs)
        if any(s is None for s in arg_shapes):
            unknown = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            raise MXNetError("cannot infer shapes for arguments: %s"
                             % unknown)
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        """Bidirectional shape inference: node-local infer_shape iterated
        to a fixpoint, so layer ops fill parameter shapes from data."""
        arg_names = self.list_arguments()
        known = {}
        for nm, s in zip(arg_names, args):
            if s is not None:
                known[nm] = tuple(s)
        valid = set(arg_names) | set(self.list_auxiliary_states())
        for k, v in kwargs.items():
            if k not in valid:
                raise ValueError(
                    "Unknown argument %s in infer_shape (arguments: %s)"
                    % (k, arg_names))
            if v is not None:
                known[k] = tuple(v)

        order = self._topo()
        shapes = {}  # id(node) -> list of out shapes (or None)
        for n in order:
            if n.op is None:
                s = known.get(n.name)
                if s is None and "__shape__" in n._attr_dict:
                    s = tuple(_ast.literal_eval(n._attr_dict["__shape__"]))
                shapes[id(n)] = [s]
            else:
                shapes[id(n)] = [None] * n.num_outputs()

        for _ in range(3):  # fixpoint iterations
            changed = False
            for n in order:
                if n.op is None:
                    continue
                in_sh = [shapes[id(s)][oi] for (s, oi) in n.inputs]
                n_args = len(n.op.list_arguments(n.attrs))
                try:
                    filled, outs, aux_filled = n.op.infer_shape(
                        n.attrs, in_sh[:n_args], in_sh[n_args:])
                except (ValueError, RuntimeError, TypeError, KeyError):
                    # a node whose inputs are not all known yet
                    continue
                for (src, oi), s in zip(n.inputs,
                                        (filled or []) + (aux_filled or [])):
                    if s is not None and shapes[id(src)][oi] is None:
                        shapes[id(src)][oi] = tuple(s)
                        changed = True
                for i, s in enumerate(outs or []):
                    if s is not None and shapes[id(n)][i] is None:
                        shapes[id(n)][i] = tuple(s)
                        changed = True
            if not changed:
                break

        arg_shapes = [shapes[id(n)][0] for n in order
                      if n.op is None and not n.is_aux]
        aux_shapes = [shapes[id(n)][0] for n in order
                      if n.op is None and n.is_aux]
        out_shapes = [shapes[id(n)][oi] for (n, oi) in self._heads]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, **kwargs):
        """float32 everywhere unless given (as in the JAX package)."""
        known = {k: onp.dtype(v) for k, v in kwargs.items() if v is not None}
        default = next(iter(known.values())) if known else \
            onp.dtype(onp.float32)
        arg_types = [known.get(n, default) for n in self.list_arguments()]
        aux_types = [default] * len(self.list_auxiliary_states())
        return arg_types, [default] * len(self._heads), aux_types

    # -------------------------------------------------------- serialize
    def tojson(self):
        order = self._topo()
        idx = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {
                "op": "null" if n.op is None else n.op.name,
                "name": n.name,
                "inputs": [[idx[id(s)], oi] for (s, oi) in n.inputs],
            }
            attrs = {k: str(v) for k, v in n.attrs.items()}
            if attrs:
                entry["attrs"] = attrs
            if n._attr_dict:
                entry["attr"] = dict(n._attr_dict)
            if n.is_aux:
                entry["__aux__"] = True
            nodes.append(entry)
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.op is None],
            "heads": [[idx[id(n)], oi] for (n, oi) in self._heads],
            "attrs": {"mxnet_version": ["int", 905]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ----------------------------------------------------------- binding
    def simple_bind(self, ctx, grad_req="write", type_dict=None, **kwargs):
        """Allocate every argument from the inferred shapes, then bind."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**(type_dict or {}))
        names = self.list_arguments()
        args = [nd.zeros(s, ctx=ctx, dtype=t)
                for s, t in zip(arg_shapes, arg_types)]
        aux = [nd.zeros(s, ctx=ctx, dtype=t)
               for s, t in zip(aux_shapes, aux_types)]
        args_grad = None
        if grad_req != "null":
            reqs = {n: grad_req for n in names} \
                if isinstance(grad_req, str) else dict(grad_req)
            args_grad = {n: nd.zeros(s, ctx=ctx, dtype=t)
                         for n, s, t in zip(names, arg_shapes, arg_types)
                         if reqs.get(n, "null") != "null"}
        return self.bind(ctx, args, args_grad=args_grad, grad_req=grad_req,
                         aux_states=aux)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind to the input arrays ``kwargs`` (no gradients) and run one
        forward: the output NDArrays. ``ctx`` defaults to the context of
        the first array given (the JAX package's default is ``cpu()``;
        the port runs where the data is), else the current context."""
        if ctx is None:
            first = next(iter(kwargs.values()), None)
            ctx = first.context if hasattr(first, "context") else None
        if ctx is None:
            from .context import current_context
            ctx = current_context()
        ex = self.bind(ctx, kwargs, grad_req="null")
        return ex.forward()


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             init=None):
    """Create a symbolic variable (mx.sym.Variable); ``shape`` seeds shape
    inference, ``lr_mult``/``wd_mult`` reach the optimizer and ``init``
    (an Initializer) initializes this variable alone, as attributes."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = dict(AttrScope.current().get(attr) or {})
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attr["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    return Symbol([(_Node(None, name, attr_dict=attr), 0)])


var = Variable


def Group(symbols):
    """One multi-output symbol of the given symbols' outputs."""
    return Symbol([h for s in symbols for h in s._heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Load a symbol from JSON (either package's); tolerates the legacy
    "param" attr key."""
    data = json.loads(json_str)
    raw_nodes = data["nodes"]
    nodes = []
    for e in raw_nodes:
        op_name = e.get("op", "null")
        attrs = e.get("attrs", e.get("param", {})) or {}
        user_attr = e.get("attr", {}) or {}
        if op_name == "null":
            n = _Node(None, e["name"], attr_dict=dict(user_attr),
                      is_aux=bool(e.get("__aux__", False)))
        else:
            op = _registry.get_op(op_name)
            n = _Node(op, e["name"], _registry.parse_attrs(op, attrs),
                      attr_dict=dict(user_attr))
        nodes.append(n)
    for n, e in zip(nodes, raw_nodes):
        n.inputs = [(nodes[x[0]], x[1]) for x in e.get("inputs", [])]
        # aux variables sit beyond the op's argument list
        if n.op is not None:
            for (src, _) in n.inputs[len(n.op.list_arguments(n.attrs)):]:
                if src.op is None:
                    src.is_aux = True
    return Symbol([(nodes[h[0]], h[1]) for h in data["heads"]])


def fromjson(json_str):
    """Alias of :func:`load_json` (``mx.sym.fromjson``)."""
    return load_json(json_str)


# ---------------------------------------------------------------------------
# symbol op wrappers, generated from the registry
# ---------------------------------------------------------------------------
def _sym_binary(lhs, rhs, op_name, scalar_op_name):
    """``lhs <op> rhs``: the two-symbol op, or the scalar op with
    ``scalar=rhs``."""
    if isinstance(rhs, Symbol):
        if op_name is None:
            raise MXNetError("unsupported symbol operation")
        return _create(op_name, [lhs, rhs], {})
    if isinstance(rhs, (int, float)):
        return _create(scalar_op_name, [lhs], {"scalar": float(rhs)})
    raise TypeError("type %s not supported" % str(type(rhs)))


def _create(op_name, input_syms, attrs, name=None, named_inputs=None):
    op = _registry.get_op(op_name)
    hint = op.name.lower().lstrip("_")
    auto_named = name is None
    name = NameManager.current().get(name, hint)
    user_attrs = AttrScope.current().get(None)
    attrs = _registry.parse_attrs(op, attrs)
    if op.variable_args is not None and op.variable_args not in attrs:
        attrs[op.variable_args] = len(input_syms)

    arg_names = op.list_arguments(attrs)
    named_inputs = named_inputs or {}
    inputs = []
    pos = list(input_syms)
    for nm in arg_names:
        if nm in named_inputs:
            inputs.append(named_inputs[nm]._heads[0])
        elif pos:
            inputs.append(pos.pop(0)._heads[0])
        else:
            vnode = _Node(None, "%s_%s" % (name, nm),
                          attr_dict=dict(user_attrs) if user_attrs else {},
                          auto_named=True)
            inputs.append((vnode, 0))
    if pos:
        raise MXNetError(
            "%s takes %d input(s) %s for these attributes; %d extra "
            "positional input(s) given" % (op.name, len(arg_names),
                                           arg_names, len(pos)))
    unknown = [k for k in named_inputs
               if k not in arg_names and k not in op.aux_names]
    if unknown:
        raise MXNetError(
            "%s got unexpected input(s) %s (arguments for these "
            "attributes: %s)" % (op.name, unknown, arg_names))
    # aux states appended after args, auto-created (BatchNorm moving stats)
    for nm in op.aux_names:
        if nm in named_inputs:
            head = named_inputs[nm]._heads[0]
            head[0].is_aux = True
            inputs.append(head)
        else:
            inputs.append((_Node(None, "%s_%s" % (name, nm), is_aux=True,
                                 auto_named=True), 0))

    node = _Node(op, name, attrs, inputs,
                 attr_dict=dict(user_attrs) if user_attrs else {},
                 auto_named=auto_named)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_sym_func(op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        named_inputs = {k: v for k, v in kwargs.items()
                        if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if v is not None and not isinstance(v, Symbol)}
        input_syms = [a for a in args if isinstance(a, Symbol)]
        return _create(op.name, input_syms, attrs, name=name,
                       named_inputs=named_inputs)

    fn.__name__ = op.name
    fn.__doc__ = (op.fcompute.__doc__ or "") + "\n\n(symbol op: %s)" % op.name
    return fn


def _init_symbol_module():
    mod = sys.modules[__name__]
    for name in _registry.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_sym_func(_registry.get_op(name)))


def maximum(lhs, rhs):
    """Elementwise maximum of two symbols, or of a symbol and a scalar."""
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _create("_maximum", [lhs, rhs], {})
    s, other = (lhs, rhs) if isinstance(rhs, (int, float)) else (rhs, lhs)
    return _create("_maximum_scalar", [s], {"scalar": float(other)})


def minimum(lhs, rhs):
    """Elementwise minimum of two symbols, or of a symbol and a scalar."""
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _create("_minimum", [lhs, rhs], {})
    s, other = (lhs, rhs) if isinstance(rhs, (int, float)) else (rhs, lhs)
    return _create("_minimum_scalar", [s], {"scalar": float(other)})


from . import ops as _ops  # noqa: E402,F401
_init_symbol_module()
