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

__all__ = ["Symbol", "Variable", "load", "load_json"]


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

    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise TypeError("type %s not supported" % str(type(other)))
        return _create("_plus", [self, other], {})

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


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None):
    """Create a symbolic variable (mx.sym.Variable); ``shape`` seeds shape
    inference."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = dict(AttrScope.current().get(attr) or {})
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    return Symbol([(_Node(None, name, attr_dict=attr), 0)])


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


# ---------------------------------------------------------------------------
# symbol op wrappers, generated from the registry
# ---------------------------------------------------------------------------
def _create(op_name, input_syms, attrs, name=None, named_inputs=None):
    op = _registry.get_op(op_name)
    hint = op.name.lower().lstrip("_")
    auto_named = name is None
    name = NameManager.current().get(name, hint)
    user_attrs = AttrScope.current().get(None)
    attrs = _registry.parse_attrs(op, attrs)

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


from . import ops as _ops  # noqa: E402,F401
_init_symbol_module()
