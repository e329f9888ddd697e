"""Operator registry — the single registration point per op.

PyTorch counterpart of ``mxnet_tpu/registry.py``. Every op is one record
with

* ``fcompute(attrs, inputs, octx) -> [torch outputs]`` — plain functions on
  tensors. Gradients come from torch autograd; ops with non-standard
  gradients (losses whose backward ignores head grads, the BatchNorm core
  with its hand-derived backward) are ``torch.autograd.Function``s.
* shape inference: a custom ``infer_shape`` with the reference's
  bidirectional-fill contract, or by default forward-only inference by
  running ``fcompute`` on tensors of the ``meta`` device.
* aux state (BatchNorm moving stats): declared via ``aux_names``; fcompute
  receives aux tensors appended to inputs and returns aux updates appended
  to outputs (the executor writes them back).
"""
from __future__ import annotations

import ast

import torch

from .base import MXNetError

__all__ = ["OpDef", "OpContext", "register", "get_op", "list_ops",
           "parse_attrs"]

_OP_REGISTRY = {}


class OpContext:
    """Per-invocation context handed to fcompute: the train flag."""

    __slots__ = ("is_train",)

    def __init__(self, is_train=False):
        self.is_train = is_train


class OpDef:
    """One registered operator."""

    def __init__(self, name, fcompute, arg_names=("data",),
                 out_names=("output",), aux_names=(), attr_types=None,
                 infer_shape=None, alias=()):
        self.name = name
        self.fcompute = fcompute
        # arg_names may be a callable(attrs) -> names for ops whose input
        # list depends on attrs (no_bias, ...)
        self.arg_names = arg_names if callable(arg_names) else tuple(arg_names)
        self.out_names = tuple(out_names)
        self.aux_names = tuple(aux_names)
        self.attr_types = attr_types or {}
        self._infer_shape = infer_shape
        self.alias = tuple(alias)

    def list_arguments(self, attrs=None):
        if callable(self.arg_names):
            return list(self.arg_names(attrs or {}))
        return list(self.arg_names)

    def list_outputs(self, attrs=None):
        return list(self.out_names)

    def num_outputs(self, attrs=None):
        return len(self.out_names)

    def infer_shape(self, attrs, in_shapes, aux_shapes=None):
        """Return (in_shapes, out_shapes, aux_shapes), filling unknowns.

        Defaults to forward-only inference on ``meta`` tensors when every
        input shape is known."""
        if self._infer_shape is not None:
            return self._infer_shape(attrs, list(in_shapes),
                                     list(aux_shapes or []))
        if any(s is None for s in in_shapes):
            return list(in_shapes), None, list(aux_shapes or [])
        metas = [torch.empty(s, device="meta") for s in in_shapes]
        outs = self.fcompute(attrs, metas, OpContext(is_train=False))
        out_shapes = [tuple(o.shape) for o in outs[:self.num_outputs(attrs)]]
        return list(in_shapes), out_shapes, list(aux_shapes or [])

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, **kwargs):
    """Decorator: register ``fcompute`` under ``name`` (+ aliases)."""

    def _reg(fcompute):
        op = OpDef(name, fcompute, **kwargs)
        _OP_REGISTRY[name] = op
        for a in op.alias:
            _OP_REGISTRY[a] = op
        return fcompute

    return _reg


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("Operator %s is not registered" % name)


def list_ops():
    return sorted(_OP_REGISTRY)


# ---------------------------------------------------------------------------
# attr parsing — the JAX package's rules, so attrs read from its JSON parse
# to the same python values
# ---------------------------------------------------------------------------
def _parse_value(v, ty=None):
    if ty is not None and not isinstance(v, str):
        if ty is bool:
            return bool(v)
        if ty in (int, float):
            return ty(v)
        if ty is tuple and isinstance(v, (list, tuple)):
            return tuple(v)
        if ty is str:
            return str(v)
        return v
    if not isinstance(v, str):
        return v
    s = v.strip()
    if ty is str:
        return s
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        val = ast.literal_eval(s)
        if isinstance(val, list):
            val = tuple(val)
        if ty is not None and ty is not tuple and not isinstance(val, tuple):
            try:
                val = ty(val)
            except (TypeError, ValueError):
                pass
        return val
    except (ValueError, SyntaxError):
        return s


def parse_attrs(op, attrs):
    """Parse raw attrs (possibly all-string, from JSON) to typed python."""
    return {k: _parse_value(v, op.attr_types.get(k)) for k, v in attrs.items()}
