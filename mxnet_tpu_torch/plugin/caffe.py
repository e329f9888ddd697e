"""Caffe plugin: run Caffe-described layers as the port's own symbols (the
port's counterpart of ``mxnet_tpu/plugin/caffe.py``).

Reference counterpart: plugin/caffe/caffe_op.cc, which embeds libcaffe
and runs the layer with Caffe's kernels. Here the ``prototxt`` layer
string is read by this module's own reader of the protobuf text format
(the fields of the public Caffe schema the supported layers use, with
its defaults; unknown fields are skipped) and lowered onto the
equivalent operator, as the JAX package lowers it through
``tools/caffe_converter``. Neither protobuf nor the converter is needed.

    fc = mx.sym.CaffeOp(data, num_weight=2,
                        prototxt="layer{type:\\"InnerProduct\\" "
                                 "inner_product_param{num_output: 10}}")

Supported layer types: Convolution, Deconvolution, Pooling, InnerProduct,
ReLU, Sigmoid, TanH, LRN, Dropout, BatchNorm, Concat, Eltwise, Flatten,
Reshape, Softmax, SoftmaxWithLoss. CaffeLoss supports SoftmaxWithLoss.
CaffeDataIter is not provided: it reads LMDB/LevelDB through libcaffe;
use ImageRecordIter instead.
"""
from __future__ import annotations

import re

import numpy as onp

__all__ = ["CaffeOp", "CaffeLoss", "parse_layer", "build_layer"]

# The public BVLC Caffe schema (caffe.proto, BSD-2-Clause), the fields the
# supported layers read: {message: {field: (kind, default, repeated)}}.
# A kind is "int", "float", "bool", "str", an enum's {name: value} map, or
# the name of a message.
_POOL = {"MAX": 0, "AVE": 1, "STOCHASTIC": 2}
_ELTWISE = {"PROD": 0, "SUM": 1, "MAX": 2}
_PHASE = {"TRAIN": 0, "TEST": 1}
_SCHEMA = {
    "LayerParameter": {
        "name": ("str", "", False), "type": ("str", "", False),
        "bottom": ("str", None, True), "top": ("str", None, True),
        "phase": (_PHASE, 0, False), "loss_weight": ("float", None, True),
        "batch_norm_param": ("BatchNormParameter", None, False),
        "concat_param": ("ConcatParameter", None, False),
        "convolution_param": ("ConvolutionParameter", None, False),
        "dropout_param": ("DropoutParameter", None, False),
        "eltwise_param": ("EltwiseParameter", None, False),
        "flatten_param": ("FlattenParameter", None, False),
        "inner_product_param": ("InnerProductParameter", None, False),
        "input_param": ("InputParameter", None, False),
        "lrn_param": ("LRNParameter", None, False),
        "pooling_param": ("PoolingParameter", None, False),
        "reshape_param": ("ReshapeParameter", None, False),
        "scale_param": ("ScaleParameter", None, False),
        "softmax_param": ("SoftmaxParameter", None, False),
    },
    "BlobShape": {"dim": ("int", None, True)},
    "InputParameter": {"shape": ("BlobShape", None, True)},
    "ReshapeParameter": {"shape": ("BlobShape", None, False),
                         "axis": ("int", 0, False),
                         "num_axes": ("int", -1, False)},
    "ConcatParameter": {"axis": ("int", 1, False),
                        "concat_dim": ("int", 1, False)},
    "BatchNormParameter": {"use_global_stats": ("bool", False, False),
                           "moving_average_fraction": ("float", 0.999,
                                                       False),
                           "eps": ("float", 1e-5, False)},
    "ConvolutionParameter": {
        "num_output": ("int", 0, False), "bias_term": ("bool", True, False),
        "pad": ("int", None, True), "kernel_size": ("int", None, True),
        "stride": ("int", None, True), "dilation": ("int", None, True),
        "pad_h": ("int", 0, False), "pad_w": ("int", 0, False),
        "kernel_h": ("int", 0, False), "kernel_w": ("int", 0, False),
        "stride_h": ("int", 0, False), "stride_w": ("int", 0, False),
        "group": ("int", 1, False)},
    "DropoutParameter": {"dropout_ratio": ("float", 0.5, False)},
    "EltwiseParameter": {"operation": (_ELTWISE, 1, False),
                         "coeff": ("float", None, True)},
    "FlattenParameter": {"axis": ("int", 1, False),
                         "end_axis": ("int", -1, False)},
    "InnerProductParameter": {"num_output": ("int", 0, False),
                              "bias_term": ("bool", True, False),
                              "axis": ("int", 1, False),
                              "transpose": ("bool", False, False)},
    "LRNParameter": {"local_size": ("int", 5, False),
                     "alpha": ("float", 1.0, False),
                     "beta": ("float", 0.75, False),
                     "k": ("float", 1.0, False)},
    "PoolingParameter": {
        "pool": (_POOL, 0, False), "pad": ("int", 0, False),
        "pad_h": ("int", 0, False), "pad_w": ("int", 0, False),
        "kernel_size": ("int", 0, False), "kernel_h": ("int", 0, False),
        "kernel_w": ("int", 0, False), "stride": ("int", 1, False),
        "stride_h": ("int", 0, False), "stride_w": ("int", 0, False),
        "global_pooling": ("bool", False, False)},
    "ScaleParameter": {"axis": ("int", 1, False),
                       "num_axes": ("int", 1, False),
                       "bias_term": ("bool", False, False)},
    "SoftmaxParameter": {"axis": ("int", 1, False)},
}

_TOKEN = re.compile(r'\s+|#[^\n]*|"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\''
                    r'|[{}:;,<>\[\]]|[^\s{}:;,<>\[\]"\'#]+')


class _Msg(object):
    """A parsed message: field access with the schema's defaults, and
    ``HasField`` as protobuf's."""

    def __init__(self, kind, fields):
        self._kind = kind
        self._fields = fields       # name -> [values]

    def HasField(self, name):  # noqa: N802 - protobuf's name
        return name in self._fields

    def field_names(self):
        return _SCHEMA[self._kind]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            kind, default, repeated = _SCHEMA[self._kind][name]
        except KeyError:
            raise AttributeError("%s has no field %r" % (self._kind, name))
        vals = self._fields.get(name, [])
        if repeated:
            return list(vals)
        if vals:
            return vals[-1]
        if isinstance(kind, str) and kind in _SCHEMA:
            return _Msg(kind, {})
        return default


def _scalar(kind, tok, field):
    if isinstance(kind, dict):
        if tok in kind:
            return kind[tok]
        return int(tok)
    if kind == "str":
        if tok[:1] in "\"'":
            return bytes(tok[1:-1], "utf-8").decode("unicode_escape")
        return tok
    if kind == "bool":
        if tok in ("true", "True", "t", "1"):
            return True
        if tok in ("false", "False", "f", "0"):
            return False
        raise ValueError("field %r: %r is not a bool" % (field, tok))
    if kind == "int":
        return int(tok, 0)
    # proto float: the value as a float32 holds it
    return float(onp.float32(float(tok)))


def _parse(tokens, pos, kind):
    """Fields of one message of ``kind`` from ``tokens[pos:]`` up to its
    closing brace: (message, position after it)."""
    fields = {}
    schema = _SCHEMA.get(kind, {})
    while pos < len(tokens) and tokens[pos] not in ("}", ">"):
        name = tokens[pos]
        pos += 1
        if tokens[pos] == ":":
            pos += 1
        spec = schema.get(name)
        if tokens[pos] in ("{", "<"):
            sub_kind = spec[0] if spec is not None and \
                isinstance(spec[0], str) and spec[0] in _SCHEMA else None
            sub, pos = _parse(tokens, pos + 1, sub_kind)
            pos += 1                                    # the closing brace
            if spec is not None and sub_kind is not None:
                fields.setdefault(name, []).append(sub)
        else:
            values = []
            if tokens[pos] == "[":                      # a list of values
                pos += 1
                while tokens[pos] != "]":
                    if tokens[pos] != ",":
                        values.append(tokens[pos])
                    pos += 1
            else:
                values.append(tokens[pos])
            pos += 1
            if spec is not None:
                fields.setdefault(name, []).extend(
                    _scalar(spec[0], v, name) for v in values)
        while pos < len(tokens) and tokens[pos] in (";", ","):
            pos += 1
    return _Msg(kind, fields), pos


def parse_layer(prototxt):
    """A Caffe ``LayerParameter`` from its text format, either bare or in
    a ``layer { ... }`` wrapper."""
    txt = prototxt.strip()
    if txt.startswith("layer"):
        txt = txt[txt.index("{") + 1:txt.rindex("}")]
    tokens = [t for t in _TOKEN.findall(txt)
              if t.strip() and not t.startswith("#")]
    lay, pos = _parse(tokens, 0, "LayerParameter")
    if pos != len(tokens):
        raise ValueError("prototxt: unexpected %r" % tokens[pos])
    return lay


def _pair(param, field, default, hw_field=None):
    """Caffe geometry field -> (h, w), in the schema's three styles:
    repeated (Convolution), scalar (Pooling) and explicit *_h/*_w.
    Presence, not truthiness: ``pad_h: 0 pad_w: 3`` is asymmetric."""
    hw = hw_field or field
    names = param.field_names()
    has_h = hw + "_h" in names and param.HasField(hw + "_h")
    has_w = hw + "_w" in names and param.HasField(hw + "_w")
    if has_h or has_w:
        return (int(getattr(param, hw + "_h")),
                int(getattr(param, hw + "_w")))
    val = getattr(param, field)
    if not isinstance(val, list):              # scalar (PoolingParameter)
        if param.HasField(field):
            return (int(val), int(val))
        return (default, default)
    if len(val) == 1:
        return (int(val[0]), int(val[0]))
    if len(val) >= 2:
        return (int(val[0]), int(val[1]))
    return (default, default)


def _bn_kwargs(lay):
    p = lay.batch_norm_param
    return dict(name=lay.name, eps=max(float(p.eps), 1e-5),
                momentum=float(p.moving_average_fraction),
                use_global_stats=bool(p.use_global_stats))


def build_layer(mx, lay, inputs, name=None):
    """One Caffe layer and its input symbols -> the port's symbol."""
    t = lay.type
    name = name or lay.name or t.lower()
    if t in ("Convolution", "Deconvolution"):
        p = lay.convolution_param
        kw = dict(data=inputs[0], name=name, num_filter=int(p.num_output),
                  kernel=_pair(p, "kernel_size", 1, "kernel"),
                  stride=_pair(p, "stride", 1), pad=_pair(p, "pad", 0),
                  num_group=int(p.group), no_bias=not p.bias_term)
        if t == "Convolution":
            return mx.sym.Convolution(dilate=_pair(p, "dilation", 1), **kw)
        return mx.sym.Deconvolution(**kw)
    if t == "Pooling":
        p = lay.pooling_param
        if int(p.pool) == 2:
            raise ValueError("STOCHASTIC pooling (layer %r) has no "
                             "equivalent here" % name)
        kwargs = dict(pool_type={0: "max", 1: "avg"}[int(p.pool)],
                      pooling_convention="full", name=name)
        if p.global_pooling:
            kwargs.update(global_pool=True, kernel=(1, 1))
        else:
            kwargs.update(kernel=_pair(p, "kernel_size", 1, "kernel"),
                          stride=_pair(p, "stride", 1),
                          pad=_pair(p, "pad", 0))
        return mx.sym.Pooling(data=inputs[0], **kwargs)
    if t == "InnerProduct":
        p = lay.inner_product_param
        return mx.sym.FullyConnected(
            data=inputs[0], name=name,
            num_hidden=int(p.num_output), no_bias=not p.bias_term)
    if t in ("ReLU", "Sigmoid", "TanH"):
        return mx.sym.Activation(data=inputs[0], name=name, act_type={
            "ReLU": "relu", "Sigmoid": "sigmoid", "TanH": "tanh"}[t])
    if t == "LRN":
        p = lay.lrn_param
        return mx.sym.LRN(data=inputs[0], name=name,
                          alpha=float(p.alpha), beta=float(p.beta),
                          knorm=float(p.k), nsize=int(p.local_size))
    if t == "Dropout":
        return mx.sym.Dropout(data=inputs[0], name=name,
                              p=float(lay.dropout_param.dropout_ratio))
    if t == "BatchNorm":
        kw = _bn_kwargs(lay)
        kw["name"] = name
        return mx.sym.BatchNorm(data=inputs[0], fix_gamma=True, **kw)
    if t == "Concat":
        return mx.sym.Concat(*inputs, name=name,
                             dim=int(lay.concat_param.axis))
    if t == "Eltwise":
        p = lay.eltwise_param
        op = int(p.operation)
        coeff = list(p.coeff)
        syms = list(inputs)
        if coeff and op != 1:
            raise ValueError("Eltwise coeff only applies to SUM "
                             "(layer %r)" % name)
        if coeff and len(coeff) != len(syms):
            raise ValueError("Eltwise %r: %d coeffs for %d bottoms"
                             % (name, len(coeff), len(syms)))
        if op == 1 and coeff:
            syms = [s if c == 1.0 else s * float(c)
                    for s, c in zip(syms, coeff)]
        acc = syms[0]
        for s in syms[1:]:
            if op == 0:
                acc = acc * s
            elif op == 1:
                acc = acc + s
            else:
                acc = mx.sym.maximum(acc, s)
        return acc
    if t == "Flatten":
        return mx.sym.Flatten(data=inputs[0], name=name)
    if t == "Reshape":
        p = lay.reshape_param
        if int(p.axis) != 0 or int(p.num_axes) != -1:
            raise ValueError("Reshape axis/num_axes not supported "
                             "(layer %r)" % name)
        # Caffe's 0 copies the input dimension and -1 infers, as Reshape
        return mx.sym.Reshape(data=inputs[0], name=name,
                              shape=tuple(int(d) for d in p.shape.dim))
    if t == "Softmax":
        # a softmax inside the graph is an activation (its Jacobian in
        # the backward); a loss head is SoftmaxWithLoss
        return mx.sym.SoftmaxActivation(data=inputs[0], name=name)
    if t == "SoftmaxWithLoss":
        return mx.sym.SoftmaxOutput(data=inputs[0], name=name)
    raise ValueError("unsupported Caffe layer type %r (layer %r)"
                     % (t, name))


# weight-blob counts by layer type, where knowable (the reference CaffeOp's
# num_weight declares how many trailing inputs are parameters)
_KNOWN_NUM_WEIGHT = {
    "Convolution": lambda lay: 2 if lay.convolution_param.bias_term else 1,
    "Deconvolution": lambda lay: 2 if lay.convolution_param.bias_term
    else 1,
    "InnerProduct": lambda lay: 2 if lay.inner_product_param.bias_term
    else 1,
    "ReLU": lambda lay: 0, "Sigmoid": lambda lay: 0,
    "TanH": lambda lay: 0, "Pooling": lambda lay: 0,
    "LRN": lambda lay: 0, "Dropout": lambda lay: 0,
    "Concat": lambda lay: 0, "Eltwise": lambda lay: 0,
    "Flatten": lambda lay: 0, "Reshape": lambda lay: 0,
    "Softmax": lambda lay: 0,
}


def CaffeOp(*data, prototxt="layer{}", num_data=1, num_weight=0,
            num_out=1, name=None, **kwargs):
    """The port's symbol for a Caffe layer prototxt.

    ``data`` (positional or ``data_0``..``data_N`` keywords): the input
    symbols. ``num_weight``/``num_out`` are the reference's parameters;
    ``num_weight`` is checked against the layer type's parameter count
    where it is known."""
    import mxnet_tpu_torch as mx

    lay = parse_layer(prototxt)
    inputs = list(data)
    for i in range(num_data):
        key = "data_%d" % i
        if key in kwargs:
            inputs.append(kwargs.pop(key))
    if not inputs:
        raise ValueError("CaffeOp needs at least one input symbol")
    if num_out != 1:
        raise ValueError("only single-output Caffe layers are supported")
    t = lay.type
    if not t:
        raise ValueError("prototxt must set layer type")
    want = _KNOWN_NUM_WEIGHT.get(t)
    if want is not None and num_weight not in (0, want(lay)):
        raise ValueError(
            "num_weight=%d but a %s layer with this prototxt has %d "
            "parameter blobs" % (num_weight, t, want(lay)))
    return build_layer(mx, lay, inputs, name=name or lay.name or None)


def CaffeLoss(data, label, prototxt='layer{type:"SoftmaxWithLoss"}',
              num_data=2, num_out=1, grad_scale=1.0, name=None):
    """A Caffe loss layer -> the port's loss symbol (SoftmaxWithLoss
    only)."""
    import mxnet_tpu_torch as mx

    lay = parse_layer(prototxt)
    t = lay.type or "SoftmaxWithLoss"
    if t != "SoftmaxWithLoss":
        raise ValueError("CaffeLoss supports SoftmaxWithLoss, got %r" % t)
    return mx.sym.SoftmaxOutput(data=data, label=label,
                                grad_scale=grad_scale,
                                name=name or "softmax")
