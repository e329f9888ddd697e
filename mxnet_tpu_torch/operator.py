"""Custom Python operators (PyTorch counterpart of ``mxnet_tpu/operator.py``).

The API of MXNet 0.9.5's ``mx.operator``: subclass ``CustomOp``
(``forward``/``backward`` with ``req`` and ``assign``) and
``CustomOpProp`` (``list_arguments``, ``list_outputs``, ``infer_shape``,
``create_operator``), register the property class with
``@mx.operator.register("name")``, then call ``mx.nd.Custom(...,
op_type="name")`` or ``mx.sym.Custom(...)``. ``NumpyOp``, ``NDArrayOp``
and ``NativeOp`` are aliases of ``CustomOp``.

The ``Custom`` op is a ``torch.autograd.Function``. Its forward copies the
inputs to host numpy arrays, calls the user's ``forward`` on
``_NumpyView``s of them and copies the outputs back to the inputs'
device; its backward does the same around the user's ``backward``. The
user sees numpy-backed views, never device tensors, as in the JAX
package. Each call synchronises the stream for its host copies, so a
step holding a ``Custom`` node cannot be captured in a CUDA graph.
numpy has no bfloat16: under the bf16 precision modes the host edge
casts to float32 and the results back to the inputs' dtype. A fresh
operator is created for every call, and the rematerialising evaluator
calls the user's ``forward`` again in the backward, so it must give the
same values every time it is called on the same inputs.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError
from . import registry as _registry

__all__ = ["CustomOp", "CustomOpProp", "register", "NumpyOp", "NDArrayOp",
           "NativeOp", "get_prop"]

_CUSTOM_REGISTRY = {}


class CustomOp(object):
    """Base class for Python operators."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honouring the request."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] += src
        else:
            raise ValueError("Invalid req: %s" % req)


class CustomOpProp(object):
    """Operator properties: arity, shapes and the operator factory."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under the ``op_type`` name."""

    def do_register(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_prop(op_type, kwargs=None):
    """An instance of the property class registered as ``op_type``, built
    with ``kwargs`` as strings (as the reference passes them)."""
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError("Custom op type %s is not registered" % op_type)
    str_kwargs = {k: str(v) for k, v in (kwargs or {}).items()}
    return _CUSTOM_REGISTRY[op_type](**str_kwargs)


class _NumpyView(object):
    """The array handed to a ``CustomOp``: a host numpy array with
    ``[:]`` assignment, ``+=``, ``asnumpy()``, ``shape`` and ``dtype``."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    @property
    def shape(self):
        return self.arr.shape

    @property
    def dtype(self):
        return self.arr.dtype

    def asnumpy(self):
        return self.arr

    def _host(self, v):
        if isinstance(v, _NumpyView):
            return v.arr
        if hasattr(v, "asnumpy"):
            return v.asnumpy()
        return onp.asarray(v, dtype=self.arr.dtype)

    def __getitem__(self, k):
        return self.arr[k]

    def __setitem__(self, k, v):
        self.arr[k] = self._host(v)

    def __iadd__(self, v):
        self.arr += self._host(v)
        return self


def _prop_of(attrs):
    return get_prop(attrs["op_type"],
                    {k: v for k, v in attrs.items() if k != "op_type"})


def _custom_args(attrs):
    return tuple(_prop_of(attrs).list_arguments())


def _custom_infer(attrs, in_shapes, aux):
    if any(s is None for s in in_shapes):
        return in_shapes, None, aux
    ins, outs, auxs = _prop_of(attrs).infer_shape([list(s)
                                                   for s in in_shapes])
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in auxs])


def _custom_num_outputs(attrs):
    return len(_prop_of(attrs).list_outputs())


def _to_host(t):
    """A tensor as a writable host float32-or-wider numpy array."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy().copy()


class _CustomFunction(torch.autograd.Function):
    """The host round trip of one ``Custom`` call (module docstring)."""

    @staticmethod
    def forward(ctx, call, *xs):
        prop, is_train = call
        in_shapes = [tuple(x.shape) for x in xs]
        in_np = [_to_host(x) for x in xs]
        in_dtypes = [a.dtype for a in in_np]
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        host_dtype = in_dtypes[0]
        op = prop.create_operator(None, in_shapes, in_dtypes)
        out_views = [_NumpyView(onp.zeros(tuple(s), host_dtype))
                     for s in out_shapes]
        op.forward(is_train, ["write"] * len(out_views),
                   [_NumpyView(a) for a in in_np], out_views, [])
        dev, dtype = xs[0].device, xs[0].dtype
        outs = tuple(torch.from_numpy(v.arr).to(device=dev, dtype=dtype)
                     for v in out_views)
        ctx.prop = prop
        ctx.in_meta = [(tuple(x.shape), x.dtype) for x in xs]
        ctx.save_for_backward(*(tuple(xs) + outs))
        ctx.n_in = len(xs)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_shapes = [s for s, _ in ctx.in_meta]
        in_np = [_to_host(x) for x in xs]
        op = ctx.prop.create_operator(None, in_shapes,
                                      [a.dtype for a in in_np])
        grads_np = [_to_host(g if g is not None else torch.zeros_like(o))
                    for g, o in zip(gs, outs)]
        in_grads = [_NumpyView(onp.zeros(s, a.dtype))
                    for s, a in zip(in_shapes, in_np)]
        op.backward(["write"] * len(xs),
                    [_NumpyView(g) for g in grads_np],
                    [_NumpyView(a) for a in in_np],
                    [_NumpyView(_to_host(o)) for o in outs], in_grads, [])
        dev = xs[0].device
        return (None,) + tuple(
            torch.from_numpy(v.arr).to(device=dev, dtype=dt)
            if dt.is_floating_point else None
            for v, (_, dt) in zip(in_grads, ctx.in_meta))


@_registry.register("Custom", arg_names=_custom_args,
                    num_outputs=_custom_num_outputs,
                    infer_shape=_custom_infer,
                    attr_types={"op_type": str})
def _custom_fcompute(attrs, ins, octx):
    """Run the registered Python operator ``op_type`` (host round trip)."""
    return list(_CustomFunction.apply((_prop_of(attrs), bool(octx.is_train)),
                                      *ins))


# the legacy spellings (MXNet 0.9.5 operator.py NumpyOp / NDArrayOp /
# NativeOp): the CustomOp protocol already passes numpy-backed views
NumpyOp = CustomOp
NDArrayOp = CustomOp
NativeOp = CustomOp


def _expose():
    """Make ``nd.Custom`` and ``sym.Custom`` reachable (the function
    surfaces were filled before this op was registered)."""
    from . import ndarray as _nd, symbol as _sym
    _nd._init_ndarray_module()
    _sym._init_symbol_module()


_expose()
