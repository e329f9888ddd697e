"""NDArray — a mutable tensor on a device context.

PyTorch counterpart of ``mxnet_tpu/ndarray.py`` for the subset the first
slice of the port uses. An NDArray wraps one ``torch.Tensor``: writes go
into that tensor in place, and ``slice``/``at``/``reshape`` return views
that share its storage, as the reference's NDArray does. PyTorch's CUDA
stream already orders the work, so ``wait_to_read`` only synchronises.

``save``/``load`` use the JAX package's npz container (``__mx_format__``
plus one entry per array), so either package reads the other's files.

Every registered operator is exposed as a function of this module, as in
the JAX package (``nd.sgd_mom_update(w, g, m, out=[w, m], ...)``).
"""
from __future__ import annotations

import os
import sys

import numpy as onp
import torch

from .base import MXNetError, numeric_types, torch_dtype, numpy_dtype
from .context import Context, current_context
from . import registry as _registry

__all__ = ["NDArray", "array", "zeros", "ones", "load", "save", "waitall"]

_py_slice = slice


class NDArray:
    """Multi-dimensional mutable array on a device context."""

    __slots__ = ("_t", "_ctx")

    def __init__(self, tensor, ctx=None):
        if ctx is None:
            ctx = Context("cpu") if tensor.device.type == "cpu" else \
                Context("gpu", tensor.device.index or 0)
        self._t = tensor
        self._ctx = ctx

    # ------------------------------------------------------------------ io
    def _read(self):
        """The backing tensor (no copy)."""
        return self._t

    def _write(self, new):
        """Copy tensor ``new`` into this array in place."""
        if tuple(new.shape) != tuple(self._t.shape):
            new = new.reshape(self._t.shape)
        with torch.no_grad():
            self._t.copy_(new)

    # ------------------------------------------------------------- basics
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def size(self):
        return self._t.numel()

    @property
    def dtype(self):
        if self._t.dtype == torch.bfloat16:
            return torch.bfloat16
        return numpy_dtype(self._t.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(x) for x in self.shape),
                                     self.context)

    def __len__(self):
        return self.shape[0]

    # ------------------------------------------------------------ convert
    def asnumpy(self):
        """Copy to a host numpy array (bfloat16 comes back as float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def wait_to_read(self):
        """Block until this array's value is computed."""
        if self._t.is_cuda:
            torch.cuda.synchronize(self._t.device)

    # -------------------------------------------------------------- copy
    def copyto(self, other):
        """Copy into another NDArray or to a new array on a Context."""
        if isinstance(other, NDArray):
            if other._t is self._t:
                return other
            if tuple(other.shape) != self.shape:
                raise ValueError("array shape do not match the target %s vs %s"
                                 % (self.shape, other.shape))
            other._write(self._t)
            return other
        if isinstance(other, Context):
            return NDArray(self._t.detach().to(other.torch_device(),
                                               copy=True), ctx=other)
        raise TypeError("copyto does not support type " + str(type(other)))

    # ------------------------------------------------------------- views
    def slice(self, start, stop):
        """Axis-0 slice sharing this array's storage."""
        start, stop, _ = _py_slice(start, stop).indices(self.shape[0])
        return NDArray(self._t[start:stop], ctx=self._ctx)

    def at(self, idx):
        """View of row ``idx`` with the leading axis removed."""
        return NDArray(self._t[idx], ctx=self._ctx)

    def reshape(self, shape):
        """Shape-changing view sharing storage."""
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._t.view(tuple(shape)), ctx=self._ctx)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.at(key)
        if isinstance(key, _py_slice):
            if key.step is not None and key.step != 1:
                raise ValueError(
                    "NDArray only supports continuous slicing on axis 0")
            return self.slice(key.start, key.stop)
        raise ValueError("NDArray only supports int/slice as index")

    def __setitem__(self, key, value):
        full_slice = isinstance(key, _py_slice) and key.start is None \
            and key.stop is None and key.step is None
        view = self if full_slice else self[key]
        if isinstance(value, NDArray):
            value.copyto(view)
        elif isinstance(value, numeric_types):
            with torch.no_grad():
                view._t.fill_(value)
        elif isinstance(value, (onp.ndarray, onp.generic, list, tuple,
                                torch.Tensor)):
            src = torch.as_tensor(onp.asarray(value)) \
                if not isinstance(value, torch.Tensor) else value
            view._write(src.to(device=view._t.device, dtype=view._t.dtype))
        else:
            raise TypeError("type %s not supported" % str(type(value)))

    # ---------------------------------------------------------- operators
    def _binary(self, other, fn):
        rhs = other._t if isinstance(other, NDArray) else other
        return NDArray(fn(self._t, rhs), ctx=self._ctx)

    def _inplace(self, other, fn):
        rhs = other._t if isinstance(other, NDArray) else other
        self._write(fn(self._t, rhs))
        return self

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __iadd__(self, other):
        return self._inplace(other, torch.add)

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __isub__(self, other):
        return self._inplace(other, torch.sub)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __imul__(self, other):
        return self._inplace(other, torch.mul)

    def __truediv__(self, other):
        return self._binary(other, torch.div)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a)

    def __itruediv__(self, other):
        return self._inplace(other, torch.div)

    def __neg__(self):
        return NDArray(-self._t, ctx=self._ctx)


# ---------------------------------------------------------------------------
# imperative invoke: run a registered op on NDArrays
# ---------------------------------------------------------------------------
def invoke(op, inputs, raw_attrs, out=None):
    """Run ``op`` eagerly on NDArrays; results go to ``out`` when given.
    Ops with aux state write their aux updates back into the trailing aux
    inputs."""
    attrs = _registry.parse_attrs(op, raw_attrs)
    n_aux = len(op.aux_names)
    with torch.no_grad():
        results = op.fcompute(attrs, [x._t for x in inputs],
                              _registry.OpContext(is_train=False))
    n_out = op.num_outputs(attrs)
    outs, aux_updates = list(results[:n_out]), list(results[n_out:])
    if n_aux and aux_updates:
        for nda, new in zip(inputs[-n_aux:], aux_updates):
            nda._write(new)
    out_list = out if isinstance(out, (list, tuple)) else (
        [out] if out is not None else None)
    ctx = inputs[0].context if inputs else current_context()
    wrapped = []
    for i, o in enumerate(outs):
        if out_list is not None and i < len(out_list) \
                and out_list[i] is not None:
            out_list[i]._write(o)
            wrapped.append(out_list[i])
        else:
            wrapped.append(NDArray(o, ctx=ctx))
    return wrapped[0] if len(wrapped) == 1 else wrapped


def _make_op_func(op):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs = [a for a in args if isinstance(a, NDArray)]
        attrs = {k: v for k, v in kwargs.items()
                 if v is not None and not isinstance(v, NDArray)}
        return invoke(op, inputs, attrs, out=out)

    fn.__name__ = op.name
    fn.__doc__ = (op.fcompute.__doc__ or "") + "\n\n(op: %s)" % op.name
    return fn


def _init_ndarray_module():
    """Expose every registered op as a module-level function."""
    mod = sys.modules[__name__]
    for name in _registry.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_op_func(_registry.get_op(name)))


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _new(fill, shape, ctx, dtype):
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    t = fill(tuple(shape), dtype=torch_dtype(dtype), device=ctx.torch_device())
    return NDArray(t, ctx=ctx)


def zeros(shape, ctx=None, dtype=onp.float32):
    return _new(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=onp.float32):
    return _new(torch.ones, shape, ctx, dtype)


def array(source_array, ctx=None, dtype=onp.float32):
    """Create an NDArray from any array-like (float32 unless told)."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    src = torch.as_tensor(onp.asarray(source_array))
    return NDArray(src.to(device=ctx.torch_device(), dtype=torch_dtype(dtype)),
                   ctx=ctx)


def waitall():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# serialization — the JAX package's npz container
# ---------------------------------------------------------------------------
def save(fname, data):
    """Save a list or str->NDArray dict of NDArrays to file.

    The write is crash-atomic: content goes to ``fname + ".tmp"``, is
    fsynced, then renamed over ``fname``."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        fmt, arrs = "dict", {k: v.asnumpy() for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        fmt = "list"
        arrs = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
    else:
        raise ValueError("data needs to either be a NDArray, dict or list")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        onp.savez(f, __mx_format__=fmt, **arrs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)


def load(fname, ctx=None):
    """Load NDArrays saved by ``save`` (either package's) — a list or dict.
    ``.tmp`` files (an interrupted save) are refused."""
    if str(fname).endswith(".tmp"):
        raise MXNetError(
            "refusing to load %r: .tmp files are uncommitted partial "
            "writes left by an interrupted save" % (fname,))
    with onp.load(fname, allow_pickle=False) as npz:
        fmt = str(npz["__mx_format__"]) if "__mx_format__" in npz else "dict"
        items = {k: npz[k] for k in npz.files if k != "__mx_format__"}
    if fmt == "list":
        return [array(items["arr_%d" % i], ctx=ctx,
                      dtype=items["arr_%d" % i].dtype)
                for i in range(len(items))]
    return {k: array(v, ctx=ctx, dtype=v.dtype) for k, v in items.items()}


from . import ops as _ops  # noqa: E402,F401
_init_ndarray_module()
