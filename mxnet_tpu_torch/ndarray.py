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

import sys

import numpy as onp
import torch

from .base import MXNetError, numeric_types, torch_dtype, numpy_dtype
from .context import Context, cpu as _cpu, current_context
from . import autograd as _autograd
from . import random as _random
from . import registry as _registry

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "onehot_encode", "load", "save", "waitall"]

_py_slice = slice


class NDArray:
    """Multi-dimensional mutable array on a device context."""

    __slots__ = ("_t", "_ctx", "writable")

    def __init__(self, tensor, ctx=None, writable=True):
        if ctx is None:
            ctx = Context("cpu") if tensor.device.type == "cpu" else \
                Context("gpu", tensor.device.index or 0)
        self._t = tensor
        self._ctx = ctx
        self.writable = writable

    # ------------------------------------------------------------------ io
    def _read(self):
        """The backing tensor (no copy)."""
        return self._t

    def _write(self, new):
        """Copy tensor ``new`` into this array in place."""
        if not self.writable:
            raise MXNetError("trying to write to a readonly NDArray")
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

    def asscalar(self):
        """The value of a one-element array as a numpy scalar."""
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype):
        """A copy converted to ``dtype``, on the same context."""
        return NDArray(self._t.detach().to(torch_dtype(dtype), copy=True),
                       ctx=self._ctx)

    def as_in_context(self, context):
        """This array if it is on ``context``, else a copy there."""
        if self.context == context:
            return self
        return self.copyto(context)

    def wait_to_read(self):
        """Block until this array's value is computed."""
        if self._t.is_cuda:
            torch.cuda.synchronize(self._t.device)

    wait_to_write = wait_to_read

    # -------------------------------------------------------------- copy
    def copy(self):
        """A new array with this one's value, on the same context."""
        return NDArray(self._t.detach().clone(), ctx=self._ctx)

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
        return NDArray(self._t[start:stop], ctx=self._ctx,
                       writable=self.writable)

    def at(self, idx):
        """View of row ``idx`` with the leading axis removed."""
        return NDArray(self._t[idx], ctx=self._ctx, writable=self.writable)

    def reshape(self, shape):
        """Shape-changing view sharing storage."""
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._t.view(tuple(shape)), ctx=self._ctx,
                       writable=self.writable)

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
        if not self.writable:
            raise MXNetError("trying to write to a readonly NDArray")
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
    # Arithmetic runs on the tensors directly; while autograd records,
    # it goes through the registered ops (``nd_op`` for two arrays,
    # ``scalar_op`` with a number), as the JAX package's always does, so
    # that it lands on the tape.
    def _binary(self, other, fn, nd_op=None, scalar_op=None):
        if _autograd.is_recording():
            return _recorded(self, other, nd_op, scalar_op)
        rhs = other._t if isinstance(other, NDArray) else other
        return NDArray(fn(self._t, rhs), ctx=self._ctx)

    def _inplace(self, other, fn, nd_op=None, scalar_op=None):
        if _autograd.is_recording():
            return _recorded(self, other, nd_op, scalar_op, out=self)
        rhs = other._t if isinstance(other, NDArray) else other
        self._write(fn(self._t, rhs))
        return self

    def __add__(self, other):
        return self._binary(other, torch.add, "broadcast_add",
                            "_plus_scalar")

    __radd__ = __add__

    def __iadd__(self, other):
        return self._inplace(other, torch.add, "broadcast_add",
                             "_plus_scalar")

    def __sub__(self, other):
        return self._binary(other, torch.sub, "broadcast_sub",
                            "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a, None,
                            "_rminus_scalar")

    def __isub__(self, other):
        return self._inplace(other, torch.sub, "broadcast_sub",
                             "_minus_scalar")

    def __mul__(self, other):
        return self._binary(other, torch.mul, "broadcast_mul",
                            "_mul_scalar")

    __rmul__ = __mul__

    def __imul__(self, other):
        return self._inplace(other, torch.mul, "broadcast_mul",
                             "_mul_scalar")

    def __truediv__(self, other):
        return self._binary(other, torch.div, "broadcast_div",
                            "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a, None,
                            "_rdiv_scalar")

    def __itruediv__(self, other):
        return self._inplace(other, torch.div, "broadcast_div",
                             "_div_scalar")

    def __neg__(self):
        if _autograd.is_recording():
            return _recorded(self, -1.0, None, "_mul_scalar")
        return NDArray(-self._t, ctx=self._ctx)

    # ------------------------------------------------- reductions, layout
    # (the registered operators of the same names, as in the JAX package)
    def sum(self, *args, **kwargs):
        return sum(self, *args, **kwargs)

    def mean(self, *args, **kwargs):
        return mean(self, *args, **kwargs)

    def max(self, *args, **kwargs):
        return max(self, *args, **kwargs)

    def min(self, *args, **kwargs):
        return min(self, *args, **kwargs)

    def argmax(self, *args, **kwargs):
        return argmax(self, *args, **kwargs)

    def transpose(self, *args, **kwargs):
        return transpose(self, *args, **kwargs)

    def flatten(self):
        return flatten(self)

    @property
    def T(self):
        return self if self.ndim <= 1 else transpose(self)


def _recorded(lhs, rhs, nd_op, scalar_op, out=None):
    """``lhs <op> rhs`` through the registered op, so autograd records it."""
    if isinstance(rhs, NDArray):
        if nd_op is None:
            raise MXNetError("operation not supported between NDArrays")
        return invoke(_registry.get_op(nd_op), [lhs, rhs], {}, out=out)
    if isinstance(rhs, numeric_types):
        return invoke(_registry.get_op(scalar_op), [lhs],
                      {"scalar": float(rhs)}, out=out)
    raise TypeError("type %s not supported" % str(type(rhs)))


# ---------------------------------------------------------------------------
# imperative invoke: run a registered op on NDArrays
# ---------------------------------------------------------------------------
def invoke(op, inputs, raw_attrs, out=None, ctx=None):
    """Run ``op`` eagerly on NDArrays; results go to ``out`` when given.
    Ops with aux state write their aux updates back into the trailing aux
    inputs. An op without inputs (``_zeros``, the samplers) runs on
    ``ctx``, else on ``out``'s context, else on the default context; a
    ``needs_rng`` op draws one key from ``random.next_key``. Under
    ``autograd.train_section`` the op runs in training mode and is
    recorded on the autograd tape."""
    attrs = _registry.parse_attrs(op, raw_attrs)
    if op.variable_args is not None and op.variable_args not in attrs:
        attrs[op.variable_args] = len(inputs)
    n_aux = len(op.aux_names)
    out_first = next((o for o in out if o is not None), None) \
        if isinstance(out, (list, tuple)) else out
    ctx = ctx or (inputs[0].context if inputs
                  else out_first.context if out_first is not None
                  else current_context())
    octx = _registry.OpContext(
        is_train=_autograd.is_training(),
        device=None if inputs else ctx.torch_device(),
        key=_random.next_key() if op.needs_rng else None)
    with torch.no_grad():
        results = op.fcompute(attrs, [x._t for x in inputs], octx)
    n_out = op.num_outputs(attrs)
    outs, aux_updates = list(results[:n_out]), list(results[n_out:])
    if n_aux and aux_updates:
        for nda, new in zip(inputs[-n_aux:], aux_updates):
            nda._write(new)
    out_list = out if isinstance(out, (list, tuple)) else (
        [out] if out is not None else None)
    wrapped = []
    for i, o in enumerate(outs):
        if out_list is not None and i < len(out_list) \
                and out_list[i] is not None:
            out_list[i]._write(o)
            wrapped.append(out_list[i])
        else:
            wrapped.append(NDArray(o, ctx=ctx))
    if _autograd.is_recording():
        _autograd.record_op(op, attrs, list(inputs), wrapped, octx)
    return wrapped[0] if len(wrapped) == 1 else wrapped


def _make_op_func(op):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        inputs = [a for a in args if isinstance(a, NDArray)]
        attrs = {k: v for k, v in kwargs.items()
                 if v is not None and not isinstance(v, NDArray)}
        named_in = {k: v for k, v in kwargs.items()
                    if isinstance(v, NDArray)}
        if named_in:
            # named inputs in the op's argument order (``lhs=``, ``data=``)
            for nm in op.list_arguments(attrs) + list(op.aux_names):
                if nm in named_in:
                    inputs.append(named_in.pop(nm))
            inputs.extend(named_in.values())
        scalars = [a for a in args if not isinstance(a, NDArray)]
        if scalars and "scalar" in op.attr_types and "scalar" not in attrs:
            attrs["scalar"] = scalars[0]
        return invoke(op, inputs, attrs, out=out, ctx=ctx)

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


def empty(shape, ctx=None, dtype=onp.float32):
    """An array of ``shape`` whose contents are not defined
    (mx.nd.empty); as in the JAX package, it holds zeros."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=onp.float32):
    """An array of ``shape`` filled with ``val``."""
    arr = zeros(shape, ctx=ctx, dtype=dtype)
    arr[:] = val
    return arr


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=onp.float32):
    """Evenly spaced values in [start, stop), each repeated ``repeat``
    times (numpy's ``arange`` in ``dtype``, as the JAX package)."""
    if stop is None:
        start, stop = 0, start
    vals = onp.arange(start, stop, step, dtype=dtype)
    if repeat != 1:
        vals = onp.repeat(vals, repeat)
    return array(vals, ctx=ctx, dtype=dtype)


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (N, depth)."""
    return invoke(_registry.get_op("_onehot_encode"), [indices, out], {},
                  out=out)


_onehot_encode = onehot_encode


def imdecode(str_img, **kwargs):
    """Decode image bytes to a float32 HWC NDArray (``io_util.imdecode``)."""
    from .io_util import imdecode as _imdecode
    return _imdecode(str_img, **kwargs)


# ---------------------------------------------------------------------------
# OpenCV-style host image ops (plugin/opencv cv_api.cc _cvimdecode/
# _cvimresize/_cvcopyMakeBorder): host work, imperative only, on cv2 where
# it imports, else PIL, as in the JAX package. They make CPU arrays.
# ---------------------------------------------------------------------------
def _cvimdecode(buf, flag=1, to_rgb=True):
    """Decode a JPEG/PNG byte buffer into an HWC uint8 CPU NDArray.
    ``flag`` follows cv::imread: 0 = grayscale (h, w), nonzero = color.
    Without cv2 and PIL it raises ``MXNetError`` naming both."""
    from .image import imdecode as _dec
    img = _dec(buf if isinstance(buf, (bytes, bytearray)) else
               buf.asnumpy().astype("uint8").tobytes(), to_rgb=to_rgb)
    if flag == 0 and img.ndim == 3:
        # ITU-R BT.601 luma — what cv::IMREAD_GRAYSCALE computes
        w = onp.array([0.299, 0.587, 0.114] if to_rgb
                      else [0.114, 0.587, 0.299], onp.float32)
        img = (img.astype(onp.float32) @ w).round().astype(img.dtype)
    return array(img, ctx=_cpu(), dtype=img.dtype)


def _cvimresize(src, w, h, interp=1):
    """Resize an HWC image NDArray to (w, h) on its context. ``interp``
    follows cv2's enums (0 = nearest, 1 = linear, ...) with cv2; PIL maps
    0 to nearest and anything else to bilinear. Without cv2 and PIL it
    raises ``MXNetError`` naming both."""
    img = src.asnumpy()
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        out = cv2.resize(img, (int(w), int(h)), interpolation=int(interp))
    else:
        try:
            from PIL import Image
        except ImportError:
            from .image import _no_decoder
            raise _no_decoder("resize")
        mode = Image.NEAREST if int(interp) == 0 else Image.BILINEAR
        out = onp.asarray(Image.fromarray(img.astype(onp.uint8)).resize(
            (int(w), int(h)), mode)).astype(img.dtype)
    return array(out, ctx=src.context, dtype=out.dtype)


def _cvcopyMakeBorder(src, top, bot, left, right, type=0, value=0.0):  # noqa: A002
    """Pad an HWC image NDArray on its context. ``type`` follows cv2's
    border enums: 0 = constant fill; the others replicate the edge."""
    img = src.asnumpy()
    if int(type) == 0:
        out = onp.full((img.shape[0] + top + bot,
                        img.shape[1] + left + right) + img.shape[2:], value,
                       dtype=img.dtype)
        out[top:top + img.shape[0], left:left + img.shape[1]] = img
    else:
        pad = [(top, bot), (left, right)] + [(0, 0)] * (img.ndim - 2)
        out = onp.pad(img, pad, mode="edge")
    return array(out, ctx=src.context, dtype=out.dtype)


def array(source_array, ctx=None, dtype=onp.float32):
    """Create an NDArray from any array-like (float32 unless told)."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    # a copy: the array never shares (possibly read-only) numpy memory
    src = torch.from_numpy(onp.array(source_array))
    return NDArray(src.to(device=ctx.torch_device(), dtype=torch_dtype(dtype)),
                   ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """Join arrays along ``axis`` on the first array's device."""
    if not arrays:
        raise ValueError("arrays must not be empty")
    dev = arrays[0]._read().device
    res = torch.cat([a._read().detach().to(dev) for a in arrays], dim=axis)
    return NDArray(res, ctx=arrays[0].context)


def waitall():
    """Block until all pending host (engine) and card work is done."""
    from . import engine as _engine
    _engine.waitall()


# ---------------------------------------------------------------------------
# serialization — the JAX package's npz container
# ---------------------------------------------------------------------------
def save(fname, data):
    """Save a list or str->NDArray dict of NDArrays to file.

    The write is crash-atomic: content goes to ``fname + ".tmp"``, is
    fsynced, then renamed over ``fname`` (``checkpoint.serialize``)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        fmt, arrs = "dict", {k: v.asnumpy() for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        fmt = "list"
        arrs = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
    else:
        raise ValueError("data needs to either be a NDArray, dict or list")
    from .checkpoint.serialize import atomic_write_stream
    atomic_write_stream(fname, lambda f: onp.savez(f, __mx_format__=fmt,
                                                   **arrs))


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
