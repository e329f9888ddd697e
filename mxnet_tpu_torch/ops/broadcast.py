"""Broadcast binary ops, ``broadcast_to``/``broadcast_axis`` and the
reductions (PyTorch counterpart of ``mxnet_tpu/ops/broadcast.py``): the
``broadcast_*`` arithmetic and comparisons (numpy broadcasting, as the
JAX package's jnp ops), sum, mean, prod, max, min, nansum, nanprod with
``axis`` and ``keepdims``, the 2-norm, argmax/argmin, ``argmax_channel``
and ``pick``. ``broadcast_mod`` is a floor-mod, as ``jnp.mod``."""
from __future__ import annotations

import torch

from ..registry import register
from .elemwise import BINARY


def _bcast(name, fn):
    @register(name, arg_names=("lhs", "rhs"))
    def _f(attrs, ins, octx):
        return [fn(ins[0], ins[1])]
    _f.__doc__ = "Broadcasting %s." % name[len("broadcast_"):]
    return _f


# every broadcast op is its elementwise op under numpy broadcasting
for _name, _op in (("add", "_plus"), ("plus", "_plus"), ("sub", "_minus"),
                   ("minus", "_minus"), ("mul", "_mul"), ("div", "_div"),
                   ("mod", "_mod"), ("power", "_power"),
                   ("maximum", "_maximum"), ("minimum", "_minimum"),
                   ("hypot", "_hypot"), ("equal", "_equal"),
                   ("not_equal", "_not_equal"), ("greater", "_greater"),
                   ("greater_equal", "_greater_equal"),
                   ("lesser", "_lesser"), ("lesser_equal", "_lesser_equal")):
    _bcast("broadcast_" + _name, BINARY[_op][0])


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


@register("broadcast_axis", attr_types={"axis": tuple, "size": tuple},
          alias=("broadcast_axes",))
def _broadcast_axis(attrs, ins, octx):
    """Broadcast the length-1 axes ``axis`` to ``size``."""
    x = ins[0]
    shape = list(x.shape)
    for ax, sz in zip(_as_tuple(attrs.get("axis", ())),
                      _as_tuple(attrs.get("size", ()))):
        shape[int(ax)] = int(sz)
    return [x.expand(tuple(shape))]


@register("broadcast_to", attr_types={"shape": tuple})
def _broadcast_to(attrs, ins, octx):
    """Broadcast to ``shape`` (0 keeps the input's dim)."""
    x = ins[0]
    tgt = [x.shape[i] if t == 0 else int(t)
           for i, t in enumerate(attrs["shape"])]
    return [x.expand(tuple(tgt))]


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _axes(attrs, ndim):
    axis = attrs.get("axis")
    if axis is None or axis == ():
        return None
    if isinstance(axis, (int, float)):
        axis = (int(axis),)
    return tuple(int(a) % ndim for a in axis)


def _prod(x, axes, keep):
    """torch.prod over several axes, last first."""
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


def _reduce(name, fn, alias=()):
    @register(name, attr_types={"axis": tuple, "keepdims": bool}, alias=alias)
    def _f(attrs, ins, octx):
        x = ins[0]
        axes = _axes(attrs, x.dim())
        keep = bool(attrs.get("keepdims", False))
        if axes is None:
            r = fn(x.reshape(-1), (0,), False)
            return [r.reshape((1,) * x.dim()) if keep else r]
        return [fn(x, axes, keep)]
    _f.__doc__ = "%s over ``axis`` (every axis when None)." % name
    return _f


_reduce("sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k),
        alias=("sum_axis",))
_reduce("mean", lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_reduce("prod", _prod)
_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
        alias=("max_axis",))
_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
        alias=("min_axis",))
_reduce("nansum", lambda x, a, k: torch.nansum(x, dim=a, keepdim=k))
_reduce("nanprod", lambda x, a, k: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), a, k))


@register("norm")
def _norm(attrs, ins, octx):
    """The 2-norm of all elements, as shape (1,)."""
    return [torch.sqrt(torch.sum(torch.square(ins[0]))).reshape((1,))]


def _arg(name, fn):
    @register(name, attr_types={"axis": int, "keepdims": bool})
    def _f(attrs, ins, octx):
        x = ins[0]
        axis = attrs.get("axis")
        if axis is None:
            return [fn(x.reshape(-1)).to(x.dtype).reshape((1,))]
        return [fn(x, dim=int(axis),
                   keepdim=bool(attrs.get("keepdims", False))).to(x.dtype)]
    _f.__doc__ = ("Index of the %s element along ``axis`` (all elements "
                  "when None, as shape (1,)), in the input's dtype."
                  % ("largest" if name == "argmax" else "smallest"))
    return _f


_arg("argmax", torch.argmax)
_arg("argmin", torch.argmin)


@register("argmax_channel")
def _argmax_channel(attrs, ins, octx):
    """argmax over the last axis, in the input's dtype."""
    x = ins[0]
    return [torch.argmax(x, dim=-1).to(x.dtype)]


def _pick_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    axis = int(attrs.get("axis", -1)) % len(data)
    idx_shape = tuple(d for i, d in enumerate(data) if i != axis)
    if in_shapes[1] is None:
        in_shapes[1] = idx_shape
    out = tuple(1 if i == axis else d for i, d in enumerate(data)) \
        if attrs.get("keepdims", False) else idx_shape
    return in_shapes, [out], aux


@register("pick", arg_names=("data", "index"),
          attr_types={"axis": int, "keepdims": bool},
          infer_shape=_pick_infer)
def _pick(attrs, ins, octx):
    """Pick one element along ``axis`` by each position's index (indices
    clipped to the axis)."""
    data, index = ins
    axis = int(attrs.get("axis", -1)) % data.dim()
    idx = torch.clamp(index.to(torch.int64), 0, data.shape[axis] - 1)
    idx = idx.reshape(data.shape[:axis] + (1,) + data.shape[axis + 1:])
    out = torch.gather(data, axis, idx)
    if not attrs.get("keepdims", False):
        out = out.squeeze(axis)
    return [out]
