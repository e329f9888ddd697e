"""Reductions (PyTorch counterpart of the reductions of
``mxnet_tpu/ops/broadcast.py``): sum, mean, max, min with ``axis`` and
``keepdims``, the 2-norm and argmax, behind the NDArray methods of the
same names and ``Monitor``'s default statistic."""
from __future__ import annotations

import torch

from ..registry import register


def _axes(attrs, ndim):
    axis = attrs.get("axis")
    if axis is None or axis == ():
        return None
    if isinstance(axis, (int, float)):
        axis = (int(axis),)
    return tuple(int(a) % ndim for a in axis)


def _reduce(name, fn, alias=()):
    @register(name, attr_types={"axis": tuple, "keepdims": bool}, alias=alias)
    def _f(attrs, ins, octx):
        x = ins[0]
        axes = _axes(attrs, x.dim())
        keep = bool(attrs.get("keepdims", False))
        if axes is None:
            r = fn(x.reshape(-1), 0)
            return [r.reshape((1,) * x.dim()) if keep else r]
        return [fn(x, axes, keep)]
    return _f


_reduce("sum", lambda x, a, k=False: torch.sum(x, dim=a, keepdim=k),
        alias=("sum_axis",))
_reduce("mean", lambda x, a, k=False: torch.mean(x, dim=a, keepdim=k))
_reduce("max", lambda x, a, k=False: torch.amax(x, dim=a, keepdim=k),
        alias=("max_axis",))
_reduce("min", lambda x, a, k=False: torch.amin(x, dim=a, keepdim=k),
        alias=("min_axis",))


@register("norm")
def _norm(attrs, ins, octx):
    """The 2-norm of all elements, as shape (1,)."""
    return [torch.sqrt(torch.sum(torch.square(ins[0]))).reshape((1,))]


@register("argmax", attr_types={"axis": int, "keepdims": bool})
def _argmax(attrs, ins, octx):
    """Index of the largest element along ``axis`` (all elements when
    None, as shape (1,)), in the input's dtype."""
    x = ins[0]
    axis = attrs.get("axis")
    if axis is None:
        return [torch.argmax(x.reshape(-1)).to(x.dtype).reshape((1,))]
    return [torch.argmax(x, dim=int(axis),
                         keepdim=bool(attrs.get("keepdims", False)))
            .to(x.dtype)]
