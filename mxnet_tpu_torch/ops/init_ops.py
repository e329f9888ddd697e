"""Creation operators (PyTorch counterpart of
``mxnet_tpu/ops/init_ops.py``): ``_zeros``/``_ones``/``_full`` of a
shape, ``_arange`` and the ``*_like`` ops. The input-free ones create
their output on the graph's device (``octx.device``)."""
from __future__ import annotations

import numpy as onp
import torch

from ..base import torch_dtype
from ..registry import register


def _shape(attrs):
    shape = attrs.get("shape", ())
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _shape_infer(attrs, ins, aux):
    return ins, [_shape(attrs)], aux


def _filled(name, value, doc, alias=(), extra=None):
    attr_types = {"shape": tuple, "dtype": str}
    attr_types.update(extra or {})

    @register(name, arg_names=(), attr_types=attr_types,
              infer_shape=_shape_infer, alias=alias)
    def _f(attrs, ins, octx):
        return [torch.full(_shape(attrs), value(attrs),
                           dtype=torch_dtype(attrs.get("dtype", "float32")),
                           device=octx.device)]
    _f.__doc__ = doc + " of ``shape`` and ``dtype`` (float32) on the " \
        "graph's device."
    return _f


_filled("_zeros", lambda a: 0.0, "Zeros", alias=("zeros",))
_filled("_ones", lambda a: 1.0, "Ones", alias=("ones",))
_filled("_full", lambda a: float(a.get("value", 0.0)), "``value``",
        extra={"value": float})


def _arange_values(attrs):
    """numpy's arange of the attrs in ``dtype``, each value repeated."""
    start = float(attrs.get("start", 0.0))
    stop = attrs.get("stop", None)
    if stop is None:
        start, stop = 0.0, start
    vals = onp.arange(start, float(stop), float(attrs.get("step", 1.0)),
                      dtype=onp.dtype(attrs.get("dtype", "float32")))
    repeat = int(attrs.get("repeat", 1))
    return onp.repeat(vals, repeat) if repeat != 1 else vals


@register("_arange", arg_names=(),
          attr_types={"start": float, "stop": float, "step": float,
                      "repeat": int, "dtype": str},
          infer_shape=lambda attrs, ins, aux: (
              ins, [(len(_arange_values(attrs)),)], aux),
          alias=("arange_op",))
def _arange(attrs, ins, octx):
    """Evenly spaced values in [start, stop) (``stop`` None: [0, start)),
    each ``repeat`` times."""
    return [torch.from_numpy(_arange_values(attrs)).to(octx.device)]


@register("zeros_like")
def _zeros_like(attrs, ins, octx):
    """Zeros of the input's shape and dtype."""
    return [torch.zeros_like(ins[0])]


@register("ones_like")
def _ones_like(attrs, ins, octx):
    """Ones of the input's shape and dtype."""
    return [torch.ones_like(ins[0])]
