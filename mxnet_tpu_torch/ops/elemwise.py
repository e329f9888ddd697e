"""Elementwise operators (PyTorch counterpart of
``mxnet_tpu/ops/elemwise.py``): the add that ``Symbol.__add__`` emits and
the dtype cast of the reduced-precision model variants."""
from __future__ import annotations

from ..base import torch_dtype
from ..registry import register


@register("_plus", arg_names=("lhs", "rhs"),
          alias=("elemwise_add", "_add", "_grad_add"))
def _plus(attrs, ins, octx):
    """Elementwise lhs + rhs."""
    return [ins[0] + ins[1]]


@register("Cast", alias=("cast",), attr_types={"dtype": str})
def _cast(attrs, ins, octx):
    """Cast to ``dtype``."""
    return [ins[0].to(torch_dtype(attrs["dtype"]))]
