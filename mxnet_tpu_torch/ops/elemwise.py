"""Elementwise operators (PyTorch counterpart of
``mxnet_tpu/ops/elemwise.py``): the binary ops and their scalar forms that
``Symbol`` arithmetic emits (``+ - * /`` with a symbol or a number, unary
minus), and the dtype cast of the reduced-precision model variants."""
from __future__ import annotations

from ..base import torch_dtype
from ..registry import register


def _binary(name, fn, alias=()):
    @register(name, arg_names=("lhs", "rhs"), alias=alias)
    def _f(attrs, ins, octx):
        return [fn(ins[0], ins[1])]
    _f.__doc__ = "Elementwise %s." % name.lstrip("_")
    return _f


_binary("_plus", lambda a, b: a + b,
        alias=("elemwise_add", "_add", "_grad_add"))
_binary("_minus", lambda a, b: a - b, alias=("elemwise_sub", "_sub"))
_binary("_mul", lambda a, b: a * b, alias=("elemwise_mul",))
_binary("_div", lambda a, b: a / b, alias=("elemwise_div",))


def _scalar(name, fn):
    @register(name, attr_types={"scalar": float})
    def _f(attrs, ins, octx):
        return [fn(ins[0], float(attrs.get("scalar", 0.0)))]
    _f.__doc__ = "Elementwise %s with the attr ``scalar``." % name.lstrip("_")
    return _f


_scalar("_plus_scalar", lambda a, s: a + s)
_scalar("_minus_scalar", lambda a, s: a - s)
_scalar("_rminus_scalar", lambda a, s: s - a)
_scalar("_mul_scalar", lambda a, s: a * s)
_scalar("_div_scalar", lambda a, s: a / s)
_scalar("_rdiv_scalar", lambda a, s: s / a)


@register("Cast", alias=("cast",), attr_types={"dtype": str})
def _cast(attrs, ins, octx):
    """Cast to ``dtype``."""
    return [ins[0].to(torch_dtype(attrs["dtype"]))]
