"""Elementwise operators (PyTorch counterpart of
``mxnet_tpu/ops/elemwise.py``): the unary math, the binary ops and their
scalar forms (``Symbol`` arithmetic emits ``_plus``, ``_mul_scalar``,
...), the comparisons (1.0 / 0.0 in the input's dtype), ``clip``,
``smooth_l1``, ``BlockGrad``, ``add_n``, the dtype cast and the row
helpers of the legacy NDArray functions.

Each op is the PyTorch op of the JAX package's jnp expression, with
its semantics kept where the two libraries differ: ``_mod`` is a
floor-mod (``jnp.mod``: ``torch.remainder``, not ``torch.fmod``),
``gamma`` is ``exp(gammaln(x))`` with no sign, ``round`` rounds half to
even, ``fix`` truncates, and a scalar operand takes the tensor's dtype.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..registry import register


def _unary(name, fn, alias=()):
    @register(name, alias=alias)
    def _f(attrs, ins, octx):
        return [fn(ins[0])]
    _f.__doc__ = "Elementwise %s." % name
    return _f


_UNARY_TABLE = {
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,           # half to even, as jnp.round
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "relu": lambda x: torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)),
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.neg,
    # no sign: exp(gammaln(x)), as the JAX package computes it
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
}

for _name, _fn in _UNARY_TABLE.items():
    _unary(_name, _fn)

_unary("identity", lambda x: x, alias=("_copy",))


@register("BlockGrad", alias=("stop_gradient",))
def _block_grad(attrs, ins, octx):
    """Identity forward, zero gradient."""
    return [ins[0].detach()]


@register("Cast", alias=("cast",), attr_types={"dtype": str})
def _cast(attrs, ins, octx):
    """Cast to ``dtype``."""
    return [ins[0].to(torch_dtype(attrs["dtype"]))]


@register("clip", attr_types={"a_min": float, "a_max": float})
def _clip(attrs, ins, octx):
    """Clip values to [a_min, a_max]."""
    return [torch.clamp(ins[0], float(attrs["a_min"]),
                        float(attrs["a_max"]))]


@register("smooth_l1", attr_types={"scalar": float})
def _smooth_l1(attrs, ins, octx):
    """0.5·σ²·x² where |x| < 1/σ², else |x| − 0.5/σ² (σ = ``scalar``)."""
    sigma2 = float(attrs.get("scalar", 1.0)) ** 2
    x = ins[0]
    return [torch.where(torch.abs(x) < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                        torch.abs(x) - 0.5 / sigma2)]


# -- binary elementwise -----------------------------------------------------
def _binary(name, fn, alias=()):
    @register(name, arg_names=("lhs", "rhs"), alias=alias)
    def _f(attrs, ins, octx):
        return [fn(ins[0], ins[1])]
    _f.__doc__ = "Elementwise %s." % name.lstrip("_")
    return _f


def _cmp(fn):
    """A comparison as 1.0 / 0.0 in the left operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


BINARY = {
    "_plus": (lambda a, b: a + b, ("elemwise_add", "_add", "_grad_add")),
    "_minus": (lambda a, b: a - b, ("elemwise_sub", "_sub")),
    "_mul": (lambda a, b: a * b, ("elemwise_mul",)),
    "_div": (lambda a, b: a / b, ("elemwise_div",)),
    "_mod": (torch.remainder, ()),          # floor-mod, as jnp.mod
    "_power": (torch.pow, ("pow",)),
    "_maximum": (torch.maximum, ()),
    "_minimum": (torch.minimum, ()),
    "_hypot": (torch.hypot, ()),
    "_equal": (_cmp(torch.eq), ()),
    "_not_equal": (_cmp(torch.ne), ()),
    "_greater": (_cmp(torch.gt), ()),
    "_greater_equal": (_cmp(torch.ge), ()),
    "_lesser": (_cmp(torch.lt), ()),
    "_lesser_equal": (_cmp(torch.le), ()),
}

for _name, (_fn, _alias) in BINARY.items():
    _binary(_name, _fn, _alias)


# -- binary with scalar -----------------------------------------------------
def _scalar(name, fn):
    @register(name, attr_types={"scalar": float})
    def _f(attrs, ins, octx):
        x = ins[0]
        # the scalar rounded to the tensor's dtype, as the JAX package
        # casts it (on the host: no copy to the device)
        s = float(torch.tensor(float(attrs.get("scalar", 0.0)),
                               dtype=x.dtype))
        return [fn(x, s)]
    _f.__doc__ = "Elementwise %s with the attr ``scalar``." % name.lstrip("_")
    return _f


def _vs(fn):
    """``fn`` of a tensor and a scalar made a 0-d tensor on the device."""
    return lambda a, s: fn(a, torch.full((), s, dtype=a.dtype,
                                         device=a.device))


SCALAR = {
    "_plus_scalar": lambda a, s: a + s,
    "_minus_scalar": lambda a, s: a - s,
    "_rminus_scalar": lambda a, s: s - a,
    "_mul_scalar": lambda a, s: a * s,
    "_div_scalar": lambda a, s: a / s,
    "_rdiv_scalar": lambda a, s: s / a,
    "_mod_scalar": torch.remainder,
    "_rmod_scalar": _vs(lambda a, s: torch.remainder(s, a)),
    "_power_scalar": torch.pow,
    "_rpower_scalar": lambda a, s: torch.pow(s, a),
    "_maximum_scalar": _vs(torch.maximum),
    "_minimum_scalar": _vs(torch.minimum),
    "_hypot_scalar": _vs(torch.hypot),
    "_equal_scalar": _cmp(torch.eq),
    "_not_equal_scalar": _cmp(torch.ne),
    "_greater_scalar": _cmp(torch.gt),
    "_greater_equal_scalar": _cmp(torch.ge),
    "_lesser_scalar": _cmp(torch.lt),
    "_lesser_equal_scalar": _cmp(torch.le),
}

for _name, _fn in SCALAR.items():
    _scalar(_name, _fn)


@register("add_n", variable_args="num_args", alias=("ElementWiseSum", "_sum"))
def _add_n(attrs, ins, octx):
    """The sum of the inputs, added left to right."""
    out = ins[0]
    for x in ins[1:]:
        out = out + x
    return [out]


@register("_identity_with_attr_like_rhs", arg_names=("lhs", "rhs"))
def _identity_like_rhs(attrs, ins, octx):
    """``lhs`` passed through (the gradient-aggregation helper)."""
    return [ins[0]]


@register("_NoGradient", arg_names=())
def _no_gradient(attrs, ins, octx):
    """The "no gradient flows here" placeholder: a zero of shape (1,)."""
    return [torch.zeros((1,), dtype=torch.float32, device=octx.device)]


@register("_CrossDeviceCopy")
def _cross_device_copy(attrs, ins, octx):
    """The device-boundary copy of model-parallel graphs: the identity on
    one device (``NDArray.copyto`` moves arrays between devices)."""
    return [ins[0]]


def _row_index(rhs, lhs):
    """``rhs`` as int64 column indices into ``lhs``'s rows, clipped."""
    return torch.clamp(rhs.to(torch.int64), 0, lhs.shape[1] - 1)


@register("choose_element_0index", arg_names=("lhs", "rhs"))
def _choose_element_0index(attrs, ins, octx):
    """out[i] = lhs[i, rhs[i]]."""
    lhs, rhs = ins
    return [torch.gather(lhs, 1, _row_index(rhs, lhs)[:, None])[:, 0]]


@register("fill_element_0index", arg_names=("lhs", "mhs", "rhs"))
def _fill_element_0index(attrs, ins, octx):
    """lhs with lhs[i, rhs[i]] = mhs[i]."""
    lhs, mhs, rhs = ins
    return [torch.scatter(lhs, 1, _row_index(rhs, lhs)[:, None],
                          mhs[:, None].to(lhs.dtype))]


@register("_onehot_encode", arg_names=("indices", "out_like"))
def _onehot_encode_op(attrs, ins, octx):
    """One-hot rows, ``out_like.shape[1]`` wide, in its dtype."""
    idx, out_like = ins
    depth = out_like.shape[1]
    cols = torch.arange(depth, device=idx.device)
    return [(idx.to(torch.int64)[:, None] == cols[None, :])
            .to(out_like.dtype)]

