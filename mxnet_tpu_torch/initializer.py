"""Weight initializers (PyTorch counterpart of ``mxnet_tpu/initializer.py``).

An Initializer is called with (name, NDArray) and dispatches on the
parameter-name suffix (``_weight``/``_bias``/``_gamma``/...), unless the
variable carries its own initializer in its ``__init__`` attribute (the
``dumps()`` JSON of one, as ``LSTMCell`` gives its i2h bias). Random
values come from the CPU generator of :mod:`.random` and are copied to
the array's device, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import json
import math

import torch

from .base import string_types
from . import random as _random

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "One", "Zero",
           "LSTMBias", "InitDesc", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    """Make an Initializer class reachable from its ``dumps()`` name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(spec):
    """An initializer from an instance or a ``dumps()`` JSON string
    (``["classname", kwargs]``)."""
    if not isinstance(spec, str):
        return spec
    name, kwargs = json.loads(spec)
    return _INIT_REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """Parameter name + attrs descriptor."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def _uniform(shape, low, high):
    g = _random.generator(torch.device("cpu"))
    return torch.rand(shape, generator=g, dtype=torch.float64) \
        * (high - low) + low


def _normal(shape, sigma):
    g = _random.generator(torch.device("cpu"))
    return torch.randn(shape, generator=g, dtype=torch.float64) * sigma


class Initializer(object):
    """Base initializer; dispatches by parameter-name convention."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``["classname", kwargs]`` as JSON, the JAX package's format."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    # first match wins, in the order of the JAX package's rules
    _NAME_RULES = (
        (lambda n: n.endswith("bias"), "_init_bias"),
        (lambda n: n.endswith("gamma"), "_init_gamma"),
        (lambda n: n.endswith("beta"), "_init_beta"),
        (lambda n: n.endswith("weight"), "_init_weight"),
        (lambda n: n.endswith(("moving_mean", "running_mean")), "_init_zero"),
        (lambda n: n.endswith(("moving_var", "running_var")), "_init_one"),
    )

    def __call__(self, name, arr):
        if not isinstance(name, string_types):
            raise TypeError("name must be string")
        attrs = getattr(name, "attrs", None)
        if attrs and attrs.get("__init__"):
            create(attrs["__init__"])._init_weight(name, arr)
            return
        for matches, handler in self._NAME_RULES:
            if matches(name):
                getattr(self, handler)(name, arr)
                return
        self._init_default(name, arr)

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr):
        raise ValueError("Unknown initialization pattern for %s." % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _uniform(arr.shape, -self.scale, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _normal(arr.shape, self.sigma)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = _uniform(shape, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = _normal(shape, scale)
        else:
            raise ValueError("Unknown random type")


@register
class LSTMBias(Initializer):
    """LSTM bias: the forget gate's quarter ``forget_bias``, the rest 0
    (gate order i, f, g, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_bias(self, _, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b

    # a variable's own __init__ dispatches through _init_weight
    _init_weight = _init_bias
