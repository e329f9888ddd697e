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
import re

import numpy as onp
import torch

from .base import string_types
from . import random as _random

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "One", "Zero",
           "Constant", "Orthogonal", "MSRAPrelu", "Bilinear", "Load", "Mixed",
           "LSTMBias", "FusedRNN", "InitDesc", "register", "create"]

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
    if name.lower() == "fusedrnn" and isinstance(kwargs.get("init"), str):
        kwargs["init"] = create(kwargs["init"])
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
        (lambda n: n.startswith("upsampling"), "_init_bilinear"),
        (lambda n: n.endswith("bias"), "_init_bias"),
        (lambda n: n.endswith("gamma"), "_init_gamma"),
        (lambda n: n.endswith("beta"), "_init_beta"),
        (lambda n: n.endswith("weight"), "_init_weight"),
        (lambda n: n.endswith(("moving_mean", "running_mean")), "_init_zero"),
        (lambda n: n.endswith(("moving_var", "running_var")), "_init_one"),
        # the begin_state variables of the RNN cells
        (lambda n: "begin_state" in n or "init_state" in n
         or ("init_" in n and ("_c" in n or "_h" in n)), "_init_zero"),
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

    def _init_bilinear(self, _, arr):
        """The separable tent filter of bilinear upsampling."""
        h, w = arr.shape[2], arr.shape[3]
        f = onp.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        tent_x = 1 - onp.abs(onp.arange(w) / f - c)
        tent_y = 1 - onp.abs(onp.arange(h) / f - c)
        arr[:] = onp.broadcast_to(tent_y[:, None] * tent_x[None, :],
                                  arr.shape).astype("float32")

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
class Constant(Initializer):
    """Every value ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

    _init_default = _init_weight


@register
class Load(object):
    """Values from a dict of arrays by name, else from ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = dict(param)
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("Parameter %s shape mismatch" % name)
            arr[:] = src.asnumpy() if hasattr(src, "asnumpy") else src
        else:
            if self.default_init is None:
                raise ValueError("Cannot init %s: not found and no default"
                                 % name)
            self.default_init(name, arr)


@register
class Mixed(object):
    """The initializer of the first pattern (a regex) that matches the
    parameter's name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern."
                         % name)


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


def orthogonal_from(tmp, shape, scale):
    """``scale`` times the orthonormal factor of the SVD of the
    (nout, nin) matrix ``tmp`` that has its shape, reshaped to ``shape``
    (``Orthogonal``'s deterministic step)."""
    u, _, v = onp.linalg.svd(tmp, full_matrices=False)
    res = u if u.shape == tmp.shape else v
    return (scale * res).reshape(shape)


@register
class Orthogonal(Initializer):
    """An orthogonal matrix from the SVD of a uniform or normal draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        if self.rand_type == "uniform":
            tmp = _uniform((nout, nin), -1.0, 1.0)
        else:
            tmp = _normal((nout, nin), 1.0)
        arr[:] = orthogonal_from(tmp.numpy(), arr.shape, self.scale)


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier with magnitude 2 / (1 + slope²) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear-upsampling filter for every weight."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


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


@register
class FusedRNN(Initializer):
    """The flat parameter vector of an ``RNN`` node: each (W, R) matrix
    from ``init`` in the vector's order, then the biases at 0, an LSTM's
    two forget-gate blocks (bW and bR) at ``forget_bias``/2 each."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__(init=init.dumps() if hasattr(init, "dumps")
                         else None, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        from . import ndarray as nd
        from .context import cpu
        from .ops.rnn_op import _gates, rnn_param_size
        h = self._num_hidden
        d = 2 if self._bidirectional else 1
        g = _gates(self._mode)
        flat = torch.zeros(arr.size, dtype=torch.float32)
        # the input width is whatever makes the sizes add up
        input_size = next(
            (c for c in range(1, 100000)
             if rnn_param_size(self._num_layers, c, h, self._bidirectional,
                               self._mode) == arr.size), h)
        off = 0
        for layer in range(self._num_layers):
            in_sz = input_size if layer == 0 else h * d
            for _ in range(d):
                for rows, cols in ((g * h, in_sz), (g * h, h)):
                    block = nd.zeros((rows, cols), ctx=cpu())
                    if self._init is not None:
                        self._init("weight", block)
                    flat[off:off + rows * cols] = block._read().reshape(-1)
                    off += rows * cols
        for _ in range(self._num_layers * d * 2):
            if self._mode == "lstm":
                flat[off + h:off + 2 * h] = self._forget_bias / 2.0
            off += g * h
        arr[:] = flat.reshape(arr.shape)
