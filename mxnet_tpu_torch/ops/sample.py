"""Random sampling operators (PyTorch counterpart of
``mxnet_tpu/ops/sample.py``): uniform, normal, gamma, exponential,
Poisson, negative binomial, generalized negative binomial and randint,
each under its ``_random_*``, ``random_*`` and ``_sample_*`` names.

They are ``needs_rng`` ops on the port's key path: in a graph the
executor hands each its node's key (``random.fold_in`` of the forward's
key); an imperative ``nd`` call draws one from ``random.next_key``; an
eval forward, which hands out no keys, draws one the same way. Uniform,
normal and exponential draws are counter hashes of the key
(``random.key_uniform``/``key_normal``), the same bits on the CPU and
the card; gamma, Poisson, the binomials and randint draw through a
``torch.Generator`` seeded from the key (``random.key_generator``),
which repeats bit for bit on one device. No draw equals JAX's threefry:
what holds across the packages is each distribution's semantics.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import torch_dtype
from ..registry import register

_COMMON = {"shape": tuple, "dtype": str}


def _shape_of(attrs):
    shape = attrs.get("shape", (1,))
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _shape_infer(attrs, in_shapes, aux):
    return in_shapes, [_shape_of(attrs)], aux


def _sample(name, fn, extra_attrs, alias=()):
    attr_types = dict(_COMMON)
    attr_types.update(extra_attrs)

    @register(name, arg_names=(), attr_types=attr_types, needs_rng=True,
              infer_shape=_shape_infer, alias=alias)
    def _f(attrs, ins, octx):
        key = octx.key if octx.key is not None else _random.next_key()
        out = fn(key, _shape_of(attrs), octx.device, attrs)
        return [out.to(torch_dtype(attrs.get("dtype") or "float32"))]
    _f.__doc__ = fn.__doc__
    return _f


def _uniform(key, shape, device, a):
    """Samples from U[low, high)."""
    lo, hi = float(a.get("low", 0.0)), float(a.get("high", 1.0))
    return _random.key_uniform(key, shape, device) * (hi - lo) + lo


def _normal(key, shape, device, a):
    """Samples from N(loc, scale²)."""
    z = _random.key_normal(key, shape, device)
    return float(a.get("scale", 1.0)) * z + float(a.get("loc", 0.0))


def _gamma_draw(gen, alpha, shape, device):
    """Gamma(alpha, 1) samples."""
    conc = torch.full(shape, float(alpha), dtype=torch.float32,
                      device=device)
    return torch._standard_gamma(conc, generator=gen)


def _gamma(key, shape, device, a):
    """Samples from Gamma(alpha, scale=beta)."""
    gen = _random.key_generator(key, device)
    return float(a.get("beta", 1.0)) * _gamma_draw(
        gen, float(a.get("alpha", 1.0)), shape, device)


def _exponential(key, shape, device, a):
    """Samples from Exp(lam): −log(1 − u)/lam."""
    u = _random.key_uniform(key, shape, device)
    return -torch.log1p(-u) / float(a.get("lam", 1.0))


def _poisson_draw(gen, lam, shape, device):
    """Poisson samples of rate ``lam``, a number or a tensor of rates."""
    rate = lam if isinstance(lam, torch.Tensor) else \
        torch.full(shape, float(lam), dtype=torch.float32, device=device)
    return torch.poisson(rate, generator=gen)


def _poisson(key, shape, device, a):
    """Samples from Poisson(lam)."""
    return _poisson_draw(_random.key_generator(key, device),
                         float(a.get("lam", 1.0)), shape, device)


def _negative_binomial(key, shape, device, a):
    """Failures before the k-th success at success probability p: a
    Poisson of a Gamma(k, (1 − p)/p) rate."""
    k, p = int(a.get("k", 1)), float(a.get("p", 0.5))
    gen = _random.key_generator(key, device)
    lam = _gamma_draw(gen, k, shape, device) * ((1 - p) / p)
    return _poisson_draw(gen, lam, shape, device)


def _gen_negative_binomial(key, shape, device, a):
    """The gamma-Poisson mixture of mean mu and dispersion alpha
    (Poisson(mu) when alpha <= 0)."""
    mu, alpha = float(a.get("mu", 1.0)), float(a.get("alpha", 1.0))
    gen = _random.key_generator(key, device)
    if alpha <= 0:
        return _poisson_draw(gen, mu, shape, device)
    lam = _gamma_draw(gen, 1.0 / alpha, shape, device) * (mu * alpha)
    return _poisson_draw(gen, lam, shape, device)


def _randint(key, shape, device, a):
    """Integers uniform in [low, high)."""
    return torch.randint(int(a.get("low", 0)), int(a.get("high", 2)), shape,
                         generator=_random.key_generator(key, device),
                         device=device)


_sample("_random_uniform", _uniform, {"low": float, "high": float},
        alias=("uniform", "random_uniform", "_sample_uniform"))
_sample("_random_normal", _normal, {"loc": float, "scale": float},
        alias=("normal", "random_normal", "_sample_normal"))
_sample("_random_gamma", _gamma, {"alpha": float, "beta": float},
        alias=("random_gamma", "_sample_gamma"))
_sample("_random_exponential", _exponential, {"lam": float},
        alias=("random_exponential", "_sample_exponential"))
_sample("_random_poisson", _poisson, {"lam": float},
        alias=("random_poisson", "_sample_poisson"))
_sample("_random_negative_binomial", _negative_binomial,
        {"k": int, "p": float},
        alias=("random_negative_binomial", "_sample_negbinomial"))
_sample("_random_generalized_negative_binomial", _gen_negative_binomial,
        {"mu": float, "alpha": float},
        alias=("random_generalized_negative_binomial",
               "_sample_gennegbinomial"))
_sample("random_randint", _randint, {"low": int, "high": int})
