"""Carry parameters from the JAX package into the port, so both compute
from identical weights.

Torch's and JAX's generators draw different numbers from one seed, so the
port never re-derives the reference's weights: it takes its values, either
as numpy dicts (``params_from_numpy``) or from a checkpoint pair the JAX
package wrote (``load_jax_checkpoint``; both packages share the
``prefix-symbol.json`` and npz ``prefix-%04d.params`` formats).
"""
from __future__ import annotations

from . import ndarray as nd
from .model import load_checkpoint

__all__ = ["params_from_numpy", "load_jax_checkpoint"]


def params_from_numpy(arg_params, aux_params, ctx):
    """Dicts of numpy arrays -> dicts of NDArrays on ``ctx``, dtypes kept."""
    def conv(d):
        return {k: nd.array(v, ctx=ctx, dtype=v.dtype)
                for k, v in (d or {}).items()}
    return conv(arg_params), conv(aux_params)


def load_jax_checkpoint(prefix, epoch, ctx):
    """(symbol, arg_params, aux_params) of a checkpoint the JAX package
    saved (``mxnet_tpu.model.save_checkpoint``), arrays on ``ctx``."""
    return load_checkpoint(prefix, epoch, ctx=ctx)
