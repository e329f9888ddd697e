"""Checkpoint files and the parameter update loop (PyTorch counterpart of
``mxnet_tpu/model.py``). ``prefix-symbol.json`` + ``prefix-%04d.params``
use the JAX package's formats, so either package reads the other's."""
from __future__ import annotations

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["save_checkpoint", "load_checkpoint"]


def _update_params(param_arrays, grad_arrays, updater):
    """Update every parameter that has a gradient through ``updater``
    (one device: the key is the parameter's index)."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                       grad_arrays)):
        if grad_list is not None:
            updater(index, grad_list[0], arg_list[0])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json and prefix-%04d.params (``arg:``/``aux:``
    prefixed names, atomic write)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    packed = {("arg:%s" % k): v for k, v in arg_params.items()}
    packed.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), packed)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint, arrays on ctx."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx).items():
        kind, _, name = k.partition(":")
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid checkpoint param key %r "
                             "(want arg:/aux: prefix)" % (k,))
    return symbol, arg_params, aux_params
