"""Checkpoint files and the parameter update loop (PyTorch counterpart of
``mxnet_tpu/model.py``). ``prefix-symbol.json`` + ``prefix-%04d.params``
use the JAX package's formats, so either package reads the other's."""
from __future__ import annotations

from .checkpoint import load_params_file, save_params_file
from . import symbol as sym_mod

__all__ = ["save_checkpoint", "load_checkpoint"]


def _update_params(param_arrays, grad_arrays, updater):
    """Update every parameter that has a gradient, as one step of
    ``updater`` (one device: the key is the parameter's index)."""
    updater.update_multi([(index, grad_list[0], arg_list[0])
                          for index, (arg_list, grad_list)
                          in enumerate(zip(param_arrays, grad_arrays))
                          if grad_list is not None])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json and prefix-%04d.params (``arg:``/``aux:``
    prefixed names, atomic write)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_params_file("%s-%04d.params" % (prefix, epoch), arg_params,
                     aux_params)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint, arrays on ctx."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params_file(
        "%s-%04d.params" % (prefix, epoch), ctx=ctx)
    return symbol, arg_params, aux_params
