"""Parameter naming and the structural digest checkpoints and serving
share (the port's copy of ``pack_params`` from
``mxnet_tpu/checkpoint/__init__.py`` and ``params_digest`` from
``mxnet_tpu/checkpoint/serialize.py``). The same inputs give the same
hex digest in both packages.
"""
from __future__ import annotations

import hashlib

import numpy as onp
import torch

__all__ = ["pack_params", "params_digest"]


def pack_params(arg_params, aux_params):
    """Flatten (arg_params, aux_params) into one ``arg:``/``aux:``
    prefixed dict — the name-packing every checkpoint format shares."""
    packed = {("arg:%s" % k): v for k, v in (arg_params or {}).items()}
    packed.update({("aux:%s" % k): v
                   for k, v in (aux_params or {}).items()})
    return packed


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return onp.dtype(dtype).name


def params_digest(symbol_json, arrays):
    """Structural identity of a (symbol, parameter set) pair: sha256
    over the symbol JSON plus every array's canonical
    ``name|shape|dtype`` line, sorted by name. Parameter VALUES do not
    enter it: two checkpoints of one architecture share a digest, and
    any drift in layer widths, parameter set or dtype changes it.

    ``arrays`` maps name -> anything with ``shape``/``dtype`` (NDArray,
    tensor, numpy). Scalars hash as shape ``()``.
    """
    h = hashlib.sha256()
    h.update(str(symbol_json).encode("utf-8"))
    for name in sorted(arrays):
        v = arrays[name]
        shape = tuple(getattr(v, "shape", ()))
        dtype = _dtype_name(getattr(v, "dtype", onp.float32))
        h.update(("\n%s|%s|%s" % (name, shape, dtype)).encode("utf-8"))
    return h.hexdigest()
