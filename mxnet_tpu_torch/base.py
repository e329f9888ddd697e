"""Base types and helpers for mxnet_tpu_torch.

PyTorch counterpart of ``mxnet_tpu/base.py``: the error type, the version
and the dtype conversions every module of the port shares.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["MXNetError", "string_types", "numeric_types", "__version__",
           "torch_dtype", "numpy_dtype"]

__version__ = "0.9.5+torch.1"


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (mirrors mxnet.base.MXNetError)."""


string_types = (str,)
numeric_types = (float, int)

_NAMED = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, numpy dtype/type or its name.

    numpy has no bfloat16, so that type is only reachable by name or as a
    torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _NAMED:
        return _NAMED[dtype]
    name = onp.dtype(dtype).name
    if name not in _NAMED:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _NAMED[name]


def numpy_dtype(dtype):
    """The numpy type of a torch dtype (bfloat16 has none: float32)."""
    if dtype == torch.bfloat16:
        return onp.float32
    return torch.empty((), dtype=dtype).numpy().dtype.type
