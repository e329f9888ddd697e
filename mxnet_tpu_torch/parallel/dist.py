"""Compatibility shim: the multi-process runtime lives in
``mxnet_tpu_torch.dist`` (as ``mxnet_tpu/parallel/dist.py`` points to
``mxnet_tpu.dist``)."""
from __future__ import annotations

from ..dist import DistRuntime, get_runtime, init_from_env  # noqa: F401

__all__ = ["DistRuntime", "get_runtime", "init_from_env"]
