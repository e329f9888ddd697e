"""Device context model.

PyTorch counterpart of ``mxnet_tpu/context.py``. Every Context maps onto a
``torch.device``: ``cpu()`` -> ``cpu``, ``gpu(i)`` -> ``cuda:i``, and
``tpu(i)`` stays an alias of ``gpu(i)`` so scripts written for the JAX
package run unchanged. The default context is ``gpu(0)``: code runs on the
CPU only when the caller asks for ``cpu()``, and a gpu context on a machine
without CUDA raises instead of falling back.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context"]


class Context:
    """Device context: ``Context('gpu', 0)`` / ``mx.gpu(0)`` / ``mx.cpu()``.

    Usable as a ``with`` scope that sets the default context."""

    # dev-type codes follow the reference enum; tpu aliases gpu
    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def torch_device(self):
        """The ``torch.device`` of this context; raises for a gpu context
        when CUDA has no such device."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device and none is available; "
                "pass mx.cpu() to run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s out of range: %d CUDA device(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    """Return a CPU context (mirrors mx.cpu)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return a CUDA context."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, kept so TPU-era scripts run unchanged."""
    return Context("tpu", device_id)


def current_context():
    """The thread-local default context; ``gpu(0)`` unless a scope set one."""
    cur = getattr(Context._default_ctx, "value", None)
    return cur if cur is not None else Context("gpu", 0)
