"""Pure copy for Hopper: the streaming engine's copy (``csrc/copy.cu`` on
``csrc/stream.cuh``) beside its plain PyTorch version.

What it replaces: ``k_copy`` of ``copy_sweep`` (``tools/bn_pallas_probe.py
:288``, ``pl.pallas_call`` at ``:331``), a zero-compute copy that measured
how fast a kernel can stream memory on the TPU. On the card it measures
the copy rate that bounds every streaming kernel of the port (the
``bn_probe`` tool and ``chip_smoke.py`` report it as the measured copy
roofline), on the same engine that runs the rtc bodies.

What bounds it: bytes, read once and written once. The kernel is the
engine's pass over 16-byte vectors with streaming loads and stores, each
thread taking ``unroll`` vectors a round, every load before the first
store; ``COPY_SWEEP`` lists the vectors per thread the probe times (16,
64 and 256 bytes in flight per thread). The bytes past the last whole 16
are copied one by one. The TPU kernel's column blocks served VMEM and
are not kept.

Build: ``kernels/build.py`` compiles the source with ``nvcc`` for
``sm_90a`` into ``build/cuda/mxnet_tpu_torch_copy`` at first use
(seconds); the library is called through ``ctypes``, one call per copy,
with the plan packed once per (bytes, configuration). The C entry makes
the tensors' device current for the launch.

Dispatch: ``copy`` runs the plain version, ``out.copy_(x)``, only for
tensors on the CPU; that is also the one PyTorch call that computes the
same function. CUDA tensors launch the kernel or raise; nothing falls
back. ``copy.launches`` counts launches, never plain runs.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import stream
from .build import cuda_library

__all__ = ["copy", "copy_plain", "check_copy", "plan", "COPY_SWEEP",
           "UNROLL"]

COPY_SWEEP = stream.COPY_UNROLLS   # vectors per thread the probe sweeps
UNROLL = 1                         # the default
_VEC = 16
_LIB = []      # the loaded library, once built
_PLANS = {}    # (bytes, unroll) -> address of the packed plan


def plan(n_bytes, unroll=UNROLL):
    """The engine's plan (``stream.Plan``) of a copy of ``n_bytes``."""
    return stream.plan(n_bytes, (0, 0), 1, 1, elem_bytes=1, unroll=unroll)


def check_copy(x, out):
    """Raise unless ``x`` and ``out`` are contiguous tensors of one shape
    and dtype on one device, both 16-byte aligned. Reads only tensor
    metadata, so it runs without a card."""
    if out.shape != x.shape or out.dtype is not x.dtype \
            or out.get_device() != x.get_device() \
            or (x.get_device() < 0 and out.device != x.device):
        raise MXNetError("copy: out must match x (%s %s on %s); got %s %s "
                         "on %s" % (tuple(x.shape), x.dtype, x.device,
                                    tuple(out.shape), out.dtype, out.device))
    for name, t in (("x", x), ("out", out)):
        if not t.is_contiguous():
            raise MXNetError("copy: %s is not contiguous" % name)
        if t.data_ptr() % _VEC:
            raise MXNetError("copy: %s is not 16-byte aligned (address "
                             "%#x)" % (name, t.data_ptr()))


def copy_plain(x, out):
    """Plain PyTorch version (and the library call): ``out.copy_(x)``."""
    return out.copy_(x)


def _library():
    """Build (once per process) and load the kernel's shared library."""
    if _LIB:
        return _LIB[0]
    lib = cuda_library("mxnet_tpu_torch_copy", "copy.cu")
    P = ctypes.c_void_p
    lib.mx_copy.argtypes = [P, P, ctypes.c_longlong, P, ctypes.c_int, P]
    lib.mx_copy.restype = ctypes.c_int
    _LIB.append(lib)
    return lib


_ARRAYS = []   # the packed plans, kept alive


def _packed(n_bytes, unroll):
    """The address of the packed plan of the key (``_PLANS``), made on
    first use."""
    packed = plan(n_bytes, unroll).packed()
    arr = (ctypes.c_longlong * len(packed))(*packed)
    _ARRAYS.append(arr)
    addr = _PLANS[(n_bytes, unroll)] = ctypes.addressof(arr)
    return addr


def copy(x, out=None, unroll=UNROLL):
    """Copy ``x`` into ``out`` (a new contiguous tensor when None) and
    return ``out``, with ``unroll`` vectors per thread a round
    (``COPY_SWEEP``)."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if not x.is_cuda:
        if x.device.type == "cpu" and out.device.type == "cpu":
            return copy_plain(x, out)
        raise MXNetError("copy: tensors on %s are not supported" % x.device)
    check_copy(x, out)
    n_bytes = x.numel() * x.element_size()
    if n_bytes == 0:
        return out
    lib = _LIB[0] if _LIB else _library()
    packed = _PLANS.get((n_bytes, unroll)) or _packed(n_bytes, unroll)
    dev = x.get_device()
    err = lib.mx_copy(x.data_ptr(), out.data_ptr(), n_bytes, packed, dev,
                      torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise MXNetError("copy: kernel launch failed with CUDA error %d"
                         % err)
    copy.launches += 1
    return out


copy.launches = 0
