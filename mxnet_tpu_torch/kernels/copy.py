"""Pure copy for Hopper: a CUDA C++ kernel (``csrc/copy.cu``) beside its
plain PyTorch version.

What it replaces: ``k_copy`` of ``copy_sweep`` (``tools/bn_pallas_probe.py
:288``, ``pl.pallas_call`` at ``:331``), a zero-compute copy that measured
how fast a kernel can stream memory on the TPU. On the card it measures
the copy rate that bounds every streaming kernel of the port (the
``bn_probe`` tool and ``chip_smoke.py`` report it as the measured copy
roofline).

What bounds it: bytes, read once and written once. The kernel moves
16-byte vectors (``uint4``), neighbouring threads on neighbouring vectors;
``tile_bytes`` (16, 64 or 256) is how many bytes each thread has in flight
per iteration, and a block of 256 threads copies one tile of
256·``tile_bytes`` bytes. The bytes past the last whole vector are copied
one by one. The TPU kernel's column blocks served VMEM and are not kept.

Build: ``kernels/build.py`` compiles the source with ``nvcc`` for
``sm_90a`` into ``build/cuda/mxnet_tpu_torch_copy`` at first use. The
source has a plain C interface and includes no PyTorch header, so the
build takes seconds; the library is called through ``ctypes``.

Dispatch: ``copy`` runs the plain version, ``out.copy_(x)``, only for
tensors on the CPU; that is also the one PyTorch call that computes the
same function. CUDA tensors launch the kernel or raise; nothing falls
back. ``copy.launches`` counts launches, never plain runs.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .build import cuda_library

__all__ = ["copy", "copy_plain", "check_copy", "plan", "TILE_BYTES",
           "THREADS"]

TILE_BYTES = (16, 64, 256)   # bytes per thread per iteration
THREADS = 256
_VEC = 16                    # bytes of one uint4
_LIB = []    # the loaded library, once built


def plan(n_bytes, tile_bytes):
    """(vectors, tail bytes, blocks) of a copy of ``n_bytes`` at
    ``tile_bytes`` per thread per iteration."""
    if tile_bytes not in TILE_BYTES:
        raise MXNetError("copy: tile_bytes must be one of %s, not %r"
                         % (TILE_BYTES, tile_bytes))
    n_vec, tail = divmod(n_bytes, _VEC)
    per_block = THREADS * (tile_bytes // _VEC)
    return n_vec, tail, max(1, -(-n_vec // per_block))


def check_copy(x, out):
    """Raise unless ``x`` and ``out`` are contiguous tensors of one shape
    and dtype on one device, both 16-byte aligned. Reads only tensor
    metadata, so it runs without a card."""
    if out.shape != x.shape or out.dtype != x.dtype \
            or out.device != x.device:
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
    lib.mx_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_void_p]
    lib.mx_copy.restype = ctypes.c_int
    _LIB.append(lib)
    return lib


def copy(x, out=None, tile_bytes=64):
    """Copy ``x`` into ``out`` (a new contiguous tensor when None) and
    return ``out``."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.device.type == "cpu" and out.device.type == "cpu":
        return copy_plain(x, out)
    if x.device.type != "cuda":
        raise MXNetError("copy: tensors on %s are not supported" % x.device)
    check_copy(x, out)
    n_bytes = x.numel() * x.element_size()
    if n_bytes == 0:
        return out
    _, _, grid = plan(n_bytes, tile_bytes)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mx_copy(x.data_ptr(), out.data_ptr(), n_bytes,
                          tile_bytes // _VEC, grid, stream)
    if err:
        raise MXNetError("copy: kernel launch failed with CUDA error %d"
                         % err)
    copy.launches += 1
    return out


copy.launches = 0
