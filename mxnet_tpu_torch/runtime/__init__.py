"""The native host runtime (the port's counterpart of
``mxnet_tpu/runtime/``): C++ built with ``g++`` at first use and bound
with ``ctypes`` (``_native_build``), with the numpy path of
``io_runtime`` wherever no library can be built.

* ``RecordFile`` — mmap'd RecordIO random access (``recordio.cpp``:
  one scan of the record framing at open, O(1) ``read(i)``).
* ``assemble_batch`` — uint8 HWC images -> float32 NCHW batch with
  crop, mirror, mean and std, over the images with OpenMP. It computes
  ``(x - mean) * (1 / std)``, the numpy path ``(x - mean) / std``: the
  two agree within one ulp, and the native one is the JAX package's
  bit for bit (the same source and flags).
* ``core`` — ``NativeEngine`` (the C++ dependency engine ``engine.py``
  runs on) and ``HostPool`` (pooled, 64-byte aligned host buffers).

``get_lib()`` keeps the JAX package's rule: None means the numpy path.
``native_assemblies`` counts the batches ``assemble_batch`` made with
the library.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as onp

from .. import io_runtime
from ._native_build import load_native

__all__ = ["get_lib", "RecordFile", "assemble_batch", "io_runtime",
           "native_assemblies"]

_LIB = []
_LOCK = threading.Lock()
native_assemblies = 0


def get_lib():
    """The native record/assembly library (built at first use), or None
    where it cannot be built: the numpy path then."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        lib = load_native("recordio.cpp", ("-march=native", "-fopenmp"))
        if lib is not None:
            lib.ri_open.restype = ctypes.c_void_p
            lib.ri_open.argtypes = [ctypes.c_char_p]
            lib.ri_count.restype = ctypes.c_int64
            lib.ri_count.argtypes = [ctypes.c_void_p]
            lib.ri_get.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.ri_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
            lib.ri_close.argtypes = [ctypes.c_void_p]
            lib.assemble_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
        _LIB.append(lib)
        return lib


class RecordFile(object):
    """Random-access RecordIO reader: ``len(rf)`` records, ``rf.read(i)``
    the payload bytes of record ``i`` (native; ``io_runtime``'s where
    there is no library or it cannot map the file)."""

    def __init__(self, path):
        self.path = path
        self._lib = get_lib()
        self._handle = None
        self._py = None
        if self._lib is not None:
            self._handle = self._lib.ri_open(str(path).encode())
        if not self._handle:
            self._handle = None
            self._py = io_runtime.RecordFile(path)

    def __len__(self):
        if self._handle is not None:
            return int(self._lib.ri_count(self._handle))
        return len(self._py)

    def read(self, i):
        """Record payload bytes at index i."""
        if self._handle is None:
            return self._py.read(i)
        ln = ctypes.c_int64()
        ptr = self._lib.ri_get(self._handle, int(i), ctypes.byref(ln))
        if not ptr:
            raise IndexError(i)
        return ctypes.string_at(ptr, ln.value)

    def close(self):
        if self._handle is not None:
            self._lib.ri_close(self._handle)
            self._handle = None
        if self._py is not None:
            self._py.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _ptr(a):
    return None if a is None else a.ctypes.data


def assemble_batch(images, mean=None, std=None, mirror=None, crop_yx=None,
                   out_hw=None, out=None):
    """uint8 (n, h, w, c) HWC images -> float32 (n, c, oh, ow) NCHW batch
    (``io_runtime.assemble_batch``'s arguments); ``out`` is an optional
    C-contiguous float32 staging buffer."""
    global native_assemblies
    lib = get_lib()
    if lib is None:
        return io_runtime.assemble_batch(images, mean, std, mirror,
                                         crop_yx, out_hw, out)
    images = onp.ascontiguousarray(images, dtype=onp.uint8)
    n, h, w, c = images.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    if out is not None:
        if out.shape != (n, c, oh, ow) or out.dtype != onp.float32 or \
                not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous float32 array of "
                             "shape %r" % ((n, c, oh, ow),))
    else:
        out = onp.empty((n, c, oh, ow), dtype=onp.float32)
    mean = None if mean is None else onp.ascontiguousarray(
        onp.broadcast_to(onp.asarray(mean, onp.float32), (c,)))
    std_inv = None if std is None else onp.ascontiguousarray(
        onp.broadcast_to(1.0 / onp.asarray(std), (c,)), dtype=onp.float32)
    mirror = None if mirror is None else onp.ascontiguousarray(
        mirror, dtype=onp.uint8)
    cy = cx = None
    if crop_yx is not None:
        cy = onp.ascontiguousarray(crop_yx[0], dtype=onp.int32)
        cx = onp.ascontiguousarray(crop_yx[1], dtype=onp.int32)
    lib.assemble_batch(images.ctypes.data, n, h, w, c, _ptr(mean),
                       _ptr(std_inv), _ptr(mirror), _ptr(cy), _ptr(cx),
                       oh, ow, out.ctypes.data)
    native_assemblies += 1
    return out
