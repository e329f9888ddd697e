"""Record reader and batch assembly (PyTorch port's counterpart of the
Python path of ``mxnet_tpu/runtime/__init__.py``; host code, numpy).

* ``RecordFile`` — random access into a RecordIO file through ``mmap``:
  one scan of the record headers at open, then each ``read(i)`` is a
  slice of the mapping.
* ``assemble_batch`` — uint8 HWC images -> float32 NCHW batch with
  crop, mirror, mean and std, in the operand order of the JAX package's
  numpy path: crop, cast, mirror, ``- mean``, ``/ std``, transpose.

The JAX package also builds a native C++ reader and an OpenMP assembly
(``runtime/recordio.cpp``); the port has only this path so far.
"""
from __future__ import annotations

import mmap
import struct

import numpy as onp

__all__ = ["RecordFile", "assemble_batch"]

_MAGIC = 0xced7230a
_LMASK = 0x1fffffff


class RecordFile(object):
    """mmap'd random-access RecordIO reader: ``len(rf)`` records,
    ``rf.read(i)`` the payload bytes of record ``i``."""

    def __init__(self, path):
        self.path = path
        self._file = open(path, "rb")
        size = self._file.seek(0, 2)
        self._map = mmap.mmap(self._file.fileno(), 0,
                              access=mmap.ACCESS_READ) if size else b""
        self._offsets = self._scan(self._map)

    @staticmethod
    def _scan(data):
        """(payload offset, length) of every record, up to the first word
        that is not the magic."""
        offsets = []
        pos = 0
        while pos + 8 <= len(data):
            magic, lrec = struct.unpack_from("<II", data, pos)
            if magic != _MAGIC:
                break
            length = lrec & _LMASK
            offsets.append((pos + 8, length))
            pos += 8 + ((length + 3) & ~3)
        return offsets

    def __len__(self):
        return len(self._offsets)

    def read(self, i):
        """Record payload bytes at index i."""
        off, length = self._offsets[i]
        return self._map[off:off + length]

    def close(self):
        if self._file is not None:
            if isinstance(self._map, mmap.mmap):
                self._map.close()
            self._file.close()
            self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def assemble_batch(images, mean=None, std=None, mirror=None, crop_yx=None,
                   out_hw=None, out=None):
    """uint8 (n, h, w, c) HWC images -> float32 (n, c, oh, ow) NCHW batch.

    ``crop_yx`` (rows, cols) gives each image's crop origin (default 0, 0),
    ``mirror`` a per-image flip flag; ``out`` lets the caller supply the
    float32 staging buffer."""
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
    mean = None if mean is None else onp.asarray(mean, onp.float32)
    std = None if std is None else onp.asarray(std, onp.float32)
    for i in range(n):
        cy = int(crop_yx[0][i]) if crop_yx is not None else 0
        cx = int(crop_yx[1][i]) if crop_yx is not None else 0
        patch = images[i, cy:cy + oh, cx:cx + ow].astype(onp.float32)
        if mirror is not None and mirror[i]:
            patch = patch[:, ::-1]
        if mean is not None:
            patch = patch - mean
        if std is not None:
            patch = patch / std
        out[i] = patch.transpose(2, 0, 1)
    return out
