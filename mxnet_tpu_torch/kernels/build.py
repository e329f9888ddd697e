"""Build of the port's CUDA C++ sources with ``nvcc``.

Every source has a plain C interface and includes no PyTorch header, so
``nvcc`` compiles it alone in seconds into a shared library for
``sm_90a``, which is opened with ``ctypes``. Two kinds of source:

* the files of ``kernels/csrc`` (``cuda_library``), built at first use
  into ``build/cuda/<name>/`` inside the checkout (git-ignored);
* a source generated at run time (``nvcc_library``: the rtc bodies,
  ``kernels/rtc.py``), built where its caller says.

Every C entry takes the device and PyTorch's current stream on it
(``current_stream``) and returns a cudaError_t, which ``raise_if`` turns
into ``MXNetError``.

A library's file name carries the sha256 of what it was built from (the
source, the engine header it may include, the flags), so a library on
disk is reused only for the same inputs, by any process. The library is
written under a name of the building process and renamed into place, so
two processes never load a half-written file. A failed build raises
``MXNetError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from ..base import MXNetError

__all__ = ["cuda_library", "nvcc_library", "digest", "current_stream",
           "raise_if", "CSRC", "FLAGS"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
HEADERS = ("stream.cuh", "device.cuh")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared")


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def digest(text, flags=()):
    """sha256 (hex) of a source's text, the engine headers and the
    flags: what a library built from them depends on."""
    h = hashlib.sha256(text.encode())
    for name in HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(repr(tuple(FLAGS) + tuple(flags)).encode())
    return h.hexdigest()


def nvcc_library(source, lib_path, flags=()):
    """Compile the CUDA file ``source`` into the shared library
    ``lib_path`` unless that file exists, and return it loaded."""
    if not os.path.exists(lib_path):
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = "%s.%d.tmp" % (lib_path, os.getpid())
        cmd = [_nvcc(), *FLAGS, *flags, "-I", CSRC, "-o", tmp, source]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise MXNetError("nvcc could not be run (%s): building %s needs "
                             "the CUDA toolkit" % (e, source))
        if res.returncode:
            raise MXNetError("building %s failed (nvcc exit %d):\n%s"
                             % (source, res.returncode,
                                (res.stderr or res.stdout)[-4000:]))
        os.replace(tmp, lib_path)
    try:
        return ctypes.CDLL(lib_path)
    except OSError as e:
        raise MXNetError("loading %s failed (%s)" % (lib_path, e))


def cuda_library(name, source):
    """Build ``csrc/<source>`` into ``build/cuda/<name>/`` (no-op when a
    library of the same inputs is there) and return it loaded."""
    path = os.path.join(CSRC, source)
    with open(path) as f:
        tag = digest(f.read())[:16]
    lib_path = os.path.join(_REPO_ROOT, "build", "cuda", name,
                            "lib%s-%s.so" % (name, tag))
    return nvcc_library(path, lib_path)


def current_stream(device):
    """PyTorch's current stream on ``device``, as the raw pointer."""
    return torch._C._cuda_getCurrentRawStream(device)


def raise_if(err, name):
    """Raise ``MXNetError`` for a C entry's nonzero cudaError_t."""
    if err:
        raise MXNetError("%s: kernel launch failed with CUDA error %d"
                         % (name, err))
