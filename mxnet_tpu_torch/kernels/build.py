"""Build of the port's CUDA C++ sources with ``nvcc``.

Every source has a plain C interface and includes no PyTorch header, so
``nvcc`` compiles it alone in seconds into a shared library for
``sm_90a``, which is opened with ``ctypes``. Two kinds of source:

* the files of ``kernels/csrc`` (``cuda_library``), built at first use
  into ``build/cuda/<name>/`` inside the checkout (git-ignored);
* a source generated at run time (``nvcc_library``: the rtc bodies,
  ``kernels/rtc.py``), built where its caller says (``rtc.rtc_dir``:
  ``build/rtc/<tag>/``).

This is the port's process-wide compile cache, the counterpart of JAX's
persistent compilation cache: ``MXNET_COMPILE_CACHE_DIR=<dir>`` (read at
each build) or :func:`set_cache_root` (``serving.cache.
enable_persistent_compile_cache``) moves both kinds under ``<dir>/cuda/``
(``<dir>/cuda/<name>/`` and ``<dir>/cuda/rtc/<tag>/``), so every process
pointed at one directory shares the libraries, and a process that finds
them there runs no ``nvcc`` at all. ``builds`` counts this process's
``nvcc`` runs; :func:`library_path` says where a csrc library goes
without building it.

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
import threading

import torch

from ..base import MXNetError

__all__ = ["cuda_library", "nvcc_library", "digest", "current_stream",
           "raise_if", "library_path", "cache_root",
           "set_cache_root", "CSRC", "FLAGS"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
HEADERS = ("stream.cuh", "device.cuh")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared")

_LOCK = threading.Lock()
_ROOT = [None]     # set_cache_root's directory (None: the environment's)
builds = 0         # nvcc runs of this process


def set_cache_root(cache_dir):
    """Build every library under ``<cache_dir>/cuda/`` from now on (None
    goes back to ``MXNET_COMPILE_CACHE_DIR``, else the checkout's
    ``build/``)."""
    _ROOT[0] = None if cache_dir is None else \
        os.path.abspath(str(cache_dir))


def cache_root():
    """The compile cache directory in force (``set_cache_root``'s, else
    ``MXNET_COMPILE_CACHE_DIR``), or None for the checkout's ``build/``."""
    return _ROOT[0] or os.environ.get("MXNET_COMPILE_CACHE_DIR") or None


def library_path(name, tag):
    """Where ``cuda_library`` keeps csrc library ``name`` built from
    inputs of digest ``tag``."""
    root = cache_root()
    base = os.path.join(root, "cuda") if root else \
        os.path.join(_REPO_ROOT, "build", "cuda")
    return os.path.join(base, name, "lib%s-%s.so" % (name, tag))


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
    global builds
    if not os.path.exists(lib_path):
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = "%s.%d.tmp" % (lib_path, os.getpid())
        cmd = [_nvcc(), *FLAGS, *flags, "-I", CSRC, "-o", tmp, source]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise MXNetError("nvcc could not be run (%s): building %s needs "
                             "the CUDA toolkit" % (e, source))
        with _LOCK:
            builds += 1
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
    """Build ``csrc/<source>`` into ``library_path(name, tag)`` (no-op
    when a library of the same inputs is there) and return it loaded."""
    path = os.path.join(CSRC, source)
    with open(path) as f:
        tag = digest(f.read())[:16]
    return nvcc_library(path, library_path(name, tag))


def current_stream(device):
    """PyTorch's current stream on ``device``, as the raw pointer."""
    return torch._C._cuda_getCurrentRawStream(device)


def raise_if(err, name):
    """Raise ``MXNetError`` for a C entry's nonzero cudaError_t."""
    if err:
        raise MXNetError("%s: kernel launch failed with CUDA error %d"
                         % (name, err))
