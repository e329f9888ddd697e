"""Build and load of the native host runtime's C++ sources with ``g++``.

Each source of this directory (``recordio.cpp``, ``engine_core.cpp``) is
compiled into the port's build cache, never into the package:
``<cache>/native/<name>/lib<name>-<digest>.so``, where ``<cache>`` is
``kernels.build.cache_root()`` (``MXNET_COMPILE_CACHE_DIR`` or
``set_cache_root``'s directory) or else the checkout's git-ignored
``build/``. The digest covers the source's text, the flags and what
``-march=native`` means on this host (the options ``g++`` expands it
to), so a cache carried to a host with another CPU builds anew instead
of loading code that host cannot run. The library is written under a
name of the building process and renamed into place, so no process
loads a half-written file. Without ``g++``, or when a build fails, the
loader returns None and the caller takes its numpy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..kernels.build import cache_root

__all__ = ["load_native", "native_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_DIR))
_BASE_FLAGS = ("-O3", "-std=c++14", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_HOST = []          # [the host's -march=native expansion], once a process


def _host_target():
    """What ``-march=native`` expands to on this host ("" without g++)."""
    with _LOCK:
        if not _HOST:
            try:
                res = subprocess.run(
                    ["g++", "-march=native", "-E", "-v", "-x", "c++",
                     os.devnull], capture_output=True, text=True,
                    timeout=60)
                lines = [ln for ln in res.stderr.splitlines()
                         if "cc1plus" in ln]
                _HOST.append(" ".join(
                    t for t in (lines[0].split() if lines else [])
                    if t.startswith(("-march", "-mtune", "-m", "--param"))))
            except (OSError, subprocess.SubprocessError):
                _HOST.append("")
        return _HOST[0]


def native_path(src_name, flags=()):
    """Where the library of ``src_name`` built with ``flags`` lives."""
    with open(os.path.join(_DIR, src_name), "rb") as f:
        text = f.read()
    h = hashlib.sha256(text)
    h.update(repr((_BASE_FLAGS, tuple(flags))).encode())
    if "-march=native" in flags:
        h.update(_host_target().encode())
    name = os.path.splitext(src_name)[0]
    root = cache_root()
    base = os.path.join(root, "native") if root else \
        os.path.join(_REPO_ROOT, "build", "native")
    return os.path.join(base, name,
                        "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def load_native(src_name, flags=()):
    """A ``ctypes.CDLL`` of this directory's ``src_name``, built at first
    use; None where it cannot be built or loaded."""
    try:
        so = native_path(src_name, flags)
    except OSError:
        return None
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        cmd = ["g++", *_BASE_FLAGS, *flags, os.path.join(_DIR, src_name),
               "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None
