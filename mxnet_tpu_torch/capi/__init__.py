"""Build of the port's C library (``c_api.cpp`` here, which embeds CPython
and fronts ``mxnet_tpu_torch.capi_bridge``) and of C clients against it.

``build_library()`` compiles ``c_api.cpp`` against the repo's ABI header
``include/mxnet_tpu/c_api.h`` into ``<cache>/capi_torch/libmxnet_tpu.so``
(``<cache>``: ``kernels.build.cache_root()``, else the checkout's
git-ignored ``build/``): the JAX package's soname in a directory of its
own, so a client links to either with ``-lmxnet_tpu`` unchanged. It
rebuilds only when the source, the header or the flags change (a stamp
beside the library holds their digest). The interpreter it embeds is the
one running this build (``sysconfig``'s include and library directories).

``build_client(src, exe)`` compiles a C or C++ client and links it to the
library; ``client_env()`` is the environment a client runs in (the
package found through ``MXNET_TPU_HOME``, the running interpreter's
``sys.path`` on ``PYTHONPATH``). A client initialises CUDA through the
embedded interpreter, so run it in a process of its own.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading

from ..base import MXNetError
from ..kernels.build import cache_root

__all__ = ["build_library", "build_client", "client_env", "library_dir",
           "REPO_ROOT"]

_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_DIR))
_HEADER = os.path.join(REPO_ROOT, "include", "mxnet_tpu", "c_api.h")
_LOCK = threading.Lock()


def library_dir():
    """The directory of the port's ``libmxnet_tpu.so``."""
    root = cache_root()
    return os.path.join(root, "capi_torch") if root else \
        os.path.join(REPO_ROOT, "build", "capi_torch")


def _python_flags():
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise MXNetError("the C API embeds CPython and needs its headers: "
                         "no Python.h under %s" % inc)
    return (["-I" + inc], ["-L" + libdir, "-lpython" + ver,
                           "-Wl,-rpath," + libdir, "-ldl", "-lm"])


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise MXNetError("build failed: %s\n%s" % (" ".join(cmd),
                                                   res.stderr[-4000:]))


def build_library():
    """Path of the port's ``libmxnet_tpu.so``, built if it is missing or
    stale."""
    inc, ld = _python_flags()
    src = os.path.join(_DIR, "c_api.cpp")
    cmd_flags = ["-O2", "-std=c++14", "-shared", "-fPIC", "-pthread"] + inc
    h = hashlib.sha256()
    for path in (src, _HEADER):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(repr((cmd_flags, ld)).encode())
    out_dir = library_dir()
    so = os.path.join(out_dir, "libmxnet_tpu.so")
    stamp = so + ".sha256"
    with _LOCK:
        if os.path.exists(so) and os.path.exists(stamp) and \
                open(stamp).read() == h.hexdigest():
            return so
        os.makedirs(out_dir, exist_ok=True)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        _run(["g++"] + cmd_flags + [src, "-o", tmp] + ld)
        os.replace(tmp, so)
        with open(stamp + ".tmp", "w") as f:
            f.write(h.hexdigest())
        os.replace(stamp + ".tmp", stamp)
    return so


def build_client(src, exe, extra_includes=()):
    """Compile the C (``.c``) or C++ client ``src`` into ``exe``, linked
    to the port's library with ``-lmxnet_tpu``; returns ``exe``."""
    so = build_library()
    lib = os.path.dirname(so)
    cpp = not str(src).endswith(".c")
    cmd = (["g++", "-O1", "-std=c++14"] if cpp else ["gcc", "-O1"]) + [
        str(src), "-I", os.path.join(REPO_ROOT, "include")]
    for d in extra_includes:
        cmd += ["-I", d]
    cmd += ["-o", str(exe), "-L", lib, "-lmxnet_tpu", "-Wl,-rpath," + lib]
    _run(cmd)
    return str(exe)


def client_env(env=None):
    """The environment a client of the library runs in."""
    env = dict(os.environ if env is None else env)
    env["MXNET_TPU_HOME"] = REPO_ROOT
    paths = [REPO_ROOT] + [p for p in sys.path if p and os.path.isdir(p)]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env
