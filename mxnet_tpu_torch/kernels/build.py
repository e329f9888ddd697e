"""Build of the port's CUDA C++ sources (``kernels/csrc/*.cu``).

Each source has a plain C interface and includes no PyTorch header, so
``nvcc`` compiles it alone in seconds. ``torch.utils.cpp_extension.load``
builds it for ``sm_90a`` at first use into ``build/cuda/<name>`` inside
the checkout (git-ignored; one directory per library, so two libraries
can build at once), and the library is opened with ``ctypes``. It needs
``ninja``. A failed build raises ``MXNetError``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

from ..base import MXNetError

__all__ = ["cuda_library"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def cuda_library(name, source):
    """Build ``csrc/<source>`` into the shared library ``name`` (no-op when
    it is up to date) and return it loaded."""
    from torch.utils import cpp_extension
    try:
        cpp_extension.verify_ninja_availability()
    except RuntimeError as e:
        raise MXNetError("%s: building the CUDA kernels needs ninja, which "
                         "was not found (%s)" % (name, e))
    build = os.path.join(_REPO_ROOT, "build", "cuda", name)
    os.makedirs(build, exist_ok=True)
    try:
        path = cpp_extension.load(
            name=name, sources=[os.path.join(_CSRC, source)],
            build_directory=build,
            extra_cuda_cflags=["-O3",
                               "-gencode=arch=compute_90a,code=sm_90a"],
            is_python_module=False, verbose=False)
        return ctypes.CDLL(path)
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        raise MXNetError("%s: building %s failed (%s)" % (name, source, e))
