"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA H100.

Same ``import … as mx`` surface as ``mxnet_tpu`` for the slices ported so
far (``mx.nd``, ``mx.sym``, ``mx.mod``, ``mx.init``, ``mx.optimizer``,
``mx.io``, ``mx.models``). It imports torch and numpy, never JAX and
nothing of ``mxnet_tpu``. Entry points run on ``gpu(0)`` unless the caller
passes ``mx.cpu()``.
"""
from .base import MXNetError, __version__
from .context import Context, cpu, gpu, tpu, current_context
from . import random
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import initializer
from . import initializer as init
from . import optimizer
from . import io
from . import model
from . import module
from . import module as mod
from . import models
from . import convert

__all__ = ["MXNetError", "__version__", "Context", "cpu", "gpu", "tpu",
           "current_context", "random", "nd", "sym", "init",
           "optimizer", "io", "model", "mod", "models", "convert"]
