"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA H100.

Same ``import … as mx`` surface as ``mxnet_tpu`` for the slices ported so
far (``mx.nd``, ``mx.sym``, ``mx.mod``, ``mx.init``, ``mx.optimizer``,
``mx.lr_scheduler``, ``mx.io``, ``mx.metric``, ``mx.callback``, ``mx.rtc``,
``mx.models``, ``mx.checkpoint``, ``mx.monitor``, ``mx.telemetry``,
``mx.serving``, ``mx.rnn``, ``mx.precision``, ``mx.recordio``,
``mx.image``, ``mx.data``, ``mx.autograd``, ``mx.operator``, ``mx.kv``/
``mx.kvstore``, ``mx.model.FeedForward``, ``mx.viz``, ``mx.plugin``,
``mx.faults``, ``mx.guardian``, ``mx.engine``, ``mx.profiler``,
``mx.dist``, ``mx.parallel``, ``mx.runtime``, ``mx.torch`` (the torch
bridge, ``torch_bridge.py``) and ``mx.test_utils``, with ``mx.waitall``, ``mx.cpu_pinned``,
``mx.AttrScope`` and ``mx.NameManager``). It
imports torch and numpy, never JAX and
nothing of ``mxnet_tpu``. Entry points run on ``gpu(0)`` unless the caller
passes ``mx.cpu()``.
"""
from .base import MXNetError, __version__
from .context import Context, cpu, gpu, tpu, cpu_pinned, current_context
from . import engine
from . import random
from . import faults
from . import ndarray
from . import ndarray as nd
from . import autograd
from . import symbol
from . import symbol as sym
from . import initializer
from . import initializer as init
from . import optimizer
from . import optimizer as opt
from . import lr_scheduler
from . import io
from . import recordio
from . import image
from . import data
from . import metric
from . import callback
from . import rtc
from . import kvstore
from . import kvstore as kv
from . import model
from . import module
from . import module as mod
from . import models
from . import convert
from . import checkpoint
from . import guardian
from . import monitor
from . import monitor as mon
from . import telemetry
from . import serving
from . import rnn
from . import precision
from . import operator
from . import runtime
# ``mx.torch`` as in the JAX package; this module uses no name ``torch``
from . import torch_bridge as torch  # noqa: F401
from . import plugin
from . import visualization
from . import visualization as viz
from . import test_utils
from . import profiler
from . import dist
from . import parallel
from . import autopilot
from . import gateway
from . import attribute
from . import name
from .attribute import AttrScope
from .name import NameManager
from .model import FeedForward
from .ndarray import waitall

__all__ = ["MXNetError", "__version__", "Context", "cpu", "gpu", "tpu",
           "current_context", "random", "nd", "sym", "init",
           "optimizer", "lr_scheduler", "io", "metric", "callback", "rtc",
           "model", "mod", "models", "convert", "checkpoint", "monitor",
           "mon", "telemetry", "serving", "rnn", "precision", "recordio",
           "image", "data", "autograd", "operator", "kv", "kvstore", "opt",
           "viz", "visualization", "test_utils", "FeedForward", "plugin",
           "faults", "guardian", "engine", "profiler", "waitall", "dist",
           "parallel", "autopilot", "gateway", "runtime", "torch",
           "cpu_pinned", "AttrScope", "NameManager", "attribute", "name"]
