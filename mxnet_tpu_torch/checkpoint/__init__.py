"""mxnet_tpu_torch.checkpoint: durable training state (PyTorch
counterpart of ``mxnet_tpu/checkpoint``).

* :class:`CheckpointManager`: a directory of step-numbered entries, each
  committed atomically (temp dir + fsync + rename), saved async on the
  manager's worker thread and garbage-collected by ``keep``/``keep_every``.
* :mod:`.serialize`: atomic file writes, crc32-verified array files,
  host snapshots, the RNG file and ``params_digest``.
* the legacy ``arg:``/``aux:`` flat parameter file (``prefix-%04d.params``)
  shared by ``model.save_checkpoint``, ``Module.save_checkpoint`` and
  ``BaseModule.save_params``, written atomically by ``ndarray.save``.

Entries and files use the JAX package's layout, so either package
restores the other's parameters.
"""
from __future__ import annotations

from ..base import MXNetError
from .manager import Checkpoint, CheckpointManager
from .serialize import params_digest
from . import serialize

__all__ = ["Checkpoint", "CheckpointManager", "serialize",
           "pack_params", "split_params", "save_params_file",
           "load_params_file", "params_digest"]


def pack_params(arg_params, aux_params):
    """Flatten (arg_params, aux_params) into one ``arg:``/``aux:``
    prefixed dict — the name-packing every checkpoint format shares."""
    packed = {("arg:%s" % k): v for k, v in (arg_params or {}).items()}
    packed.update({("aux:%s" % k): v
                   for k, v in (aux_params or {}).items()})
    return packed


def split_params(packed):
    """Inverse of :func:`pack_params`; unknown prefixes raise."""
    arg_params, aux_params = {}, {}
    for k, v in packed.items():
        kind, _, name = k.partition(":")
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid checkpoint param key %r "
                             "(want arg:/aux: prefix)" % (k,))
    return arg_params, aux_params


def save_params_file(fname, arg_params, aux_params):
    """Write the legacy flat ``.params`` file (atomically)."""
    from .. import ndarray as nd
    nd.save(fname, pack_params(arg_params, aux_params))


def load_params_file(fname, ctx=None):
    """Load a legacy flat ``.params`` file -> (arg_params, aux_params),
    arrays on ``ctx`` (default: the current context)."""
    from .. import ndarray as nd
    return split_params(nd.load(fname, ctx=ctx))
